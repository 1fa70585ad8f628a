"""RVB (resonating-valence-bond) updates — reference
``src/sse/qmc_traits/rvb.rs`` (the largest algorithm in the crate).

Semantics (mirroring the reference):

1. **Cluster sampling** (``build_cluster``, ``rvb.rs:1054-1123``): cluster
   *elements* are imaginary-time segments of single-variable worldlines
   bounded by consecutive constant (transverse-field) ops, or whole
   worldlines for variables with no constant ops. Starting from a uniformly
   chosen seed element, elements are popped from a weighted boundary set
   (weights: 1 for same-variable neighbors, the bond magnitude for
   lattice-neighbor segments overlapping in imaginary time); the number of
   pops is geometric (``contiguous_bits``, ``rvb.rs:1190-1192``).
2. **Acceptance** (``calculate_flip_prob``, ``rvb.rs:649-946``): sweep
   imaginary time tracking the propagated state and the in-cluster mask
   (toggled at the cluster-bounding constant ops). Every diagonal lattice op
   on a *boundary bond* (exactly one endpoint in the cluster) contributes a
   factor ``W_after_tot / W_before_tot`` — the total weight of all boundary
   bonds evaluated in the flipped vs. current state — because on acceptance
   such ops are *rotated* to a random boundary bond. Ops entirely inside the
   cluster contribute their Ising flip ratio (0 for longitudinal field ops,
   ``qmc_ising.rs:713-725``).
3. **Mutation** (``mutate_graph``, ``rvb.rs:294-615``): rotate each
   boundary-bond diagonal op to a random boundary bond sampled by weight,
   toggle the in/out legs of the cluster-bounding constant ops (turning them
   off-diagonal), flip interior ops symmetrically, and XOR the p=0 state with
   the cluster mask where the cluster includes p=0.

Batched form: everything is batched over replicas. The reference's
heap-merged sparse sweep becomes a dense ``lax.scan`` over all imaginary-time
slots; the boundary-weight totals the reference maintains incrementally are
recomputed at each slot as an O(NE) vectorized reduction over the static
edge list from the carried ``(substate, in-cluster)`` masks — identical
values, far fewer per-step ops, and the work vectorizes across replicas
(the heap only skips work; the dense scan does the same update at every
slot, masked). The weighted BFS becomes a Gumbel-categorical pop loop over a
fixed element space of size M + N. The subsection machinery
(``diagonal_subsection.rs``) the reference needs to touch only O(cluster)
worldline is subsumed: the dense scan touches every slot anyway, amortized
across the replica batch.

Deviation: the geometric cluster size is capped at ``MAX_POPS`` = 16 pops
(the reference caps ``contiguous_bits`` at 64); P(size > 16) < 1e-4 and the
truncation only changes the proposal distribution, not correctness.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from isingmontecarlo_tpu.sse.model import BondModel
from isingmontecarlo_tpu.sse.tables import bond_fetch
from isingmontecarlo_tpu.sse.opstring import OpString, substate_index

_BIG = jnp.int32(2**30)
_TINY = 1e-30
MAX_POPS = 16


def contiguous_bits(key: jax.Array, shape=()) -> jax.Array:
    """Sample ``n`` with probability ``2^-(n+1)`` — the reference's
    trailing-ones draw sizing RVB spacetime clusters (``contiguous_bits``,
    ``rvb.rs:1190-1192``). Capped at 64 like a ``u64`` draw."""
    u = jax.random.uniform(key, shape, minval=1e-19, maxval=1.0)
    return jnp.clip(jnp.floor(-jnp.log2(u)).astype(jnp.int32), 0, 64)

# Element-count gate for the vectorized acceptance+mutation path: it
# materializes [M, R, NE] f32 and [M, R, K, N] one-hot tensors, so cap the
# footprint (elements of the largest tensor); beyond it the chunked
# vectorized path runs at this footprint per chunk (see _fused_chunked).
_VEC_MAX_ELEMS = 1 << 26

# Test hook: force the vectorized path on (True) or off (False); None = auto
# (by footprint).
_FORCE_VEC = None


@jax.tree_util.register_pytree_node_class
class RvbTables:
    """Static lattice-adjacency tables over the 2-site (edge) bonds — the
    ``EdgeNavigator`` capability (``rvb.rs:10-32``) in dense padded form.
    ``nedges`` is static aux data (it shapes the boundary-weight vector)."""

    def __init__(self, neigh_bond, neigh_var, bond_mag, nedges):
        self.neigh_bond = neigh_bond  # i32[N, D] edge-bond ids per var, -1 pad
        self.neigh_var = neigh_var  # i32[N, D] the other var of that bond
        self.bond_mag = bond_mag  # f32[NE] max matrix element per edge bond
        self.nedges = nedges  # static

    def tree_flatten(self):
        return (self.neigh_bond, self.neigh_var, self.bond_mag), (self.nedges,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children, aux[0])


def make_rvb_tables(edges, model: BondModel) -> RvbTables:
    """Build adjacency over the lattice edges (bonds ``[0, NE)`` in the TFIM
    layout, ``qmc_ising.rs:186-205``)."""
    nvars = model.nvars
    ne = len(edges)
    lists: list[list[tuple[int, int]]] = [[] for _ in range(nvars)]
    for b, ((va, vb), _) in enumerate(edges):
        lists[va].append((b, vb))
        lists[vb].append((b, va))
    deg = max(1, max((len(l) for l in lists), default=0))
    nb = np.full((nvars, deg), -1, np.int32)
    nv = np.full((nvars, deg), -1, np.int32)
    for v, l in enumerate(lists):
        for d, (b, ov) in enumerate(l):
            nb[v, d] = b
            nv[v, d] = ov
    mag = np.asarray(jnp.max(model.diag_w[:ne], axis=1))
    return RvbTables(
        neigh_bond=jnp.asarray(nb),
        neigh_var=jnp.asarray(nv),
        bond_mag=jnp.asarray(mag),
        nedges=ne,
    )


def _take0(arr, idx):
    return jnp.take_along_axis(arr, idx, axis=0)


def _const_inventory(ops: OpString, model: BondModel):
    """Sorted constant-op inventory per replica.

    Returns ``(cvar, cpos, cnext, valid, ncount, has_const)``:
    ``cvar/cpos: i32[M, R]`` constant ops sorted by (var, p) (pad: var=N,
    pos=0); ``cnext: i32[M, R]`` sorted index of the cyclically-next constant
    op on the same var; ``valid: bool[M, R]``; ``ncount: i32[R]`` total
    constant ops; ``has_const: bool[R, N]``.

    Mirrors ``find_constants`` (``rvb.rs:1160-1187``) as one sort.
    """
    M, R = ops.bond.shape
    b = jnp.maximum(ops.bond, 0)
    occupied = ops.bond >= 0
    is_const = (
        bond_fetch(model.is_constant.astype(jnp.int32), b) == 1
    ) & occupied  # [M, R]
    # [M, R]; constant ops are single-var
    var0 = bond_fetch(jnp.maximum(model.bond_vars[:, 0], 0), b)
    p_idx = jnp.arange(M, dtype=jnp.int32)[:, None]

    key = jnp.where(is_const, var0 * M + p_idx, _BIG)
    # Value sort only — the permutation is never needed.
    skey = jax.lax.sort(key, dimension=0)
    valid = skey < _BIG
    cvar = jnp.where(valid, skey // M, model.nvars)
    cpos = jnp.where(valid, skey % M, 0)

    j = jnp.arange(M, dtype=jnp.int32)[:, None]
    seg_start = jnp.concatenate(
        [jnp.ones((1, R), bool), cvar[1:] != cvar[:-1]], axis=0
    )
    group_start = jax.lax.cummax(jnp.where(seg_start, j, 0), axis=0)
    nxt_same = jnp.concatenate([cvar[1:] == cvar[:-1], jnp.zeros((1, R), bool)], 0)
    cnext = jnp.where(nxt_same, jnp.minimum(j + 1, M - 1), group_start)
    cnext = jnp.where(valid, cnext, j)

    ncount = jnp.sum(valid, axis=0).astype(jnp.int32)
    # has_const: vars with >= 1 constant op == the distinct cvar values, i.e.
    # the var-group heads of the (already sorted) cvar column. Sort-compact
    # the <= min(N, M) head rows and scatter only those, not the full
    # [M, R] grid.
    Tc = min(model.nvars, M)
    head_v = jax.lax.sort(
        jnp.where(seg_start & valid, cvar, _BIG), dimension=0
    )[:Tc]
    cols_c = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32)[None, :], (Tc, R))
    has_const = (
        jnp.zeros((R, model.nvars), bool)
        .at[cols_c, head_v].set(True, mode="drop")
    )
    return cvar, cpos, cnext, valid, ncount, has_const


def _seg_bounds(cpos, cnext):
    """Segment (start, length) per sorted element; length 0 means the full
    circle (single constant op on the var)."""
    M = cpos.shape[0]
    s = cpos
    e = _take0(cpos, cnext)
    ln = (e - s) % M  # 0 == full circle
    return s, ln


def _cyc_overlap(s1, ln1, s2, ln2, M):
    """Cyclic half-open interval overlap; length 0 == full period."""
    full1 = ln1 == 0
    full2 = ln2 == 0
    o = (((s2 - s1) % M) < ln1) | (((s1 - s2) % M) < ln2)
    return o | full1 | full2


def _build_cluster(key, ops, model, tables: RvbTables, cvar, cpos, cnext, valid,
                   ncount, has_const):
    """Weighted cluster growth (``build_cluster``, ``rvb.rs:1054-1123``).

    Element space per replica: ``[0, M)`` = sorted constant-op segments,
    ``[M, M+N)`` = whole worldlines of vars with no constant ops. Returns
    ``popped: bool[R, M+N]``.
    """
    M, R = ops.bond.shape
    N = model.nvars
    D = tables.neigh_bond.shape[1]
    rows = jnp.arange(R)

    seg_s, seg_ln = _seg_bounds(cpos, cnext)  # [M, R]

    # -- seed: uniform over (constant ops) + (zero-op vars)  (rvb.rs:117-135)
    k_seed, k_size, k_pops = jax.random.split(key, 3)
    nzero = N - jnp.sum(has_const, axis=1).astype(jnp.int32)  # [R]
    total = ncount + nzero
    pick = jnp.minimum(
        (jax.random.uniform(k_seed, (R,)) * total).astype(jnp.int32), total - 1
    )
    # zero-op var with cumulative index pick - ncount:
    zcum = jnp.cumsum((~has_const).astype(jnp.int32), axis=1)  # [R, N]
    want = (pick - ncount + 1)[:, None]
    zvar = jnp.argmax(zcum >= want, axis=1).astype(jnp.int32)  # [R]
    seed_elem = jnp.where(pick < ncount, pick, M + zvar)

    # Geometric pop count: k pops w.p. 2^-k (contiguous_bits + 1).
    u = jax.random.uniform(k_size, (R,), minval=1e-9, maxval=1.0)
    n_pops = jnp.clip(
        1 + jnp.floor(-jnp.log2(u)).astype(jnp.int32), 1, MAX_POPS
    )

    w0 = jnp.zeros((R, M + N), jnp.float32).at[rows, seed_elem].set(1.0)
    popped0 = jnp.zeros((R, M + N), bool)

    # Cyclic-previous within var groups: prev[cnext[i]] = i. cnext is a
    # permutation (cycles within var groups, self-maps on padding), so the
    # inverse is one sort keyed by it — payload i lands at row cnext[i] —
    # instead of an [M, R] scatter.
    src_mr = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32)[:, None], (M, R))
    _, cprev = jax.lax.sort((cnext, src_mr), dimension=0, num_keys=1)
    cprev = jnp.where(valid, cprev, src_mr)

    # Loop-invariant M-minor views for the per-iteration overlap pass (the
    # long axis minor).
    cvar_t = cvar.T  # [R, M]
    valid_t = valid.T
    seg_s_t = seg_s.T
    seg_ln_t = seg_ln.T

    def body(carry):
        w, popped, remaining, key = carry
        key, k_g = jax.random.split(key)
        total_w = jnp.sum(w, axis=1)
        active = (remaining > 0) & (total_w > 0)

        g = jax.random.gumbel(k_g, (R, M + N))
        score = jnp.where(w > 0, jnp.log(jnp.maximum(w, _TINY)) + g, -jnp.inf)
        elem = jnp.argmax(score, axis=1).astype(jnp.int32)  # [R]

        popped = popped.at[rows, jnp.where(active, elem, 0)].max(active)
        w = w * (~popped)  # popped elements leave the boundary

        is_flip = elem < M
        c = jnp.where(is_flip, elem, 0)
        v = jnp.where(is_flip, cvar[c, rows], elem - M)  # [R]
        v = jnp.minimum(v, N - 1)

        # Same-var neighbors (rvb.rs:1085-1092), weight 1.0 each.
        for nb_idx in (cnext[c, rows], cprev[c, rows]):
            tgt = jnp.where(is_flip & active, nb_idx, M + N - 1)
            add = (is_flip & active & ~popped[rows, tgt]).astype(jnp.float32)
            w = w.at[rows, tgt].add(jnp.where(is_flip & active, add, 0.0))

        # Popped segment bounds ([s, s+ln) cyclic; no-flip = full circle).
        ps = jnp.where(is_flip, seg_s[c, rows], 0)
        pln = jnp.where(is_flip, seg_ln[c, rows], 0)  # 0 == full

        # Lattice neighbors (rvb.rs:1095-1119), all D directions batched in
        # one block (the body runs inside a while_loop at small shapes, so
        # HLO count — not FLOPs — is the cost driver).
        ov = tables.neigh_var[v]  # [R, D]
        bm_bond = tables.neigh_bond[v]
        okd = (ov >= 0) & active[:, None]
        bm = tables.bond_mag[jnp.maximum(bm_bond, 0)]  # [R, D]
        ov_safe = jnp.where(okd, ov, N - 1)
        # no-constant-op neighbors: push their whole worldlines
        zmask = okd & ~has_const[rows[:, None], ov_safe]
        tgt = jnp.where(zmask, M + ov_safe, M + N - 1)  # [R, D]
        w = w.at[rows[:, None], tgt].add(
            jnp.where(zmask & ~popped[rows[:, None], tgt], bm, 0.0)
        )
        # overlapping segments of the neighbors, one direction at a time in
        # [R, M] (M-minor) layout: segment m belongs to direction d iff
        # cvar[m] == ov_safe[r, d], and directions of one var are distinct,
        # so at most one d contributes per element — the per-d adds are
        # exactly the old single fused add (x + 0.0 == x for the weights).
        ovl_t = _cyc_overlap(ps[:, None], pln[:, None], seg_s_t, seg_ln_t, M)
        add_t = valid_t & ovl_t & ~popped[:, :M]  # [R, M]
        wseg = w[:, :M]
        for d in range(D):
            cand = add_t & (cvar_t == ov_safe[:, d, None]) & okd[:, d, None]
            wseg = wseg + jnp.where(cand, bm[:, d, None], 0.0)
        w = w.at[:, :M].set(wseg)

        remaining = remaining - active.astype(jnp.int32)
        return w, popped, remaining, key

    def cond(carry):
        w, popped, remaining, _ = carry
        return jnp.any((remaining > 0) & (jnp.sum(w, axis=1) > 0))

    w, popped, _, _ = jax.lax.while_loop(
        cond, body, (w0, popped0, n_pops, k_pops)
    )
    return popped


def _cluster_masks(popped, ops, model, cvar, cpos, cnext, valid):
    """Derive ``in_cluster0: bool[R, N]`` (cluster membership at p=0) and
    ``is_toggle: bool[M, R]`` (slots whose constant op bounds the cluster)
    from the popped element set (``rvb.rs:175-196`` toggle bookkeeping with
    ``remove_doubles`` parity)."""
    M, R = ops.bond.shape
    N = model.nvars

    pf = popped[:, :M].T & valid  # [M, R] popped flip elements
    s = cpos
    e = _take0(cpos, cnext)

    # At most MAX_POPS elements are popped per replica (one per pop
    # iteration of _build_cluster), so the toggle/wrap contributors compact
    # into [MAX_POPS, R] via a sort — the parity scatters then touch 16-row
    # grids instead of [M, R] ones. Unpopped rows sort to _BIG and drop as
    # out-of-bounds.
    # Bit-identical: the dropped rows contributed 0 before.
    T = min(MAX_POPS, M)
    cols_p = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32)[None, :], (T, R))
    s_pop = jax.lax.sort(jnp.where(pf, s, _BIG), dimension=0)[:T]
    e_pop = jax.lax.sort(jnp.where(pf, e, _BIG), dimension=0)[:T]

    # Toggle parity at segment start and end positions.
    cnt = jnp.zeros((M, R), jnp.int32)
    cnt = cnt.at[s_pop, cols_p].add(1, mode="drop")
    cnt = cnt.at[e_pop, cols_p].add(1, mode="drop")
    is_toggle = (cnt % 2) == 1

    # p=0 membership: wrapping segments (e <= s) plus whole-worldline vars.
    w_pop = jax.lax.sort(
        jnp.where(pf & (e <= s), cvar, _BIG), dimension=0
    )[:T]
    icnt = jnp.zeros((R, N), jnp.int32).at[cols_p, w_pop].add(1, mode="drop")
    in0 = (icnt % 2) == 1
    in0 = in0 | popped[:, M:]
    return in0, is_toggle


def _cluster_cand_edges(popped, ops, model, tables, cvar, valid):
    """Candidate boundary edges of one update's cluster: ``i32[A, R]``
    global edge-bond ids (``tables.nedges`` = padding), ``A = MAX_POPS * D``.

    The cluster touches at most ``MAX_POPS`` variables (one per pop of
    :func:`_build_cluster`), so every edge that can ever be a boundary edge
    — one endpoint in the cluster — is incident to one of them. Restricting
    the fused acceptance+mutation pass to this candidate set drops its
    footprint from O(M·R·NE) to O(M·R·A) with ``A`` independent of lattice
    size — the batched analog of the reference's heap sweep visiting only ops
    adjacent to the cluster (``calculate_flip_prob``, ``rvb.rs:649-946``).
    Duplicate edges are masked to padding (they would double-count the
    boundary weight totals)."""
    M, R = ops.bond.shape
    N = model.nvars
    D = tables.neigh_bond.shape[1]
    P = min(MAX_POPS, M + N)
    pf = popped[:, :M].T & valid  # [M, R] popped segment elements
    v_seg = jax.lax.sort(jnp.where(pf, cvar, _BIG), dimension=0)[:P]
    v_wl = jax.lax.sort(
        jnp.where(
            popped[:, M:].T,
            jnp.arange(N, dtype=jnp.int32)[:, None],
            _BIG,
        ),
        dimension=0,
    )[:min(P, N)]
    # <= MAX_POPS elements are popped in total, so after one more sort all
    # real vars land in the first P rows.
    vs = jax.lax.sort(jnp.concatenate([v_seg, v_wl], axis=0), dimension=0)[:P]
    ok = vs < N
    cb = tables.neigh_bond[jnp.where(ok, vs, 0)]  # [P, R, D]
    cb = jnp.where(ok[..., None] & (cb >= 0), cb, tables.nedges)
    cand = jnp.moveaxis(cb, 2, 1).reshape(P * D, R)
    cand = jax.lax.sort(cand, dimension=0)
    dup = jnp.concatenate(
        [jnp.zeros((1, R), bool), cand[1:] == cand[:-1]], axis=0
    )
    return jnp.where(dup, tables.nedges, cand)


def _edge_weight(model, b_safe, sa, sb):
    """Diagonal weight of edge bond ``b`` given endpoint spins (bit0 = first
    leg)."""
    si = sa.astype(jnp.int32) + 2 * sb.astype(jnp.int32)
    return model.diag_w[b_safe, si]


def _acceptance_scan(ops, state, model, tables, in0, is_toggle):
    """``calculate_flip_prob`` (``rvb.rs:649-946``) as a dense scan.

    The reference carries incrementally-updated boundary-weight totals
    through a heap sweep; here each slot recomputes the totals directly from
    the carried ``(substate, incl)`` as an O(NE) vectorized reduction over
    the static edge list — identical values (the totals are pure functions
    of the carried state) with a far smaller per-step op graph than
    per-event incremental maintenance.

    Returns ``p_accept: f32[R]``.
    """
    M, R = ops.bond.shape
    K = ops.max_legs
    rows = jnp.arange(R)
    ne = tables.nedges
    va_e = model.bond_vars[:ne, 0]  # [NE] static
    vb_e = model.bond_vars[:ne, 1]
    e_ids = jnp.arange(ne, dtype=jnp.int32)[None, :]

    logm0 = jnp.zeros((R,), jnp.float32)

    def step(carry, xs):
        substate, incl, logm = carry
        bond_p, in_p, out_p, tog_p = xs  # [R], [K,R], [K,R], [R]
        occ = bond_p >= 0
        b = jnp.maximum(bond_p, 0)
        vars_p = jnp.moveaxis(model.bond_vars[b], -1, 0)  # [K, R]
        leg_ok = (vars_p >= 0) & occ[None]
        arity = jnp.sum(leg_ok, axis=0)
        is_diag_p = jnp.all(in_p == out_p, axis=0)

        va = jnp.maximum(vars_p[0], 0)
        vb = jnp.maximum(vars_p[1] if K > 1 else vars_p[0], 0)
        bdry = incl[rows, va] ^ incl[rows, vb]
        is_boundary_op = occ & is_diag_p & (arity == 2) & (b < ne) & bdry

        # Boundary diagonal lattice ops: weight-ratio factor (rvb.rs:845-852
        # accumulated, committed at rvb.rs:886-893), with totals evaluated in
        # the pre-event state of this slot.
        bdry_e = (incl[:, va_e] ^ incl[:, vb_e]).astype(jnp.float32)  # [R,NE]
        wb_tot = jnp.sum(
            bdry_e
            * _edge_weight(model, e_ids, substate[:, va_e], substate[:, vb_e]),
            axis=1,
        )
        flipped = substate ^ incl
        wa_tot = jnp.sum(
            bdry_e
            * _edge_weight(model, e_ids, flipped[:, va_e], flipped[:, vb_e]),
            axis=1,
        )
        # wa_tot == 0 means the rewrite has zero weight: acceptance must be
        # EXACTLY 0 (the reference's ratio product is 0), not exp(log _TINY),
        # or a u = 0.0 uniform draw could accept an invalid candidate.
        logm = logm + jnp.where(
            is_boundary_op,
            jnp.where(
                wa_tot > 0, jnp.log(jnp.maximum(wa_tot, _TINY)), -jnp.inf
            )
            - jnp.log(jnp.maximum(wb_tot, _TINY)),
            0.0,
        )

        # Completely-in-cluster Ising flip ratio (rvb.rs:873-879), with the
        # pre-toggle cluster state (mirrors the reference's evaluation order).
        in_leg = incl[rows[None, :], jnp.maximum(vars_p, 0)] | ~leg_ok
        completely_in = jnp.all(in_leg, axis=0) & occ & (arity > 0)
        legmask = jnp.where(
            jnp.arange(K, dtype=jnp.int32)[:, None] < arity[None, :], 1, 0
        )
        mask_bits = substate_index(legmask.astype(bool))
        si = substate_index(in_p)
        so = substate_index(out_p)
        if model.full_w is not None:
            w_cur = model.full_w[b, si, so]
            w_flip = model.full_w[b, si ^ mask_bits, so ^ mask_bits]
        else:
            w_cur = jnp.where(si == so, model.diag_w[b, si], 0.0)
            w_flip = jnp.where(si == so, model.diag_w[b, si ^ mask_bits], 0.0)
        ratio_ok = completely_in & ~is_boundary_op
        logm = logm + jnp.where(
            ratio_ok,
            jnp.where(
                w_flip > 0, jnp.log(jnp.maximum(w_flip, _TINY)), -jnp.inf
            )
            - jnp.log(jnp.maximum(w_cur, _TINY)),
            0.0,
        )

        # Events: cluster-bound toggle (constant op) and/or off-diagonal spin
        # flip.
        is_cb = tog_p & occ
        will_flip = occ & ~is_diag_p
        for l in range(K):
            u_var = jnp.maximum(vars_p[l], 0)
            ev_tog = is_cb & (l == 0)
            ev_flip = will_flip & leg_ok[l]
            ev = ev_tog | ev_flip
            new_in_u = jnp.where(ev_tog, ~incl[rows, u_var], incl[rows, u_var])
            incl = incl.at[rows, u_var].set(
                jnp.where(ev, new_in_u, incl[rows, u_var])
            )
            new_s_u = jnp.where(
                ev_flip, out_p[l], substate[rows, u_var]
            )
            substate = substate.at[rows, u_var].set(new_s_u)

        return (substate, incl, logm), None

    xs = (
        ops.bond,
        jnp.moveaxis(ops.inputs, 1, 0),
        jnp.moveaxis(ops.outputs, 1, 0),
        is_toggle,
    )
    (_, _, logm), _ = jax.lax.scan(
        step, (state, in0, logm0), xs, unroll=2
    )
    return jnp.minimum(jnp.exp(logm), 1.0)


def _mutation_scan(ops, state, model, tables, in0, is_toggle, accept, key):
    """``mutate_graph`` (``rvb.rs:294-615``) as a dense scan emitting the new
    op arrays; non-accepting replicas keep their originals."""
    M, R = ops.bond.shape
    K = ops.max_legs
    rows = jnp.arange(R)
    ne = tables.nedges

    substate0 = state ^ in0  # mutation tracks the flipped configuration
    va_e = model.bond_vars[:ne, 0]
    vb_e = model.bond_vars[:ne, 1]
    e_ids = jnp.arange(ne, dtype=jnp.int32)[None, :]

    def wvec_of(substate, incl):
        bdry = incl[:, va_e] ^ incl[:, vb_e]
        w = _edge_weight(model, e_ids, substate[:, va_e], substate[:, vb_e])
        return jnp.where(bdry, w, 0.0)  # [R, NE]

    # Rotation noise pre-drawn for all slots (counter-based RNG; avoids a
    # key split + generator call inside every scan step).
    gumbels = jax.random.gumbel(key, (M, R, ne))

    def step(carry, xs):
        substate, incl = carry
        bond_p, in_p, out_p, tog_p, g = xs
        occ = bond_p >= 0
        b = jnp.maximum(bond_p, 0)
        vars_p = jnp.moveaxis(model.bond_vars[b], -1, 0)  # [K, R]
        leg_ok = (vars_p >= 0) & occ[None]
        arity = jnp.sum(leg_ok, axis=0)
        is_diag_p = jnp.all(in_p == out_p, axis=0)

        va = jnp.maximum(vars_p[0], 0)
        vb = jnp.maximum(vars_p[1] if K > 1 else vars_p[0], 0)
        bdry = incl[rows, va] ^ incl[rows, vb]
        is_boundary_op = occ & is_diag_p & (arity == 2) & (b < ne) & bdry
        is_cb = tog_p & occ
        in_leg = incl[rows[None, :], jnp.maximum(vars_p, 0)] | ~leg_ok
        completely_in = jnp.all(in_leg, axis=0) & occ & (arity > 0)

        # --- boundary-bond rotation (rvb.rs:413-434): sample new bond by
        # weight via Gumbel-argmax over the boundary-weight vector, which is
        # recomputed from the carried state (see _acceptance_scan note).
        wvec = wvec_of(substate, incl)
        score = jnp.where(
            wvec > 0, jnp.log(jnp.maximum(wvec, _TINY)) + g, -jnp.inf
        )
        b_new = jnp.argmax(score, axis=1).astype(jnp.int32)
        rot_vars = jnp.stack([va_e[b_new], vb_e[b_new]])  # [2, R]
        rot_bits = jnp.stack(
            [substate[rows, rot_vars[0]], substate[rows, rot_vars[1]]]
        )  # [2, R]

        do_rot = is_boundary_op & accept
        new_bond = jnp.where(do_rot, b_new, bond_p)
        new_in = in_p
        new_out = out_p
        if K == 2:
            new_in = jnp.where(do_rot[None], rot_bits, new_in)
            new_out = jnp.where(do_rot[None], rot_bits, new_out)
        else:  # generic K: place the two legs, pad others False
            pad = jnp.zeros((K - 2, R), bool)
            rb = jnp.concatenate([rot_bits, pad], axis=0)
            new_in = jnp.where(do_rot[None], rb, new_in)
            new_out = jnp.where(do_rot[None], rb, new_out)

        # --- cluster-bound constant ops (rvb.rs:446-476): in ^= c,
        # out ^= !c with the pre-toggle cluster state.
        c_pre = incl[rows, va]
        do_cb = is_cb & accept & ~do_rot
        cb_in = in_p[0] ^ c_pre
        cb_out = out_p[0] ^ (~c_pre)
        new_in = new_in.at[0].set(jnp.where(do_cb, cb_in, new_in[0]))
        new_out = new_out.at[0].set(jnp.where(do_cb, cb_out, new_out[0]))

        # --- completely-in-cluster ops flip symmetrically (rvb.rs:513-531).
        do_flip_sym = completely_in & accept & ~do_rot & ~do_cb
        new_in = jnp.where(do_flip_sym[None] & leg_ok, ~new_in, new_in)
        new_out = jnp.where(do_flip_sym[None] & leg_ok, ~new_out, new_out)

        # --- state / cluster maintenance (boundary weights are recomputed
        # from this carry at the next slot) ---------------------------------
        will_offdiag = jnp.any(new_in != new_out, axis=0) & occ
        for l in range(K):
            u_var = jnp.maximum(vars_p[l], 0)
            ev_tog = do_cb & (l == 0)
            # substate follows the (new) outputs of off-diagonal ops, for
            # accepted replicas the rewritten op, otherwise the original.
            out_l = jnp.where(accept, new_out[l], out_p[l])
            offd = jnp.where(accept, will_offdiag, occ & ~is_diag_p)
            ev_flip = offd & leg_ok[l] & ~do_rot
            ev = ev_tog | ev_flip
            incl = incl.at[rows, u_var].set(
                jnp.where(ev_tog, ~incl[rows, u_var], incl[rows, u_var])
            )
            substate = substate.at[rows, u_var].set(
                jnp.where(ev, out_l, substate[rows, u_var])
            )

        return (substate, incl), (new_bond, new_in, new_out)

    xs = (
        ops.bond,
        jnp.moveaxis(ops.inputs, 1, 0),
        jnp.moveaxis(ops.outputs, 1, 0),
        is_toggle,
        gumbels,
    )
    (_, _), (nb, ni, no) = jax.lax.scan(
        step, (substate0, in0), xs, unroll=2
    )
    ni = jnp.moveaxis(ni, 0, 1)  # [K, M, R]
    no = jnp.moveaxis(no, 0, 1)
    acc_m = accept[None, :]
    new_ops = OpString(
        bond=jnp.where(acc_m, nb, ops.bond),
        inputs=jnp.where(acc_m[None], ni, ops.inputs),
        outputs=jnp.where(acc_m[None], no, ops.outputs),
    )
    new_state = state ^ (in0 & accept[:, None])
    return new_ops, new_state


def _fused_scan(ops, state, model, tables, in0, is_toggle, key):
    """Acceptance + candidate mutation in ONE dense scan.

    The two scans of the legacy path (:func:`_acceptance_scan` then
    :func:`_mutation_scan`) run the same imaginary-time sweep with carries
    related by an invariant: the mutation carry is the acceptance carry with
    the cluster flipped, ``substate_mut == substate ^ incl`` (and
    ``incl_mut == incl`` — both toggle exactly at the cluster-bounding
    constant ops). The rotation weight vector is then exactly the
    acceptance's *after* vector. So one scan carrying ``(substate, incl,
    logm)`` can accumulate the acceptance probability AND emit the
    assume-accepted candidate rewrite; the accept/reject draw selects whole
    arrays per replica afterwards (rejected replicas keep their originals,
    as in ``rvb.rs:294-615`` where ``mutate_graph`` only runs on accept).
    Bit-identical to the legacy two-scan path, one pass over M instead of
    two, shared weight reductions.
    """
    M, R = ops.bond.shape
    K = ops.max_legs
    rows = jnp.arange(R)
    ne = tables.nedges
    va_e = model.bond_vars[:ne, 0]  # [NE] static
    vb_e = model.bond_vars[:ne, 1]
    e_ids = jnp.arange(ne, dtype=jnp.int32)[None, :]

    gumbels = jax.random.gumbel(key, (M, R, ne))

    def step(carry, xs):
        substate, incl, logm = carry
        bond_p, in_p, out_p, tog_p, g = xs  # [R], [K,R], [K,R], [R], [R,NE]
        occ = bond_p >= 0
        b = jnp.maximum(bond_p, 0)
        vars_p = jnp.moveaxis(model.bond_vars[b], -1, 0)  # [K, R]
        leg_ok = (vars_p >= 0) & occ[None]
        arity = jnp.sum(leg_ok, axis=0)
        is_diag_p = jnp.all(in_p == out_p, axis=0)

        va = jnp.maximum(vars_p[0], 0)
        vb = jnp.maximum(vars_p[1] if K > 1 else vars_p[0], 0)
        bdry = incl[rows, va] ^ incl[rows, vb]
        is_boundary_op = occ & is_diag_p & (arity == 2) & (b < ne) & bdry
        is_cb = tog_p & occ
        in_leg = incl[rows[None, :], jnp.maximum(vars_p, 0)] | ~leg_ok
        completely_in = jnp.all(in_leg, axis=0) & occ & (arity > 0)

        # --- shared boundary-weight vectors (pre-event carry) --------------
        bdry_e = incl[:, va_e] ^ incl[:, vb_e]  # [R, NE]
        flipped = substate ^ incl
        w_bef = jnp.where(
            bdry_e,
            _edge_weight(model, e_ids, substate[:, va_e], substate[:, vb_e]),
            0.0,
        )
        w_aft = jnp.where(
            bdry_e,
            _edge_weight(model, e_ids, flipped[:, va_e], flipped[:, vb_e]),
            0.0,
        )
        wb_tot = jnp.sum(w_bef, axis=1)
        wa_tot = jnp.sum(w_aft, axis=1)

        # --- acceptance accumulation (rvb.rs:845-852, :873-879) ------------
        # wa_tot == 0 means the rewrite has zero weight: acceptance must be
        # EXACTLY 0 (the reference's ratio product is 0), not exp(log _TINY),
        # or a u = 0.0 uniform draw could accept an invalid candidate.
        logm = logm + jnp.where(
            is_boundary_op,
            jnp.where(
                wa_tot > 0, jnp.log(jnp.maximum(wa_tot, _TINY)), -jnp.inf
            )
            - jnp.log(jnp.maximum(wb_tot, _TINY)),
            0.0,
        )
        legmask = jnp.where(
            jnp.arange(K, dtype=jnp.int32)[:, None] < arity[None, :], 1, 0
        )
        mask_bits = substate_index(legmask.astype(bool))
        si = substate_index(in_p)
        so = substate_index(out_p)
        if model.full_w is not None:
            w_cur = model.full_w[b, si, so]
            w_flip = model.full_w[b, si ^ mask_bits, so ^ mask_bits]
        else:
            w_cur = jnp.where(si == so, model.diag_w[b, si], 0.0)
            w_flip = jnp.where(si == so, model.diag_w[b, si ^ mask_bits], 0.0)
        ratio_ok = completely_in & ~is_boundary_op
        logm = logm + jnp.where(
            ratio_ok,
            jnp.where(
                w_flip > 0, jnp.log(jnp.maximum(w_flip, _TINY)), -jnp.inf
            )
            - jnp.log(jnp.maximum(w_cur, _TINY)),
            0.0,
        )

        # --- candidate mutation (assume accepted; rvb.rs:294-615) ----------
        score = jnp.where(
            w_aft > 0, jnp.log(jnp.maximum(w_aft, _TINY)) + g, -jnp.inf
        )
        b_new = jnp.argmax(score, axis=1).astype(jnp.int32)
        rot_vars = jnp.stack([va_e[b_new], vb_e[b_new]])  # [2, R]
        rot_bits = jnp.stack(
            [flipped[rows, rot_vars[0]], flipped[rows, rot_vars[1]]]
        )

        do_rot = is_boundary_op
        new_bond = jnp.where(do_rot, b_new, bond_p)
        new_in = in_p
        new_out = out_p
        if K == 2:
            new_in = jnp.where(do_rot[None], rot_bits, new_in)
            new_out = jnp.where(do_rot[None], rot_bits, new_out)
        else:
            pad = jnp.zeros((K - 2, R), bool)
            rb = jnp.concatenate([rot_bits, pad], axis=0)
            new_in = jnp.where(do_rot[None], rb, new_in)
            new_out = jnp.where(do_rot[None], rb, new_out)

        c_pre = incl[rows, va]
        do_cb = is_cb & ~do_rot
        cb_in = in_p[0] ^ c_pre
        cb_out = out_p[0] ^ (~c_pre)
        new_in = new_in.at[0].set(jnp.where(do_cb, cb_in, new_in[0]))
        new_out = new_out.at[0].set(jnp.where(do_cb, cb_out, new_out[0]))

        do_flip_sym = completely_in & ~do_rot & ~do_cb
        new_in = jnp.where(do_flip_sym[None] & leg_ok, ~new_in, new_in)
        new_out = jnp.where(do_flip_sym[None] & leg_ok, ~new_out, new_out)

        # --- carry updates (acceptance semantics; the mutation carry is
        # derived via the invariant, never materialized) ---------------------
        will_flip = occ & ~is_diag_p
        for l in range(K):
            u_var = jnp.maximum(vars_p[l], 0)
            ev_tog = is_cb & (l == 0)
            incl = incl.at[rows, u_var].set(
                jnp.where(ev_tog, ~incl[rows, u_var], incl[rows, u_var])
            )
            ev_flip = will_flip & leg_ok[l]
            substate = substate.at[rows, u_var].set(
                jnp.where(ev_flip, out_p[l], substate[rows, u_var])
            )

        return (substate, incl, logm), (new_bond, new_in, new_out)

    xs = (
        ops.bond,
        jnp.moveaxis(ops.inputs, 1, 0),
        jnp.moveaxis(ops.outputs, 1, 0),
        is_toggle,
        gumbels,
    )
    (_, _, logm), (nb, ni, no) = jax.lax.scan(
        step, (state, in0, jnp.zeros((R,), jnp.float32)), xs, unroll=2
    )
    p_acc = jnp.minimum(jnp.exp(logm), 1.0)
    ni = jnp.moveaxis(ni, 0, 1)  # [K, M, R]
    no = jnp.moveaxis(no, 0, 1)
    return p_acc, nb, ni, no


def _event_parity(v_idx, ev, base, return_total=False):
    """Exclusive-prefix XOR parity of per-slot toggle events along imaginary
    time, seeded with ``base``.

    ``v_idx: i32[M, R, K]`` toggled variable per event (any value >= N for
    no-event), ``ev: bool[M, R, K]`` event mask (at most one event per
    (slot, var) — each op touches a variable through at most one leg),
    ``base: bool[R, N]``. Returns ``bool[M, R, N]``: the parity state *just
    below* slot p (events strictly before p applied to ``base``).

    The event scatter is a one-hot einsum, and so is the prefix itself:
    parity = exclusive-prefix *count* mod 2, and the prefix count is a
    strictly-lower-triangular matmul within blocks of 128 slots plus an
    exclusive cumsum of block totals. Exact at any dot precision: all
    summands are 0/1 in bf16, accumulated in f32 (integer counts < 2^24),
    and the one-hot match is unique per (slot, var).
    """
    M, R, K = v_idx.shape
    N = base.shape[1]
    iota = jnp.arange(N, dtype=jnp.int32)
    oh = (v_idx[..., None] == iota).astype(jnp.bfloat16)  # [M, R, K, N]
    flips = jnp.einsum(
        "mrk,mrkn->mrn",
        ev.astype(jnp.bfloat16),
        oh,
        preferred_element_type=jnp.float32,
    )  # 0/1 counts, f32
    C = 128
    B = -(-M // C)
    fl = jnp.pad(flips, ((0, B * C - M), (0, 0), (0, 0))).reshape(B, C, R, N)
    tri = (
        jnp.arange(C, dtype=jnp.int32)[:, None]
        > jnp.arange(C, dtype=jnp.int32)[None, :]
    ).astype(jnp.bfloat16)
    within = jnp.einsum(
        "tc,bcrn->btrn",
        tri,
        fl.astype(jnp.bfloat16),
        preferred_element_type=jnp.float32,
    )  # exclusive within-block prefix counts
    tot = jnp.sum(fl, axis=1)  # [B, R, N]
    blk = jnp.cumsum(tot, axis=0) - tot  # exclusive block prefix
    cnt = (within + blk[:, None]).astype(jnp.int32)
    par = ((cnt & 1) == 1).reshape(B * C, R, N)[:M]
    if return_total:
        # Parity just *past* the last slot (all events applied) — the carry
        # a chunked caller threads into the next chunk's ``base``.
        tcnt = jnp.sum(tot, axis=0).astype(jnp.int32)  # [R, N]
        total = (((tcnt & 1) == 1)) ^ base
        return par ^ base[None], total
    return par ^ base[None]


def _fused_vectorized(ops, state, model, tables, in0, is_toggle, key,
                      gumbels=None, want_carry=False, cand=None):
    """Acceptance + candidate mutation with NO sequential scan.

    The key observation about :func:`_fused_scan`: its carry ``(substate,
    incl)`` is a function of the ORIGINAL op string only — ``substate``
    follows the original off-diagonal outputs (for a consistent worldline,
    "set to out bit" == "toggle at in != out") and ``incl`` toggles exactly
    at the precomputed ``is_toggle`` slots. Both are therefore
    exclusive-prefix XOR parities over imaginary time, computed here in
    log-depth with :func:`_event_parity`; every per-slot quantity of the
    scan body then vectorizes over the whole M axis, and ``logm`` is a plain
    reduction. This is the batched replacement for the reference's
    heap-merged sparse sweep (``calculate_flip_prob``, ``rvb.rs:649-946``):
    instead of *skipping* slots, all slots are processed in parallel.

    Candidate op arrays are bit-identical to :func:`_fused_scan` (same
    gumbel draws, same discrete arithmetic); ``p_acc`` can differ by f32
    rounding only (summation order of the log-weight accumulation).

    Layout: the elementwise-heavy tensors put imaginary time M, the long
    axis, in the minor dimension — ``[R, NE, M]`` / ``[K, R, M]``. The
    parity pass stays in its matmul form and is transposed once.

    ``gumbels`` optionally injects the rotation noise ``f32[M, R, NE]``
    (``None`` = draw from ``key``); ``want_carry=True`` returns the raw
    log-acceptance and the propagated ``(substate, incl)`` past the last
    slot — the chunked caller's carry (:func:`_fused_chunked`) — instead of
    ``p_acc``.

    ``cand: i32[A, R]`` optionally restricts the edge axis to the cluster's
    candidate boundary edges (:func:`_cluster_cand_edges`; padding id =
    ``nedges``): exact — non-candidate edges contribute 0 to every boundary
    sum and carry zero rotation weight — and the edge-axis footprint drops
    from NE to A. With ``cand``, ``gumbels`` is ``f32[M, R, A]`` in the
    candidate order.
    """
    M, R = ops.bond.shape
    K = ops.max_legs
    N = model.nvars
    ne = tables.nedges
    va_e = model.bond_vars[:ne, 0]  # [NE]
    vb_e = model.bond_vars[:ne, 1]
    if cand is not None:
        A = cand.shape[0]
        cand_t = cand.T  # [R, A]
        cvalid_t = cand_t < ne
        csafe_t = jnp.where(cvalid_t, cand_t, 0)
        va_c = jnp.where(cvalid_t, va_e[csafe_t], -1)  # [R, A]
        vb_c = jnp.where(cvalid_t, vb_e[csafe_t], -1)

    occ = ops.bond >= 0  # [M, R]
    b = jnp.maximum(ops.bond, 0)
    vars_mrk = model.bond_vars[b]  # [M, R, K]
    leg_ok = (vars_mrk >= 0) & occ[..., None]  # [M, R, K]
    in_p = ops.inputs  # [K, M, R]
    out_p = ops.outputs

    # M-minor views for the elementwise stages.
    occ_t = occ.T  # [R, M]
    b_t = b.T
    vars_t = jnp.transpose(vars_mrk, (2, 1, 0))  # [K, R, M]
    leg_ok_t = jnp.transpose(leg_ok, (2, 1, 0))  # [K, R, M]
    arity_t = jnp.sum(leg_ok_t, axis=0)  # [R, M]
    in_t = jnp.moveaxis(in_p, 1, 2)  # [K, R, M]
    out_t = jnp.moveaxis(out_p, 1, 2)
    is_diag_t = jnp.all(in_t == out_t, axis=0)  # [R, M]
    tog_t = is_toggle.T  # [R, M]

    # --- propagated worldline state and cluster mask, all slots at once ----
    # Both are exclusive-prefix XOR parities over the same var axis, so one
    # _event_parity pass computes them batched along the replica axis
    # (lanes [0, R) = worldline substates, lanes [R, 2R) = cluster mask).
    tog_flip = jnp.moveaxis(in_p != out_p, 0, -1) & leg_ok  # [M, R, K]
    va0 = jnp.maximum(vars_mrk[..., 0], 0)
    cb_ev = is_toggle & occ
    cb_v = jnp.where(cb_ev, va0, N)[..., None]  # [M, R, 1]
    cb_pad = jnp.broadcast_to(jnp.int32(N), (M, R, K - 1)) if K > 1 else None
    ev2 = jnp.concatenate(
        [
            tog_flip,
            jnp.concatenate(
                [cb_ev[..., None], jnp.zeros((M, R, K - 1), bool)], axis=-1
            )
            if K > 1
            else cb_ev[..., None],
        ],
        axis=1,
    )  # [M, 2R, K]
    v2 = jnp.concatenate(
        [
            jnp.where(tog_flip, vars_mrk, N),
            jnp.concatenate([cb_v, cb_pad], axis=-1) if K > 1 else cb_v,
        ],
        axis=1,
    )
    base2 = jnp.concatenate([state, in0], axis=0)
    if want_carry:
        par2, end2 = _event_parity(v2, ev2, base2, return_total=True)
    else:
        par2 = _event_parity(v2, ev2, base2)  # [M, 2R, N]
    par2_t = jnp.moveaxis(par2, 0, -1)  # [2R, N, M] (one relayout pass)

    # One-hot selection matmuls in f32 at default precision. Exact on every
    # backend: operands are 0/1 (exact in TF32 and bf16 as well as f32) and
    # each output sums exactly one matched term.
    mm_dt = jnp.float32

    # --- static-edge endpoint bits via one one-hot matmul ------------------
    # (substates and incl share the matmul, batched along the replica axis)
    iota_n = jnp.arange(N, dtype=jnp.int32)[:, None]
    if cand is None:
        oh_ab = jnp.concatenate(
            [
                (iota_n == va_e[None, :]),
                (iota_n == vb_e[None, :]),
            ],
            axis=1,
        ).astype(mm_dt)  # [N, 2*NE]
        bits2 = jnp.einsum(
            "rnm,nq->rqm",
            par2_t.astype(mm_dt),
            oh_ab,
            preferred_element_type=jnp.float32,
        ) == 1.0  # [2R, 2*NE, M]
        sbits, ibits = bits2[:R], bits2[R:]
        sa, sb = sbits[:, :ne], sbits[:, ne:]  # [R, NE, M]
        ia, ib = ibits[:, :ne], ibits[:, ne:]
        ew = ne  # edge-axis width of the weight tensors
    else:
        # Per-replica candidate one-hot (invalid/duplicate columns all-zero,
        # so they contribute nothing to any boundary sum below).
        oh_ab = jnp.concatenate(
            [
                iota_n[None] == va_c[:, None, :],
                iota_n[None] == vb_c[:, None, :],
            ],
            axis=2,
        ).astype(mm_dt)  # [R, N, 2A]
        bits2 = jnp.einsum(
            "xrnm,rnq->xrqm",
            par2_t.reshape(2, R, N, M).astype(mm_dt),
            oh_ab,
            preferred_element_type=jnp.float32,
        ) == 1.0  # [2, R, 2A, M]
        sbits, ibits = bits2[0], bits2[1]
        sa, sb = sbits[:, :A], sbits[:, A:]  # [R, A, M]
        ia, ib = ibits[:, :A], ibits[:, A:]
        ew = A
    bdry_e = ia ^ ib  # [R, ew, M]
    fa, fb = sa ^ ia, sb ^ ib  # flipped = substate ^ incl

    # diag weight of edge e at endpoint spins: select-sum over the 4
    # substates (static edge axis, no dynamic gather; for candidates, a
    # cheap [R, A] row gather of the weight rows).
    if cand is None:
        dw_e = model.diag_w[:ne][None]  # [1, NE, 4]
    else:
        dw_e = model.diag_w[csafe_t]  # [R, A, 4]

    def edge_w(xa, xb):
        si = xa.astype(jnp.int32) + 2 * xb.astype(jnp.int32)  # [., ew, M]
        w = jnp.zeros(si.shape, jnp.float32)
        dw2 = jnp.concatenate([dw_e, dw_e], axis=0) if dw_e.shape[0] > 1 else dw_e
        for s in range(4):
            w = w + jnp.where(si == s, dw2[:, :, s, None], 0.0)
        return w

    w2 = edge_w(
        jnp.concatenate([sa, fa], axis=0), jnp.concatenate([sb, fb], axis=0)
    )  # [2R, ew, M] — before/after share the select-sum
    w_bef = jnp.where(bdry_e, w2[:R], 0.0)
    w_aft = jnp.where(bdry_e, w2[R:], 0.0)
    wb_tot = jnp.sum(w_bef, axis=1)  # [R, M]
    wa_tot = jnp.sum(w_aft, axis=1)

    # --- per-slot cluster-membership bits at the op's own legs -------------
    incl_t = par2_t[R:]  # [R, N, M]
    vars_safe = jnp.maximum(vars_t, 0)  # [K, R, M]
    oh_legs = (
        vars_safe[:, :, None, :] == jnp.arange(N, dtype=jnp.int32)[None, None, :, None]
    ).astype(mm_dt)  # [K, R, N, M]
    incl_legs = jnp.einsum(
        "krnm,rnm->krm",
        oh_legs,
        incl_t.astype(mm_dt),
        preferred_element_type=jnp.float32,
    ) == 1.0  # [K, R, M]
    bdry = incl_legs[0] ^ (incl_legs[1] if K > 1 else incl_legs[0])
    is_boundary_op = occ_t & is_diag_t & (arity_t == 2) & (b_t < ne) & bdry
    is_cb = tog_t & occ_t
    in_leg = incl_legs | ~leg_ok_t
    completely_in = jnp.all(in_leg, axis=0) & occ_t & (arity_t > 0)

    # --- acceptance accumulation (rvb.rs:845-852, :873-879) ----------------
    # Zero-weight rewrites get EXACT -inf (acceptance 0), matching the
    # reference's ratio product and the scan paths.
    logm_slot = jnp.where(
        is_boundary_op,
        jnp.where(wa_tot > 0, jnp.log(jnp.maximum(wa_tot, _TINY)), -jnp.inf)
        - jnp.log(jnp.maximum(wb_tot, _TINY)),
        0.0,
    )  # [R, M]
    legmask = (
        jnp.arange(K, dtype=jnp.int32)[:, None, None] < arity_t[None]
    )  # [K, R, M]
    mask_bits = substate_index(legmask)
    si = substate_index(in_t)
    so = substate_index(out_t)
    nsub = 1 << K
    if model.full_w is not None:
        fw = model.full_w.reshape(-1)
        w_cur = fw[(b_t * nsub + si) * nsub + so]
        w_flip = fw[(b_t * nsub + (si ^ mask_bits)) * nsub + (so ^ mask_bits)]
    else:
        dw = model.diag_w.reshape(-1)
        w_cur = jnp.where(si == so, dw[b_t * nsub + si], 0.0)
        w_flip = jnp.where(
            si == so, dw[b_t * nsub + (si ^ mask_bits)], 0.0
        )
    ratio_ok = completely_in & ~is_boundary_op
    logm_slot = logm_slot + jnp.where(
        ratio_ok,
        jnp.where(w_flip > 0, jnp.log(jnp.maximum(w_flip, _TINY)), -jnp.inf)
        - jnp.log(jnp.maximum(w_cur, _TINY)),
        0.0,
    )
    logm = jnp.sum(logm_slot, axis=1)

    # --- candidate mutation (assume accepted; rvb.rs:294-615) --------------
    # Same [M, R, ew] gumbel draw as _fused_scan (transposed, not redrawn,
    # so the rotation choices stay bit-identical). With ``cand`` the draw is
    # per candidate column; weights still make the choice ∝ w_aft (exactly
    # the full-edge categorical: non-candidates have w_aft = 0).
    raw_g = jax.random.gumbel(key, (M, R, ew)) if gumbels is None else gumbels
    g = jnp.transpose(raw_g, (1, 2, 0))
    score = jnp.where(w_aft > 0, jnp.log(jnp.maximum(w_aft, _TINY)) + g, -jnp.inf)
    b_loc = jnp.argmax(score, axis=1).astype(jnp.int32)  # [R, M]
    oh_rot = (
        b_loc[:, None, :] == jnp.arange(ew, dtype=jnp.int32)[None, :, None]
    )  # [R, ew, M]
    if cand is None:
        b_new = b_loc
    else:  # map the local argmax back to the global edge id (one-hot sum)
        b_new = jnp.sum(
            jnp.where(oh_rot, cand_t[:, :, None], 0), axis=1
        ).astype(jnp.int32)
    rot_bit_a = jnp.any(oh_rot & fa, axis=1)
    rot_bit_b = jnp.any(oh_rot & fb, axis=1)
    rot_bits = jnp.stack([rot_bit_a, rot_bit_b])  # [2, R, M]

    do_rot = is_boundary_op
    new_bond = jnp.where(do_rot, b_new, ops.bond.T)
    new_in = in_t
    new_out = out_t
    if K == 2:
        new_in = jnp.where(do_rot[None], rot_bits, new_in)
        new_out = jnp.where(do_rot[None], rot_bits, new_out)
    else:
        pad = jnp.zeros((K - 2, R, M), bool)
        rb = jnp.concatenate([rot_bits, pad], axis=0)
        new_in = jnp.where(do_rot[None], rb, new_in)
        new_out = jnp.where(do_rot[None], rb, new_out)

    c_pre = incl_legs[0]  # [R, M] membership of the constant op's var
    do_cb = is_cb & ~do_rot
    cb_in = in_t[0] ^ c_pre
    cb_out = out_t[0] ^ (~c_pre)
    new_in = new_in.at[0].set(jnp.where(do_cb, cb_in, new_in[0]))
    new_out = new_out.at[0].set(jnp.where(do_cb, cb_out, new_out[0]))

    do_flip_sym = completely_in & ~do_rot & ~do_cb
    new_in = jnp.where(do_flip_sym[None] & leg_ok_t, ~new_in, new_in)
    new_out = jnp.where(do_flip_sym[None] & leg_ok_t, ~new_out, new_out)

    cands = (
        new_bond.T,
        jnp.moveaxis(new_in, 2, 1),
        jnp.moveaxis(new_out, 2, 1),
    )
    if want_carry:
        return (logm,) + cands + (end2[:R], end2[R:])
    return (jnp.minimum(jnp.exp(logm), 1.0),) + cands


def _fused_chunked(ops, state, model, tables, in0, is_toggle, key, *, mc,
                   gumbels=None, cand=None):
    """:func:`_fused_vectorized` in imaginary-time chunks of ``mc`` slots.

    Beyond the vectorized path's footprint gate the legacy fallback was the
    per-slot sequential scan (:func:`_fused_scan`) — intractable at the
    reference's large RVB benchmark sizes (``two_d_rvb_{16,32}``,
    ``two_d_rvb_cold_{6..8}``, ``benches/end_to_end.rs:260-429``), where the
    cutoff reaches tens of thousands of slots. This path runs one
    ``lax.scan`` over ``ceil(M / mc)`` chunks, carrying exactly the
    invariants the vectorized pass derives from its p=0 base — the
    propagated worldline substate, the cluster-membership mask, and the
    accumulated log acceptance weight — so each chunk gets the full
    vectorized treatment at a bounded ``mc x R x NE`` footprint and the
    sequential depth drops from ``M`` to ``M / mc``.

    Identical discrete arithmetic to the vectorized pass given the same
    rotation noise (the chunk-boundary carry equals the parities the one-shot
    pass computes at those slots — asserted bitwise in
    ``tests/test_rvb_fused.py``); production draws per-chunk noise from
    ``fold_in(key, chunk)``, which only re-keys the i.i.d. Gumbel rotation
    sampler (acceptance never reads the noise; rotation targets stay
    weight-distributed, matching ``mutate_graph``'s on-accept sampling,
    ``rvb.rs:413-434``). Padding slots are identity (``bond = -1``) and
    contribute nothing.
    """
    M, R = ops.bond.shape
    K = ops.max_legs
    ne = tables.nedges if cand is None else cand.shape[0]
    C = -(-M // mc)
    pad = C * mc - M

    bond_c = jnp.pad(ops.bond, ((0, pad), (0, 0)), constant_values=-1)
    bond_c = bond_c.reshape(C, mc, R)
    in_c = jnp.moveaxis(
        jnp.pad(ops.inputs, ((0, 0), (0, pad), (0, 0))).reshape(K, C, mc, R),
        1, 0,
    )  # [C, K, mc, R]
    out_c = jnp.moveaxis(
        jnp.pad(ops.outputs, ((0, 0), (0, pad), (0, 0))).reshape(K, C, mc, R),
        1, 0,
    )
    tog_c = jnp.pad(is_toggle, ((0, pad), (0, 0))).reshape(C, mc, R)

    xs = (bond_c, in_c, out_c, tog_c, jnp.arange(C, dtype=jnp.int32))
    if gumbels is not None:
        xs = xs + (
            jnp.pad(gumbels, ((0, pad), (0, 0), (0, 0))).reshape(
                C, mc, R, ne
            ),
        )

    def body(carry, xs_c):
        sub, incl, logm = carry
        if gumbels is not None:
            bond_k, in_k, out_k, tog_k, c, g_k = xs_c
        else:
            bond_k, in_k, out_k, tog_k, c = xs_c
            g_k = jax.random.gumbel(
                jax.random.fold_in(key, c), (mc, R, ne)
            )
        chunk = OpString(bond=bond_k, inputs=in_k, outputs=out_k)
        lg, nb, ni, no, sub, incl = _fused_vectorized(
            chunk, sub, model, tables, incl, tog_k, key,
            gumbels=g_k, want_carry=True, cand=cand,
        )
        return (sub, incl, logm + lg), (nb, ni, no)

    (_, _, logm), (nb, ni, no) = jax.lax.scan(
        body, (state, in0, jnp.zeros((R,), jnp.float32)), xs
    )
    p_acc = jnp.minimum(jnp.exp(logm), 1.0)
    nb = nb.reshape(C * mc, R)[:M]
    ni = jnp.moveaxis(ni, 1, 0).reshape(K, C * mc, R)[:, :M]
    no = jnp.moveaxis(no, 1, 0).reshape(K, C * mc, R)[:, :M]
    return p_acc, nb, ni, no


# Test hook: force the chunked path with this chunk size (int); None = auto.
_FORCE_CHUNK_MC = None

# Test hook: candidate-restricted edge axis. None = auto (use when strictly
# narrower than NE); True = always; False = never.
_FORCE_CAND = None


def _cand_width(ops, model, tables) -> int:
    """Static width of the candidate edge list (see
    :func:`_cluster_cand_edges`)."""
    D = tables.neigh_bond.shape[1]
    return min(MAX_POPS, ops.cutoff + model.nvars) * D


def _use_cand(ops, model, tables) -> bool:
    """Whether the candidate-restricted pass applies: narrower than the full
    edge axis and not pinned off (the sequential-scan pin has no candidate
    form)."""
    if _FORCE_VEC is False:
        return False
    if _FORCE_CAND is not None:
        return _FORCE_CAND
    return _cand_width(ops, model, tables) < tables.nedges


def _fused_fn(ops, model, tables, cand_width: int | None = None):
    """Dispatch the fused acceptance+mutation pass by footprint: fully
    vectorized when ``M x R x max(EW, K*N)`` fits :data:`_VEC_MAX_ELEMS`
    (``EW`` = the edge-axis width: NE, or the candidate width when
    restricted), chunked-vectorized otherwise. ``_FORCE_VEC`` pins the
    vectorized (True) or sequential-scan (False) path; ``_FORCE_CHUNK_MC``
    pins the chunked path at a given chunk size."""
    if _FORCE_CHUNK_MC is not None:
        return functools.partial(_fused_chunked, mc=_FORCE_CHUNK_MC)
    if _FORCE_VEC is not None:
        return _fused_vectorized if _FORCE_VEC else _fused_scan
    M, R = ops.bond.shape
    ew = cand_width if cand_width is not None else tables.nedges
    per_slot = R * max(ew, ops.max_legs * model.nvars, 1)
    if M * per_slot <= _VEC_MAX_ELEMS:
        return _fused_vectorized
    mc = max(128, _VEC_MAX_ELEMS // per_slot // 128 * 128)
    return functools.partial(_fused_chunked, mc=min(mc, M))


def rvb_update_once(
    ops: OpString,
    state: jax.Array,
    key: jax.Array,
    model: BondModel,
    tables: RvbTables,
    inventory=None,
) -> tuple[OpString, jax.Array, jax.Array]:
    """One RVB update per replica. Returns ``(ops, state, accepted bool[R])``.

    ``inventory`` optionally passes a precomputed :func:`_const_inventory`
    (valid across a whole sweep: RVB only *rewrites* ops — rotations move
    lattice bonds, cluster bounds toggle constant ops off-diagonal — so the
    constant-op positions never change, mirroring how ``find_constants`` in
    ``rvb.rs:1160-1187`` would return the same index every call within
    ``rvb_update``'s loop)."""
    k_build, k_acc, k_mut = jax.random.split(key, 3)
    if inventory is None:
        inventory = _const_inventory(ops, model)
    cvar, cpos, cnext, valid, ncount, has_const = inventory
    popped = _build_cluster(
        k_build, ops, model, tables, cvar, cpos, cnext, valid, ncount, has_const
    )
    in0, is_toggle = _cluster_masks(popped, ops, model, cvar, cpos, cnext, valid)
    if _use_cand(ops, model, tables):
        cand = _cluster_cand_edges(popped, ops, model, tables, cvar, valid)
        fused = _fused_fn(ops, model, tables, cand_width=cand.shape[0])
        fused = functools.partial(fused, cand=cand)
    else:
        fused = _fused_fn(ops, model, tables)
    p_acc, nb, ni, no = fused(
        ops, state, model, tables, in0, is_toggle, k_mut
    )
    accept = jax.random.uniform(k_acc, p_acc.shape) < p_acc
    acc_m = accept[None, :]
    new_ops = OpString(
        bond=jnp.where(acc_m, nb, ops.bond),
        inputs=jnp.where(acc_m[None], ni, ops.inputs),
        outputs=jnp.where(acc_m[None], no, ops.outputs),
    )
    new_state = state ^ (in0 & accept[:, None])
    return new_ops, new_state, accept


def _rvb_update_once_legacy(ops, state, key, model, tables):
    """Two-scan path kept as the equivalence oracle for :func:`_fused_scan`
    (same key structure and draws — outputs must be bit-identical)."""
    k_build, k_acc, k_mut = jax.random.split(key, 3)
    cvar, cpos, cnext, valid, ncount, has_const = _const_inventory(ops, model)
    popped = _build_cluster(
        k_build, ops, model, tables, cvar, cpos, cnext, valid, ncount, has_const
    )
    in0, is_toggle = _cluster_masks(popped, ops, model, cvar, cpos, cnext, valid)
    p_acc = _acceptance_scan(ops, state, model, tables, in0, is_toggle)
    accept = jax.random.uniform(k_acc, p_acc.shape) < p_acc
    new_ops, new_state = _mutation_scan(
        ops, state, model, tables, in0, is_toggle, accept, k_mut
    )
    return new_ops, new_state, accept


# Element cap for the batched cluster-build path (it tiles the per-pop
# [M, R, D] overlap tensors over all n_updates at once).
_BUILD_BATCH_MAX_ELEMS = 1 << 25


def compact_ops(ops: OpString, mc: int):
    """Pack occupied slots into a time-ordered dense prefix of length ``mc``.

    RVB rewrites never insert or remove ops (rotations move bonds, cluster
    bounds toggle constant ops off-diagonal, interior ops flip symmetrically
    — ``mutate_graph``, ``rvb.rs:294-615``), so the occupied-slot set is
    invariant across a whole sweep: compact once, sweep in compact space,
    scatter back once. This is the tensor-land analog of the reference's
    windowed subsection cursors (``diagonal_subsection.rs:27-156``) and
    heap-merged sparse sweep (``rvb.rs:649-946``): the per-update cost
    scales with the op count ``n`` instead of the padded cutoff ``M``.

    Compaction preserves RVB semantics exactly: identity slots are no-ops
    for every carry, and all imaginary-time structure the update reads —
    cyclic *order* of ops, segment interval overlap (:func:`_cyc_overlap` on
    bounding-op positions), the p=0 wrap — is invariant under the
    order-preserving slot remap.

    One multi-operand sort: key = slot id for occupied slots, slot id + M
    for identities, so ascending order is (occupied in time order, then
    identities in time order); payloads ride the sort as extra operands.
    Returns
    ``(ops_c, tail, sk)``: the compact string, the sorted payload rows
    beyond ``mc`` (needed to rebuild the full string), and the sorted key
    array ``i32[M, R]`` (``sk % M`` = original slot of each sorted row).

    Replicas with more than ``mc`` occupied slots get a truncated (invalid)
    prefix — :func:`rvb_sweep` detects and discards those lanes."""
    M, R = ops.bond.shape
    K = ops.max_legs
    iota = jnp.broadcast_to(jnp.arange(M, dtype=jnp.int32)[:, None], (M, R))
    pack_key = jnp.where(ops.bond >= 0, iota, iota + M)
    operands = (pack_key, ops.bond) + tuple(ops.inputs) + tuple(ops.outputs)
    s = jax.lax.sort(operands, dimension=0, num_keys=1)
    ops_c = OpString(
        bond=s[1][:mc],
        inputs=jnp.stack([x[:mc] for x in s[2:2 + K]]),
        outputs=jnp.stack([x[:mc] for x in s[2 + K:]]),
    )
    tail = tuple(x[mc:] for x in s[1:])
    return ops_c, tail, s[0]


def uncompact_ops(ops_c: OpString, tail, sk) -> OpString:
    """Inverse of :func:`compact_ops` after in-place rewrites of the prefix:
    concatenate the (rewritten) prefix with the untouched tail rows and sort
    by original slot id — the payload back-sort that replaces a scatter."""
    M, R = sk.shape
    K = ops_c.max_legs
    orig = sk - jnp.where(sk >= M, jnp.int32(M), 0)
    full = (
        jnp.concatenate([ops_c.bond, tail[0]], axis=0),
        *(jnp.concatenate([ops_c.inputs[k], tail[1 + k]], axis=0)
          for k in range(K)),
        *(jnp.concatenate([ops_c.outputs[k], tail[1 + K + k]], axis=0)
          for k in range(K)),
    )
    out = jax.lax.sort((orig,) + full, dimension=0, num_keys=1)
    return OpString(
        bond=out[1],
        inputs=jnp.stack(out[2:2 + K]),
        outputs=jnp.stack(out[2 + K:]),
    )


@functools.partial(jax.jit, static_argnames=("n_updates", "compact_cutoff"))
def rvb_sweep(
    ops: OpString,
    state: jax.Array,
    key: jax.Array,
    model: BondModel,
    tables: RvbTables,
    n_updates: int,
    compact_cutoff: int | None = None,
) -> tuple[OpString, jax.Array, jax.Array]:
    """``n_updates`` sequential RVB updates (the reference runs
    ``(nvars+1)/2`` per timestep, ``qmc_ising.rs:705-710``). Returns
    ``(ops, state, successes i32[R])``.

    ``compact_cutoff`` (static) runs the whole sweep in active-slot-compacted
    space (:func:`compact_ops`): identical update distribution, cost scaling
    with the op count instead of the padded cutoff. Replicas whose op count
    exceeds the compact cutoff keep their originals for this sweep (succ 0)
    — unbiased, because RVB updates never change the op count, so the
    skip predicate is invariant along every transition of the skipped
    kernel and detailed balance holds lane by lane. (Such lanes slightly
    undercount ``rvb_success_rate``'s denominator; the host refreshes the
    cutoff each chunk, keeping overflow rare.)"""
    M, R = ops.bond.shape
    if compact_cutoff is None or compact_cutoff >= M:
        return _rvb_sweep_impl(ops, state, key, model, tables, n_updates)
    mc = compact_cutoff
    fits = jnp.sum(ops.bond >= 0, axis=0) <= mc  # [R]
    ops_c, tail, sk = compact_ops(ops, mc)
    ops_c, new_state, succ = _rvb_sweep_impl(
        ops_c, state, key, model, tables, n_updates
    )
    unc = uncompact_ops(ops_c, tail, sk)
    fr = fits[None, :]
    new_ops = OpString(
        bond=jnp.where(fr, unc.bond, ops.bond),
        inputs=jnp.where(fr[None], unc.inputs, ops.inputs),
        outputs=jnp.where(fr[None], unc.outputs, ops.outputs),
    )
    return (
        new_ops,
        jnp.where(fits[:, None], new_state, state),
        jnp.where(fits, succ, 0),
    )


def _rvb_sweep_impl(
    ops: OpString,
    state: jax.Array,
    key: jax.Array,
    model: BondModel,
    tables: RvbTables,
    n_updates: int,
) -> tuple[OpString, jax.Array, jax.Array]:
    """The sweep body (see :func:`rvb_sweep`).

    The constant-op inventory is computed once for the whole sweep (see
    :func:`rvb_update_once`: RVB rewrites never move constant ops, so the
    sorted inventory — an argsort over the full op string — is invariant
    across the updates).

    For the same reason cluster *building* is independent of the mutations
    within a sweep — :func:`_build_cluster` and :func:`_cluster_masks` read
    only the inventory, never the op contents — so all ``n_updates`` cluster
    builds run in ONE vmapped pass up front (each sequential update then does
    only the acceptance+mutation work). The builds' Gumbel-pop ``while_loop``
    dominates the small-lattice latency; batching amortizes it across the
    whole sweep. Bit-identical to the sequential form: the per-update key
    splits are preserved, and inactive lanes of the vmapped pop loop are
    fixed points of its body."""
    M, R = ops.bond.shape
    N = model.nvars
    D = tables.neigh_bond.shape[1]
    inventory = _const_inventory(ops, model)
    keys = jax.random.split(key, n_updates)
    succ0 = jnp.zeros(state.shape[0], jnp.int32)

    build_fp = n_updates * R * max(M * D, M + N)
    if build_fp > _BUILD_BATCH_MAX_ELEMS:
        # Large strings: keep builds inside the sequential loop.
        def body_seq(carry, k):
            ops, state, succ = carry
            ops, state, acc = rvb_update_once(
                ops, state, k, model, tables, inventory=inventory
            )
            return (ops, state, succ + acc.astype(jnp.int32)), None

        (ops, state, succ), _ = jax.lax.scan(
            body_seq, (ops, state, succ0), keys
        )
        return ops, state, succ

    cvar, cpos, cnext, valid, ncount, has_const = inventory
    splits = jax.vmap(lambda k: jax.random.split(k, 3))(keys)  # [U, 3] keys
    k_build, k_acc, k_mut = splits[:, 0], splits[:, 1], splits[:, 2]

    popped = jax.vmap(
        lambda kk: _build_cluster(
            kk, ops, model, tables, cvar, cpos, cnext, valid, ncount, has_const
        )
    )(k_build)  # [U, R, M+N]
    in0, is_toggle = jax.vmap(
        lambda p: _cluster_masks(p, ops, model, cvar, cpos, cnext, valid)
    )(popped)  # [U, R, N], [U, M, R]

    if _use_cand(ops, model, tables):
        cands = jax.vmap(
            lambda p: _cluster_cand_edges(p, ops, model, tables, cvar, valid)
        )(popped)  # [U, A, R]
        fused = _fused_fn(ops, model, tables, cand_width=cands.shape[1])
    else:
        cands = None
        fused = _fused_fn(ops, model, tables)

    def body(carry, xs):
        ops, state, succ = carry
        in0_u, tog_u, ka, km, cand_u = xs
        kw = {} if cand_u is None else {"cand": cand_u}
        p_acc, nb, ni, no = fused(
            ops, state, model, tables, in0_u, tog_u, km, **kw
        )
        accept = jax.random.uniform(ka, p_acc.shape) < p_acc
        acc_m = accept[None, :]
        new_ops = OpString(
            bond=jnp.where(acc_m, nb, ops.bond),
            inputs=jnp.where(acc_m[None], ni, ops.inputs),
            outputs=jnp.where(acc_m[None], no, ops.outputs),
        )
        new_state = state ^ (in0_u & accept[:, None])
        return (new_ops, new_state, succ + accept.astype(jnp.int32)), None

    (ops, state, succ), _ = jax.lax.scan(
        body, (ops, state, succ0), (in0, is_toggle, k_acc, k_mut, cands)
    )
    return ops, state, succ
