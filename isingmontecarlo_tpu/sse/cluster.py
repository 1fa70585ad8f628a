"""SSE cluster update (reference ``src/sse/qmc_traits/cluster.rs``).

Reference semantics: build clusters over op *sides* — each non-identity op at
slot ``p`` has an input-side and an output-side node. Constant single-variable
ops (transverse-field ops) are *cluster edges*: their two sides belong to
different clusters (``is_valid_cluster_edge``, ``cluster.rs:276-286``). Every
other op's sides (and all its legs) are one cluster, and worldline segments
connect an op's output side to the next op on the same variable (periodic in
imaginary time). Each cluster flips with probability 1/2, weighted by the
product of per-op weight-change ratios when Ising symmetry is broken
(``flip_each_cluster_rng``, ``cluster.rs:36-172``). Flipping toggles the
corresponding side's spins; a transverse op with exactly one flipped side
becomes off-diagonal. Finally the p=0 state is re-read from the (possibly
flipped) inputs of the first op on each variable (``cluster.rs:150-160``).

Batched form: cluster construction is iterated min-label propagation (the
vectorized cluster-search lineage of Mino's self-labeling,
arXiv:hep-lat/9112001, and GPU Swendsen-Wang label propagation,
arXiv:2302.14720) over a *segment-contracted* graph: each maximal worldline
run between cluster-edge ops is one supernode (see :func:`segment_graph`),
derived by one sort of all legs along imaginary time plus a break-count
prefix sum. The contracted graph has < M + N nodes and edges per replica —
~3x fewer label rows than op-side path space — and components are labeled
by hook-and-compress
union-find (:func:`_hook_compress_labels`), converging in O(log diameter)
rounds. Per-cluster decisions are gathers keyed by the cluster's root label.

Deviation from the reference: when no constant op exists the reference treats
the whole op string as a single cluster (``cluster.rs:98-107``); label
propagation instead yields one cluster per connected component of the leg
graph. Components are closed under op legs, so flipping them independently
also preserves all op weights — a strictly more ergodic, equally valid move.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from isingmontecarlo_tpu.sse.model import BondModel
from isingmontecarlo_tpu.sse.opstring import OpString, op_vars, substate_index
from isingmontecarlo_tpu.sse.tables import (
    bond_fetch, class_select, fetch_xor, row_select, row_select3,
)


def is_valid_cluster_edge(is_constant, nvars):
    """Whether an op can bound a cluster in imaginary time: constant
    single-variable ops only (``is_valid_cluster_edge``,
    ``cluster.rs:280-286``). Accepts scalars or arrays."""
    return jnp.logical_and(jnp.asarray(is_constant), jnp.asarray(nvars) == 1)

def _take0(arr, idx):
    """Gather along axis 0 with a [X, R] index grid."""
    return jnp.take_along_axis(arr, idx, axis=0)


_SORT_BIG = jnp.int32(2**30)

# Footprint gate for the one-hot wrap-edge einsum in segment_graph: it
# materializes a [K*M, R, N] one-hot; beyond this the sort-compacted
# fallback runs. Both the segment ids and flat leg indices must also fit
# two base-128 bf16 digit planes (< 128^2).
_WRAP_EINSUM_MAX = 1 << 26


class SegGraph(NamedTuple):
    """Segment-contracted label problem (see :func:`segment_graph`)."""

    seg_in: jax.Array  # i32[M, R] in-side segment id per op slot
    seg_out: jax.Array  # i32[M, R]
    u: jax.Array  # i32[E, R] edge endpoints (dump = S - 1)
    v: jax.Array  # i32[E, R]
    nseg: jax.Array  # i32[R] per-replica segment count
    head_f: jax.Array  # i32[N, R] flat leg index of each var's first leg
    #                      (K*M where the var has no legs)
    S: int  # static label-space size


def segment_graph(ops: OpString, model: BondModel) -> SegGraph:
    """Contract worldline runs between cluster-edge ops into supernodes.

    Cluster connectivity over op sides (``cluster.rs:193-271``) factors
    through maximal worldline runs not interrupted by a cluster-edge op
    (``is_valid_cluster_edge``, ``cluster.rs:276-286``): every op side in
    such a run is in the same cluster, so the run is one supernode. Per
    replica there are fewer than ``M + N`` supernodes (one break per edge op
    plus one per variable worldline), statically padded to ``S = M + N + 1``
    with a trailing dump row for invalid slots — typically ~3x fewer label
    rows than the ``2*K*M`` op-side path space.

    Segment ids are break-count prefix sums over the sorted-leg path space
    (element ``2j`` = in side, ``2j+1`` = out side of sorted leg ``j``; the
    worldline sort makes runs contiguous). Graph edges: one per multi-leg op
    chaining legs ``l, l+1`` through their in-side segments (``(K-1)*M``
    rows; in/out of a non-edge op share a segment, so leg sides need no
    separate edges) plus one periodic-wrap edge per variable (``N`` rows).

    No gather or scatter runs at path-space size: the edge flags ride the
    worldline sort as a *payload operand*, and the
    sorted-space segment ids return to flat leg space through a second
    ``lax.sort`` keyed by the permutation itself (a stable sort by ``order``
    puts every payload back at its original flat index) — sorts replace all
    path-space gathers/scatters. The per-variable wrap rows (head/tail
    segments, first-leg index) become one digit-plane one-hot einsum over
    the variable axis (exact: one head and one tail per worldline, planes
    < 128 are exact in bf16, f32 accumulation of a single matched term),
    with the scatter path kept for footprints beyond the gate.
    """
    M, R = ops.bond.shape
    K = ops.max_legs
    KM = K * M
    N = model.nvars
    S = M + N + 1

    valid_op = ops.bond >= 0  # [M, R]
    b = jnp.maximum(ops.bond, 0)
    # Per-leg var / edge-flag fetches, legs-major ([K, M, R]).
    vars_kmr = op_vars(ops, model)  # [K, M, R]
    edge_t = (model.is_constant & (model.arity() == 1)).astype(jnp.int32)
    is_edge = (bond_fetch(edge_t, b) == 1) & valid_op  # cluster.rs:276-286
    leg_var = vars_kmr.reshape(KM, R)
    p_of_f = jnp.arange(KM, dtype=jnp.int32) % M
    key = jnp.where(leg_var >= 0, leg_var * M + p_of_f[:, None], _SORT_BIG)
    iota_f = jnp.broadcast_to(jnp.arange(KM, dtype=jnp.int32)[:, None], (KM, R))
    edge_leg = jnp.broadcast_to(is_edge[None], (K, M, R)).reshape(KM, R)

    skey, order, edge_s = jax.lax.sort(
        (key, iota_f, edge_leg.astype(jnp.int32)), dimension=0, num_keys=1
    )
    valid_j = skey < _SORT_BIG
    svar = jnp.where(valid_j, skey // M, -1)
    seg_start = jnp.concatenate(
        [jnp.ones((1, R), bool), svar[1:] != svar[:-1]], axis=0
    )
    seg_end = jnp.concatenate(
        [svar[:-1] != svar[1:], jnp.ones((1, R), bool)], axis=0
    )
    edge_j = (edge_s == 1) & valid_j

    # Path-space breaks: a new segment starts at worldline group heads
    # (before the in element) and at the in->out boundary of edge ops. The
    # interleaved [2KM] break sequence (in element 2j, out element 2j+1)
    # collapses to ONE [KM] cumsum: with c_j = inclusive-cumsum of
    # (break_in + edge), the in element's id is c_j - edge_j - 1 and the
    # out element's is c_j - 1 (the edge break sits between them).
    break_in = seg_start & valid_j
    edge_i = edge_j.astype(jnp.int32)
    c = jnp.cumsum(break_in.astype(jnp.int32) + edge_i, axis=0)  # [KM, R]
    seg_in_j = jnp.where(valid_j, c - edge_i - 1, S - 1)
    seg_out_j = jnp.where(valid_j, c - 1, S - 1)
    nseg = c[-1, :]

    # Back-permute sorted-space segment ids to flat leg space: stable sort
    # keyed by the permutation (distinct keys -> payload f lands at row f).
    _, seg_in_f, seg_out_f = jax.lax.sort(
        (order, seg_in_j, seg_out_j), dimension=0, num_keys=1
    )
    seg_in_k = seg_in_f.reshape(K, M, R)
    seg_out_k = seg_out_f.reshape(K, M, R)
    seg_in = jnp.where(valid_op, seg_in_k[0], S - 1)
    seg_out = jnp.where(valid_op, seg_out_k[0], S - 1)

    # Sibling edges: chain legs l and l+1 of each op via their in elements.
    us, vs = [], []
    for l in range(K - 1):
        ok = (vars_kmr[l] >= 0) & (vars_kmr[l + 1] >= 0)
        us.append(jnp.where(ok, seg_in_k[l], S - 1))
        vs.append(jnp.where(ok, seg_in_k[l + 1], S - 1))

    # Wrap edges (head-in segment <-> tail-out segment per variable group)
    # and first-leg flat indices per variable.
    head = seg_start & valid_j
    tail = seg_end & valid_j
    if KM * R * N <= _WRAP_EINSUM_MAX and max(S, KM + 1) <= 128 * 128:
        hf = head.astype(jnp.bfloat16)
        tf = tail.astype(jnp.bfloat16)
        planes = jnp.stack(
            [
                hf * (seg_in_j // 128).astype(jnp.bfloat16),
                hf * (seg_in_j % 128).astype(jnp.bfloat16),
                hf,
                tf * (seg_out_j // 128).astype(jnp.bfloat16),
                tf * (seg_out_j % 128).astype(jnp.bfloat16),
                hf * (order // 128).astype(jnp.bfloat16),
                hf * (order % 128).astype(jnp.bfloat16),
            ],
            axis=-1,
        )  # [KM, R, 7], every entry < 128 (exact in bf16)
        oh = (
            svar[..., None] == jnp.arange(N, dtype=jnp.int32)
        ).astype(jnp.bfloat16)  # [KM, R, N]
        out = jnp.einsum(
            "jrd,jrn->nrd", planes, oh, preferred_element_type=jnp.float32
        ).astype(jnp.int32)  # [N, R, 7]
        has_head = out[..., 2] > 0
        uw = jnp.where(has_head, out[..., 0] * 128 + out[..., 1], S - 1)
        vw = jnp.where(has_head, out[..., 3] * 128 + out[..., 4], S - 1)
        head_f = jnp.where(has_head, out[..., 5] * 128 + out[..., 6], KM)
    else:
        # Sort-compacted fallback (runs beyond the einsum gate, e.g. 32^2):
        # heads/tails are already ordered by variable in sorted leg space
        # (one head and one tail per worldline group), so a sort keyed on
        # (is_head ? var : BIG) packs the <= N head rows to the front in var
        # order; the dense-by-var placement then scatters only [T, R] rows
        # (T = min(N, KM)) instead of the full [KM, R] grid, 2K*M/N-fold
        # fewer elements.
        T = min(N, KM)
        # One compaction sort instead of two: each group's tail seg_out is
        # segmented-broadcast back onto its head row first, so the head
        # rows carry (seg_in, seg_out, order) together.
        from isingmontecarlo_tpu.sse.opstring import _seg_broadcast

        tail_seg = _seg_broadcast(tail, seg_out_j, reverse=True)
        kh_key = jnp.where(head, svar, _SORT_BIG)
        kh, d_in, d_out, d_order = jax.lax.sort(
            (kh_key, seg_in_j, tail_seg, order), dimension=0, num_keys=1
        )
        vh = jnp.where(kh[:T] < _SORT_BIG, kh[:T], N)  # [T, R]
        # Dense-by-var placement: each var has at most one real head row.
        cols_t = jnp.broadcast_to(
            jnp.arange(R, dtype=jnp.int32)[None, :], (T, R)
        )
        uw = (
            jnp.full((N + 1, R), S - 1, jnp.int32)
            .at[vh, cols_t].set(d_in[:T], mode="drop")[:N]
        )
        vw = (
            jnp.full((N + 1, R), S - 1, jnp.int32)
            .at[vh, cols_t].set(d_out[:T], mode="drop")[:N]
        )
        head_f = (
            jnp.full((N + 1, R), KM, jnp.int32)
            .at[vh, cols_t].set(d_order[:T], mode="drop")[:N]
        )
    u = jnp.concatenate(us + [uw], axis=0)
    v = jnp.concatenate(vs + [vw], axis=0)
    return SegGraph(
        seg_in=seg_in, seg_out=seg_out, u=u, v=v, nseg=nseg, head_f=head_f, S=S
    )


def _compact_dispatch(u, v, S: int, nseg, seg_in, seg_out, consume,
                      label_cap: int | None = None,
                      edge_cap: int | None = None,
                      overflow_noop=None):
    """Run ``consume(W, seg_in, seg_out, SL)`` on a statically *compacted*
    label problem when it fits, else on the full-size one.

    Segment ids are already dense per replica (cumsum-assigned in
    :func:`segment_graph`) — only the static padding is oversized: the real
    segment count is ``n_edge_ops + n_worldlines`` and the real edge count
    ``n_multileg_ops + n_worldlines``, typically well under the padded
    ``M + N + 1``. Default caps: label rows at ``S // 2``, edge rows at
    ``2E // 3`` (16-aligned); callers that track the real counts on the
    host (``QmcIsingGraph._maybe_grow``) pass tighter static
    ``label_cap``/``edge_cap`` — every per-round label gather/scatter
    shrinks with them. A ``lax.cond`` guards overflow. With
    ``overflow_noop=None`` the fallback branch runs the FULL-size pipeline
    (both branches compile, the cheap one executes). With ``overflow_noop``
    set to a pytree matching ``consume``'s output, the overflow branch
    returns that constant instead: sweep-path callers use it to make a
    cap-overflowing dispatch SKIP the cluster update — a valid thinner
    update schedule, and the host refreshes caps from ``_cap_counts`` after
    every chunk so overflow lasts at most one chunk (the full fallback
    would double the cluster code, and compile time, of every sweep body).
    Edges are packed to the front with a
    stable 3-operand sort on the dump flag (edges with dump endpoints are
    no-ops and never one-sided, so ``u == dump`` identifies them; a sort
    replaces two per-lane [E, R] scatters); in the compact branch the dump
    segment id remaps to the compact dump row ``C - 1``, which no real id
    can reach (ids are bounded by the per-replica count ``nseg``, including
    segments isolated from every edge). ``consume`` receives the branch's
    label table, remapped per-op segment ids, and the static label-space
    size, and must return pytrees of identical shape in both branches."""
    E, R = u.shape
    C = label_cap or max(256, 16 * (-(-(S // 2) // 16)))
    CE = edge_cap or max(256, 16 * (-(-(2 * E // 3) // 16)))
    CE = min(CE, E)
    if C + 64 >= S:
        return consume(_hook_compress_labels(u, v, S), seg_in, seg_out, S)
    dump = S - 1
    cdump = C - 1
    is_edge = u != dump
    nedge = jnp.sum(is_edge, axis=0)  # [R]
    fits = (jnp.max(nseg) <= cdump) & (jnp.max(nedge) <= CE)

    def compact(_):
        _, us, vs = jax.lax.sort(
            ((~is_edge).astype(jnp.int32), u, v), dimension=0, num_keys=1
        )
        uc = jnp.minimum(us[:CE], cdump)
        vc = jnp.minimum(vs[:CE], cdump)
        Wc = _hook_compress_labels(uc, vc, C)
        return consume(
            Wc, jnp.minimum(seg_in, cdump), jnp.minimum(seg_out, cdump), C
        )

    if overflow_noop is not None:
        def full(_):
            return overflow_noop
    else:
        def full(_):
            return consume(_hook_compress_labels(u, v, S), seg_in, seg_out, S)

    return jax.lax.cond(fits, compact, full, None)


# A gather-only FastSV fixpoint (static sorted adjacency, segmented-min
# rounds, no per-round sort/scatter) was built and deleted: it takes many
# more rounds than hook-and-compress and each round still pays three [*, R]
# gathers; see git history.
# Pointer-jump count per hook round (see _hook_compress_labels).
_N_COMPRESS = 2


def _hook_compress_labels(u, v, S: int, n_compress: int | None = None):
    """Connected components over the (fixed) segment edge list by
    hook-and-compress (the bulk-synchronous union-find family of
    Shiloach-Vishkin / GPU CC kernels, cf. arXiv:2302.14720): each round
    hooks ``min(P[u], P[v])`` onto the row of the *larger endpoint label*
    (``P[max] <- min``) and then pointer-jumps ``P <- P[P]`` ``n_compress``
    times. Hooking writes to the label's own row, so jumping halves parent
    chains and the fixpoint arrives in O(log diameter) rounds, against
    diameter-bound rounds for plain min-label edge relaxation.

    Invariants: ``P[x] <= x`` and values stay inside the component, so the
    fixpoint assigns every segment of a component the same root id (not
    necessarily the component minimum — callers only use label equality).
    Gathers and the hook's scatter-min are native XLA operations."""
    if n_compress is None:
        n_compress = _N_COMPRESS
    E, R = u.shape
    cols = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32)[None, :], (E, R))
    P0 = jnp.tile(jnp.arange(S, dtype=jnp.int32)[:, None], (1, R))

    def hook(P, pu, pv):
        m = jnp.minimum(pu, pv)
        mx = jnp.maximum(pu, pv)
        Pn = P.at[mx, cols].min(m)
        for _ in range(n_compress):
            Pn = _take0(Pn, Pn)
        return Pn

    def body(state):
        P, _ = state
        Pn = hook(P, _take0(P, u), _take0(P, v))
        return Pn, jnp.any(Pn != P)

    # Round 1 specialized: P0 is the identity, so the endpoint-label
    # gathers are just (u, v) — two [E, R] take0 passes saved.
    P1 = hook(P0, u, v)
    P, _ = jax.lax.while_loop(
        lambda s: s[1], body, (P1, jnp.any(P1 != P0))
    )
    return P


def cluster_labels(ops: OpString, model: BondModel,
                   label_cap: int | None = None,
                   edge_cap: int | None = None):
    """Min-label clusters over op sides via the contracted segment graph.
    Returns ``labels: i32[2M, R]`` (node ``2p`` = input side, ``2p+1`` =
    output side of slot ``p``); label values are component-min *segment* ids
    in ``[0, M+N]`` — equality defines the partition. Invalid slots share
    the dump segment's label."""
    sg = segment_graph(ops, model)
    M, R = ops.bond.shape

    def consume(W, s_in, s_out, SL):
        lab_in = _take0(W, s_in)
        lab_out = _take0(W, s_out)
        return jnp.stack([lab_in, lab_out], axis=1).reshape(2 * M, R)

    return _compact_dispatch(
        sg.u, sg.v, sg.S, sg.nseg, sg.seg_in, sg.seg_out, consume,
        label_cap=label_cap, edge_cap=edge_cap,
    )


@functools.partial(jax.jit, static_argnames=("label_cap", "edge_cap"))
def cluster_update(
    ops: OpString,
    state: jax.Array,  # bool[R, N]
    key: jax.Array,
    model: BondModel,
    prob: float = 0.5,
    label_cap: int | None = None,
    edge_cap: int | None = None,
    bond_xor: jax.Array | None = None,  # i32[R, NB] sign-pattern masks
) -> tuple[OpString, jax.Array]:
    """Flip every spacetime cluster with probability ``prob`` x weight ratio.

    Implements ``flip_each_cluster_rng`` / ``.._ising_symmetry_rng``
    (``cluster.rs:18-172``). The weight ratio per cluster is the product over
    member ops (with both sides in the cluster) of
    ``W(flipped op) / W(op)`` — e.g. 0 for longitudinal field ops, freezing
    their clusters (``qmc_ising.rs:755-772``); computed generically from the
    model's weight tables so the same kernel serves symmetric models
    (ratio identically 1).
    """
    sg = segment_graph(ops, model)
    return _cluster_update_impl(
        ops, state, key, model, prob, label_cap, edge_cap, sg,
        bond_xor=bond_xor,
    )


def _cluster_update_impl(
    ops: OpString,
    state: jax.Array,
    key: jax.Array,
    model: BondModel,
    prob: float,
    label_cap: int | None,
    edge_cap: int | None,
    sg: SegGraph,
    bond_xor: jax.Array | None = None,
) -> tuple[OpString, jax.Array]:
    """:func:`cluster_update` body given a precomputed :func:`segment_graph`
    (callers that also need per-variable leg info — e.g. the sweep driver's
    free-spin resampling reading ``sg.head_f`` — share one build)."""
    M, R = ops.bond.shape
    K = ops.max_legs
    S = sg.S

    k_u = jax.random.fold_in(key, 0)
    valid_op = ops.bond >= 0
    b = jnp.maximum(ops.bond, 0)
    si = substate_index(ops.inputs)  # [M, R]
    so = substate_index(ops.outputs)
    # flipped substate: toggle the valid legs' bits
    arity = bond_fetch(model.arity(), b)
    legmask = (1 << arity) - 1  # int[M, R]
    if bond_xor is not None:
        # Per-replica sign patterns permute the weight-table columns (see
        # diagonal._xor_si); the stored spins stay physical, so only these
        # lookup indices shift (XOR commutes with the cluster's leg flip).
        xm = fetch_xor(bond_xor, b)
        si = si ^ xm
        so = so ^ xm
    fsi = si ^ legmask
    fso = so ^ legmask
    SS = 1 << K
    use_full_cls = (
        model.wtab_full is not None and model.wtab_full.size <= 64
    )
    if model.full_w is not None and use_full_cls:
        # Class-table select chain instead of [M, R, 2^2K] row gathers;
        # exact — selects original entries.
        cls_f = bond_fetch(model.cls_full, b)
        w_cur = class_select(model.wtab_full, cls_f, si * SS + so)
        w_flip = class_select(model.wtab_full, cls_f, fsi * SS + fso)
    elif model.full_w is not None:
        w_cur = row_select3(model.full_w, b, si, so)
        w_flip = row_select3(model.full_w, b, fsi, fso)
    else:
        w_cur = jnp.where(si == so, row_select(model.diag_w, b, si), 0.0)
        w_flip = jnp.where(fsi == fso, row_select(model.diag_w, b, fsi), 0.0)
    rows_m = jnp.broadcast_to(jnp.arange(R, dtype=jnp.int32)[None, :], (M, R))

    def _flip_decisions(W, s_in, s_out, SL: int):
        """Per-root flip decisions at label-space size ``SL`` — run inside
        the compact/full cond branches so every label-space gather, scatter,
        and uniform draw shrinks with the compact cap (the branches draw
        different-shaped uniforms; both are valid chains)."""
        lab_in = _take0(W, s_in)  # [M, R] component root id
        lab_out = _take0(W, s_out)
        both_sides = valid_op & (lab_in == lab_out)  # cluster.rs:120-128
        ratio = jnp.where(both_sides, w_flip / jnp.maximum(w_cur, 1e-30), 1.0)
        frozen = both_sides & (w_flip <= 0.0)
        logr = jnp.where(both_sides, jnp.log(jnp.maximum(ratio, 1e-30)), 0.0)
        acc_logr = jnp.zeros((SL, R), jnp.float32).at[lab_in, rows_m].add(logr)
        acc_frozen = jnp.zeros((SL, R), bool).at[lab_in, rows_m].max(frozen)
        flip_prob = jnp.minimum(prob * jnp.exp(acc_logr), 1.0)
        u_root = jax.random.uniform(k_u, (SL, R))
        flip_root = (u_root < flip_prob) & ~acc_frozen  # [SL, R] per root
        f_in = _take0(flip_root, lab_in) & valid_op  # [M, R]
        f_out = _take0(flip_root, lab_out) & valid_op
        return f_in, f_out

    # With host-managed caps (the steady-state sweep path), a cap overflow
    # SKIPS this cluster update (all-False flips) instead of compiling a
    # second full-size pipeline into the sweep body: a skipped update is a
    # valid thinner schedule, the host refreshes caps after every chunk
    # (``QmcIsingGraph._maybe_grow``), and halving the cluster code halves
    # the fused program's compile time. Cap-less callers (cold starts, public default) keep the
    # full-size fallback: their default caps overflow routinely while
    # M < ~2N and silently skipping would stall off-diagonal equilibration.
    noop = None
    if label_cap is not None:
        noop = (jnp.zeros((M, R), bool), jnp.zeros((M, R), bool))
    flip_in, flip_out = _compact_dispatch(
        sg.u, sg.v, sg.S, sg.nseg, sg.seg_in, sg.seg_out, _flip_decisions,
        label_cap=label_cap, edge_cap=edge_cap, overflow_noop=noop,
    )

    lv = op_vars(ops, model) >= 0  # [K, M, R]
    new_inputs = jnp.where(flip_in[None] & lv, ~ops.inputs, ops.inputs)
    new_outputs = jnp.where(flip_out[None] & lv, ~ops.outputs, ops.outputs)
    new_ops = OpString(bond=ops.bond, inputs=new_inputs, outputs=new_outputs)

    # Rebuild the p=0 state from the first op on each variable
    # (cluster.rs:150-160: propagated state at p=0 equals the first op's
    # input on that variable). ``head_f`` maps each var to its first leg's
    # flat index, so the rebuild is one tiny [N, R] gather instead of the
    # old path-space gather + scatter.
    KM = K * M
    in_flat = new_inputs.reshape(KM, R)
    has_head = sg.head_f < KM
    first_val = _take0(in_flat, jnp.minimum(sg.head_f, KM - 1))  # [N, R]
    new_state = jnp.where(has_head.T, first_val.T, state)
    return new_ops, new_state
