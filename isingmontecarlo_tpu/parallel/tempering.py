"""Parallel tempering — reference ``src/sse/parallel_tempering/``.

The reference holds ``Vec<(QmcGraph, beta)>`` replicas and swaps *pointers*
between neighbors with acceptance
``p = (beta_a/beta_b)^(n_b - n_a) * W_rel(a under b) * W_rel(b under a)``
(``tempering_container.rs:274-302``), alternating even/odd neighbor pairs,
optionally running replicas on rayon threads (``:315-478``). For Ising graphs
the Hamiltonian-ratio term is computed in O(bonds) from per-bond op counters
(``tempering_traits.rs:117-155``).

Batched redesign (SURVEY.md sections 2 and 5): replicas are a batch axis
``R`` carrying per-replica inverse temperatures ``beta[R]`` and, optionally,
per-replica **per-bond Hamiltonian multipliers** ``scales[R, NB]`` (built
from per-class ``(J-scale, transverse-scale, longitudinal-scale)`` inputs —
the TFIM bond classes of ``qmc_ising.rs:186-205`` — or from arbitrary
per-bond coupling disorder via :meth:`TemperingContainer.add_qmc_stepper`).
A replica exchange swaps the parameter *labels* between two chains instead
of moving op-string payloads: states live in identical fixed shapes, so
exchanging labels is exactly equivalent and costs O(R) instead of O(R*M).
Neighbor pairs are adjacent ranks in beta-sorted order. The swap acceptance
in label space is

``log p = (n_b - n_a) log(beta_a/beta_b)
          + sum_bond (count_b - count_a) log(c_a/c_b)``

with per-bond op counts from the on-device bond counters — exactly the
reference's Ising ``relative_weight`` product ``prod_b (J'_b/J_b)^count(b)``
(``tempering_traits.rs:117-155``). The replica axis shards over a
`jax.sharding.Mesh` (see ``__graft_entry__.dryrun_multichip``); the only
cross-device traffic is the tiny ``(beta, n)`` vectors.

Per-bond multipliers only enter the *diagonal* update (as ``bond_scale``):
cluster, loop, and RVB acceptances use ratios of same-bond weights where a
per-bond-constant multiplier cancels, so a positive per-bond factor is the
exact label-swap representation of any same-sign coupling disorder. For
Hamiltonian differences with NO positive per-bond factor (sign flips), the
reference's op-walking ``OpWeights`` fallback (``tempering_traits.rs:
163-196``) maps to :func:`isingmontecarlo_tpu.sse.opstring.log_relative_weight`
+ ``QmcIsingGraph.swap_manager_and_state`` (see :func:`swap_qmc_steppers`).
"""

from __future__ import annotations

import functools
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from isingmontecarlo_tpu.sse import opstring as _ops
from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep, sweep

N_CLASSES = 3  # two-site, transverse, longitudinal (qmc_ising.rs:186-205)


def new_with_rng(seed: int = 0) -> "TemperingContainer":
    """Empty container for incremental filling (``new_with_rng``,
    ``tempering_container.rs:36-39``)."""
    return TemperingContainer.new(seed)


def new_thread_rng() -> "TemperingContainer":
    """Empty container seeded from OS entropy (``new_thread_rng``,
    ``tempering_container.rs:41-44``)."""
    import os

    return TemperingContainer.new(int.from_bytes(os.urandom(4), "little"))


def _canonical_edge_map(edges) -> dict:
    """Map ``(min(a,b), max(a,b)) -> J`` so edge *sets* compare independent
    of listing order."""
    m = {}
    for (a, b), j in edges:
        k = (min(a, b), max(a, b))
        if k in m:
            raise ValueError(f"duplicate edge {k}")
        m[k] = float(j)
    return m


def _ratio(a: float, b: float, what: str) -> float:
    if abs(a) < 1e-12 and abs(b) < 1e-12:
        return 1.0
    if abs(a) < 1e-12 or abs(b) < 1e-12 or (a > 0) != (b > 0):
        raise ValueError(
            f"no positive weight ratio for {what}: {a} vs {b} — a label swap "
            "cannot represent a sign flip (weight-table zeros move); use "
            "opstring.log_relative_weight + swap_manager_and_state instead"
        )
    return b / a


def _ratio_signed(a: float, b: float, what: str) -> tuple[float, int]:
    """(positive magnitude ratio, substate-XOR mask) such that ``q``'s
    weight table for this bond equals ``scale * base_table[: , s ^ mask]``:
    a sign flip on an Ising two-site or longitudinal bond permutes the
    table columns (``|J| ∓ J`` swaps aligned/anti — flip one leg's bit;
    ``qmc_ising.rs:863-888`` weight forms), so ``mask=1`` represents it
    exactly. Zero/nonzero mismatches stay unrepresentable."""
    if abs(a) < 1e-12 and abs(b) < 1e-12:
        return 1.0, 0
    if abs(a) < 1e-12 or abs(b) < 1e-12:
        raise ValueError(
            f"no weight correspondence for {what}: {a} vs {b} — zero and "
            "nonzero couplings have different weight-table supports"
        )
    return abs(b / a), 0 if (a > 0) == (b > 0) else 1


def _relative_bond_scales(base, q) -> np.ndarray:
    """Per-bond weight multipliers of ``q`` relative to ``base``:
    ``f32[NB]`` in the base graph's bond layout (``qmc_ising.rs:186-205``).

    A positive per-bond factor multiplies the bond's whole weight table
    (``|J| ± J`` scales linearly in ``|J|`` at fixed sign), so it cancels in
    the same-bond weight ratios of the cluster/loop/RVB acceptances and
    enters only the diagonal update and the swap acceptance — the per-bond
    Ising path of the reference (``tempering_traits.rs:117-155``). This
    accepts arbitrary same-sign coupling disorder (e.g. different disorder
    realizations of |J|); it raises ``ValueError`` when no positive factor
    exists (sign flip, zero/nonzero mismatch, different edge sets)."""
    scale, xor = _relative_bond_params(base, q)
    if xor.any():
        flipped = int(xor.sum())
        raise ValueError(
            f"no positive weight ratio: {flipped} bond(s) flip coupling sign "
            "— a pure label swap cannot represent a sign flip (weight-table "
            "zeros move); the container's signed path (bond_xor masks + "
            "op-resolved swap acceptance) handles it"
        )
    return scale


def _relative_bond_params(base, q) -> tuple[np.ndarray, np.ndarray]:
    """Per-bond (positive multiplier, substate-XOR mask) of ``q`` relative
    to ``base`` — the general label of the signed tempering path:
    ``w_q(b, s) = scale[b] * w_base(b, s ^ xor[b])`` exactly (see
    :func:`_ratio_signed`). Transverse sign flips stay errors: the
    transverse table is substate-constant (``qmc_ising.rs:869-877``), so
    no permutation represents them."""
    mb = _canonical_edge_map(base.edges)
    mq = _canonical_edge_map(q.edges)
    if set(mb) != set(mq):
        raise ValueError("graphs must share the edge set")
    ne = len(base.edges)
    n = base.nvars
    nb = base.model.nbonds
    scale = np.ones(nb, np.float32)
    xor = np.zeros(nb, np.int32)
    for i, ((a, b), jb) in enumerate(base.edges):
        k = (min(a, b), max(a, b))
        scale[i], xor[i] = _ratio_signed(jb, mq[k], f"edge {k} coupling")
    scale[ne : ne + n] = _ratio(
        base.transverse, q.transverse, "transverse field"
    )
    if nb > ne + n:
        scale[ne + n :], xor[ne + n :] = _ratio_signed(
            base.longitudinal, q.longitudinal, "longitudinal field"
        )
    elif abs(base.longitudinal - q.longitudinal) > 1e-12:
        raise ValueError("longitudinal fields differ but base has no h bonds")
    return scale, xor


def tfim_bond_classes(nedges: int, nvars: int, nbonds: int) -> jax.Array:
    """i32[NB] class id per bond for the TFIM layout."""
    cls = np.full(nbonds, 2, np.int32)
    cls[:nedges] = 0
    cls[nedges : nedges + nvars] = 1
    return jnp.asarray(cls)


def _pair_starts(rank: jax.Array, parity: jax.Array, R: int) -> jax.Array:
    """Rank-space mask of pair-start ranks for one alternating-parity
    neighbor-swap sweep (``swap_on_chunks``, ``tempering_container.rs:274-302``)."""
    return ((rank - parity) % 2 == 0) & (rank >= parity) & (rank + 1 < R)


def candidate_partner(betas: jax.Array, parity: jax.Array) -> jax.Array:
    """Replica-space candidate-partner map for this swap sweep: ``cpart[r]``
    is the replica whose labels replica ``r`` would take if its pair
    accepts (identity for unpaired ranks). Pairing is fixed by rank parity
    alone, before any acceptance draw — every replica can evaluate its
    prospective partner's labels locally (used by the sharded chunk's
    op-resolved swap path)."""
    R = betas.shape[0]
    order = jnp.argsort(betas)
    rank = jnp.arange(R, dtype=jnp.int32)
    is_start = _pair_starts(rank, parity, R)
    is_prev = jnp.roll(is_start, 1) & (rank > 0)
    cand_rank = jnp.where(
        is_start, rank + 1, jnp.where(is_prev, rank - 1, rank)
    )
    return jnp.zeros((R,), jnp.int32).at[order].set(order[cand_rank])


@jax.jit
def tempering_step(
    n: jax.Array,  # i32[R] op counts
    betas: jax.Array,  # f32[R]
    key: jax.Array,
    parity: jax.Array,  # 0: pairs (0,1),(2,3)...; 1: pairs (1,2),(3,4)...
    n_class: jax.Array | None = None,  # i32[R, NB] per-bond op counts
    log_c: jax.Array | None = None,  # f32[R, NB] log bond multipliers
    ops=None,  # OpString — signed path only
    model=None,  # BondModel — signed path only
    scales: jax.Array | None = None,  # f32[R, NB] — signed path only
    xors: jax.Array | None = None,  # i32[R, NB] — signed path only
    delta: jax.Array | None = None,  # f32[R] precomputed op-walk deltas
    blocked: jax.Array | None = None,  # bool[R] zero-weight-under-swap
) -> tuple[jax.Array, jax.Array]:
    """One neighbor-swap sweep. Returns ``(perm i32[R], n_swaps)`` where
    ``perm[r]`` is the replica whose parameter labels replica ``r`` takes
    (identity where no swap), mirroring ``swap_on_chunks``
    (``tempering_container.rs:274-302``). ``parity`` may be a traced scalar
    so alternating sweeps compose inside a ``lax.scan``
    (:func:`tempering_sweep_chunk`). ``n_class``/``log_c`` work for any
    per-replica count/log-multiplier table sharing a trailing axis — the
    container passes per-*bond* tables (``tempering_traits.rs:117-155``).

    Signed ladders (``xors`` given) use the op-resolved acceptance instead:
    one fused ``[M, R]`` pass (:func:`opstring.log_weight_delta`) evaluates
    every op's weight under its own and its candidate partner's label —
    the batched analog of the reference's ``OpWeights`` op walk
    (``tempering_traits.rs:163-196``); pairs whose strings have zero weight
    under the exchanged labels are rejected. Pass either ``n_class`` or
    ``xors``, not both: the delta already includes the scale term."""
    R = betas.shape[0]
    order = jnp.argsort(betas)  # ascending beta, rank -> replica
    b_sorted = betas[order]
    n_sorted = n[order].astype(jnp.float32)

    rank = jnp.arange(R, dtype=jnp.int32)
    is_start = _pair_starts(rank, parity, R)

    b_next = jnp.roll(b_sorted, -1)
    n_next = jnp.roll(n_sorted, -1)
    # log p at pair-start ranks: (n_b - n_a)(log beta_a - log beta_b)
    logp = (n_next - n_sorted) * (
        jnp.log(jnp.maximum(b_sorted, 1e-30)) - jnp.log(jnp.maximum(b_next, 1e-30))
    )
    if n_class is not None:
        nc_sorted = n_class[order].astype(jnp.float32)  # [R, C]
        lc_sorted = log_c[order]  # [R, C]
        nc_next = jnp.roll(nc_sorted, -1, axis=0)
        lc_next = jnp.roll(lc_sorted, -1, axis=0)
        logp = logp + jnp.sum(
            (nc_next - nc_sorted) * (lc_sorted - lc_next), axis=1
        )
    blocked_pair = jnp.zeros((R,), bool)
    if xors is not None and delta is None:
        # Candidate pairing is fixed by rank parity alone (acceptance comes
        # after), so every replica knows its prospective partner's label.
        cpart = candidate_partner(betas, parity)
        delta, blocked = _ops.log_weight_delta(
            ops, model, scales, xors, scales[cpart], xors[cpart]
        )
    if delta is not None:
        if blocked is None:
            blocked = jnp.zeros((R,), bool)
        d_sorted = delta[order]
        blk_sorted = blocked[order]
        logp = logp + d_sorted + jnp.roll(d_sorted, -1)
        blocked_pair = blk_sorted | jnp.roll(blk_sorted, -1)
    u = jax.random.uniform(key, (R,))
    accept_start = (
        is_start & ~blocked_pair & (jnp.log(jnp.maximum(u, 1e-30)) < logp)
    )
    accept_from_prev = jnp.roll(accept_start, 1) & (rank > 0)

    partner_rank = jnp.where(
        accept_start, rank + 1, jnp.where(accept_from_prev, rank - 1, rank)
    )
    # perm in replica space: replica order[rank] takes labels of
    # replica order[partner_rank].
    perm = jnp.zeros((R,), jnp.int32).at[order].set(order[partner_rank])
    return perm, jnp.sum(accept_start.astype(jnp.int32))


def swap_qmc_steppers(g_a, beta_a: float, g_b, beta_b: float, key) -> int:
    """Metropolis swap attempt between two arbitrary :class:`QmcIsingGraph`
    ensembles — the generic ``OpWeights`` fallback for Hamiltonian pairs
    with NO label-swap representation (e.g. sign-flipped bonds): the
    reference walks every op (``tempering_traits.rs:163-196``) and swaps
    manager+state pointers (``swap_on_chunks``,
    ``tempering_container.rs:274-302``; ``qmc_ising.rs:593-602``).

    Per replica lane ``r`` the acceptance is

    ``log p = (n_b - n_a) log(beta_a/beta_b)
              + log W(a's string | H_b)/W(a's string | H_a)
              + log W(b's string | H_a)/W(b's string | H_b)``

    with the relative weights from one op-walk each
    (:func:`~isingmontecarlo_tpu.sse.opstring.log_relative_weight`); accepted
    lanes exchange their (op string, p=0 state) payloads in place. Returns
    the number of swapped replicas."""
    assert g_a.can_swap_managers(g_b), "graph shapes do not match"
    m = max(g_a.cutoff, g_b.cutoff)
    g_a.set_cutoff(m)
    g_b.set_cutoff(m)
    ops_a, ops_b = g_a.sse.ops, g_b.sse.ops
    n_a = _ops.op_count(ops_a).astype(jnp.float32)
    n_b = _ops.op_count(ops_b).astype(jnp.float32)
    lw_ab, z_ab = _ops.log_relative_weight(ops_a, g_a.model, g_b.model)
    lw_ba, z_ba = _ops.log_relative_weight(ops_b, g_b.model, g_a.model)
    logp = (
        (n_b - n_a) * (np.log(max(beta_a, 1e-30)) - np.log(max(beta_b, 1e-30)))
        + lw_ab
        + lw_ba
    )
    u = jax.random.uniform(key, n_a.shape)
    acc = (~z_ab) & (~z_ba) & (jnp.log(jnp.maximum(u, 1e-30)) < logp)

    def mix(a, b, lane_axis):
        shape = [1] * a.ndim
        shape[lane_axis] = a.shape[lane_axis]
        msk = acc.reshape(shape)
        return jnp.where(msk, b, a), jnp.where(msk, a, b)

    bond_a, bond_b = mix(ops_a.bond, ops_b.bond, 1)
    in_a, in_b = mix(ops_a.inputs, ops_b.inputs, 2)
    out_a, out_b = mix(ops_a.outputs, ops_b.outputs, 2)
    st_a, st_b = mix(g_a.sse.state, g_b.sse.state, 0)
    g_a.sse = g_a.sse._replace(
        ops=type(ops_a)(bond=bond_a, inputs=in_a, outputs=out_a), state=st_a
    )
    g_b.sse = g_b.sse._replace(
        ops=type(ops_b)(bond=bond_b, inputs=in_b, outputs=out_b), state=st_b
    )
    return int(jnp.sum(acc.astype(jnp.int32)))


@functools.partial(
    jax.jit,
    static_argnames=(
        "nsweeps", "heatbath", "hetero", "collect_states", "cluster_caps",
    ),
)
def tempering_sweep_chunk(
    sse,
    betas: jax.Array,  # f32[R]
    scales: jax.Array,  # f32[R, NB] per-bond multipliers
    parity: jax.Array,  # i32[] swap parity at chunk entry
    do_swap: jax.Array,  # bool[T] swap after this sweep?
    model,
    nsweeps: int,
    hb=None,
    heatbath: bool = False,
    hetero: bool = False,
    collect_states: bool = False,
    cluster_caps: tuple[int, int] | None = None,
    xors: jax.Array | None = None,  # i32[R, NB] sign-pattern labels
):
    """``nsweeps`` tempering steps under ONE jit: each scan iteration runs a
    full QMC sweep at every replica's own (beta, scales) label, then — on
    sweeps flagged in ``do_swap`` — an alternating-parity neighbor swap that
    permutes the labels (and, for heterogeneous ladders, the per-replica
    heat-bath tables) device-side.

    This fuses the reference's interleaved run/swap driver
    (``tempering_container.rs:411-478``) the way its rayon threads never
    could: no host round trip between a sweep and its swap. Swap keys derive
    from the sweep key chain. Returns
    ``(sse, betas, scales, xors, hb, parity, nswaps, ns[T, R], states,
    betas_t)`` where ``states``/``betas_t`` are per-sweep samples (None
    unless ``collect_states``).

    Signed ladders pass ``xors`` (per-replica sign-pattern labels, see
    ``diagonal._xor_si``): sweeps then apply the masks per lane, swaps use
    the op-resolved acceptance (:func:`tempering_step` signed path), and
    the masks ride the label permutation — mixed-sign Hamiltonians temper
    inside ONE container+jit, where the reference drops to its pointer-swap
    op walk (``tempering_traits.rs:163-196``).
    """
    R = betas.shape[0]
    ident = jnp.arange(R, dtype=jnp.int32)

    def body(carry, do_swap_t):
        sse, betas, scales_c, xors_c, hb_c, parity, nswaps = carry
        bond_scale = scales_c if hetero else None
        new, _succ = sweep(
            sse, betas, model, hb=hb_c, heatbath=heatbath,
            bond_scale=bond_scale, cluster_caps=cluster_caps,
            bond_xor=xors_c,
        )
        k_next, k_swap = jax.random.split(new.key)
        new = new._replace(key=k_next)
        n = _ops.op_count(new.ops)
        if xors_c is not None:
            # Signed ladder: op-resolved acceptance (scale term included).
            n_bond = log_c = None
            perm, nsw = tempering_step(
                n, betas, k_swap, parity,
                ops=new.ops, model=model, scales=scales_c, xors=xors_c,
            )
        else:
            if hetero:
                n_bond = _ops.bond_counts(new.ops, model.nbonds)
                log_c = jnp.log(jnp.maximum(scales_c, 1e-30))
            else:
                n_bond = log_c = None
            perm, nsw = tempering_step(
                n, betas, k_swap, parity, n_bond, log_c
            )
        perm = jnp.where(do_swap_t, perm, ident)
        betas = betas[perm]
        if hetero:
            scales_c = scales_c[perm]
        if xors_c is not None:
            xors_c = xors_c[perm]
        if heatbath and hb_c is not None and hb_c.cum_max_w.ndim == 2:
            hb_c = type(hb_c)(
                cum_max_w=hb_c.cum_max_w[perm], total=hb_c.total[perm]
            )
        parity = jnp.where(do_swap_t, 1 - parity, parity)
        nswaps = nswaps + jnp.where(do_swap_t, nsw, 0)
        out = (n, new.state if collect_states else None,
               betas if collect_states else None)
        return (new, betas, scales_c, xors_c, hb_c, parity, nswaps), out

    carry0 = (sse, betas, scales, xors, hb, jnp.asarray(parity, jnp.int32),
              jnp.int32(0))
    (sse, betas, scales, xors, hb, parity, nswaps), (ns, states, betas_t) = (
        jax.lax.scan(body, carry0, do_swap, length=nsweeps)
    )
    return (sse, betas, scales, xors, hb, parity, nswaps, ns, states,
            betas_t)


@functools.lru_cache(maxsize=32)
def _sharded_chunk_fn(
    mesh, axis_name: str, nsweeps: int, heatbath: bool, hetero: bool,
    collect_states: bool, cluster_caps, signed: bool, hb_kind: str,
    debug_rep_check: bool = False,
):
    """Build (and cache) the jitted ``shard_map`` tempering chunk for one
    static configuration. See :func:`tempering_sweep_chunk_sharded`."""
    from jax.sharding import PartitionSpec as P

    ax = axis_name  # str, or tuple of names (replica dim over several axes)
    ax_names = (ax,) if isinstance(ax, str) else tuple(ax)

    def chunk(sse, betas, scales, xors, hb, parity, do_swap, model):
        # Linear device position along the (possibly multi-axis) replica
        # sharding, major-to-minor in tuple order — matches P(ax)'s layout.
        idx = jax.lax.axis_index(ax_names[0])
        for name in ax_names[1:]:
            idx = idx * jax.lax.axis_size(name) + jax.lax.axis_index(name)
        R_l = betas.shape[0]
        base_key = sse.key  # replicated: every device holds the same key
        lo = idx * R_l

        def gather(x):
            return jax.lax.all_gather(x, ax_names, axis=0, tiled=True)

        def body(carry, xs):
            t, do_swap_t = xs
            sse_c, betas_c, scales_c, xors_c, hb_c, parity, nswaps = carry
            # Per-sweep keys derive from the replicated chunk key: the swap
            # draw must be IDENTICAL on every device (perm is computed
            # redundantly), while sweep randomness must DIFFER per device —
            # fold the mesh position in for the sweep only. This gives a
            # different (equally valid) stream than the unsharded chunk.
            key_t = jax.random.fold_in(base_key, t)
            k_sweep = jax.random.fold_in(jax.random.fold_in(key_t, 0), idx)
            k_swap = jax.random.fold_in(key_t, 1)
            new, _succ = sweep(
                sse_c._replace(key=k_sweep), betas_c, model, hb=hb_c,
                heatbath=heatbath,
                bond_scale=scales_c if hetero else None,
                cluster_caps=cluster_caps, bond_xor=xors_c,
            )
            new = new._replace(key=key_t)  # keep the key leaf replicated
            n_l = _ops.op_count(new.ops)
            # Swap traffic: the per-replica label vectors only — n[R] and
            # betas[R] always; the [R, NB] label tables when the ladder is
            # heterogeneous or signed (they ARE the swapped labels then).
            n_g = gather(n_l)
            betas_g = gather(betas_c)
            scales_g = gather(scales_c) if (hetero or signed) else None
            xors_g = gather(xors_c) if signed else None
            if signed:
                # Op-resolved acceptance, computed replica-LOCALLY against
                # the gathered partner labels; only the per-replica scalar
                # deltas cross devices.
                cpart_l = jax.lax.dynamic_slice(
                    candidate_partner(betas_g, parity), (lo,), (R_l,)
                )
                d_l, blk_l = _ops.log_weight_delta(
                    new.ops, model, scales_c, xors_c,
                    scales_g[cpart_l], xors_g[cpart_l],
                )
                perm, nsw = tempering_step(
                    n_g, betas_g, k_swap, parity,
                    delta=gather(d_l), blocked=gather(blk_l),
                )
            elif hetero:
                nb_g = gather(_ops.bond_counts(new.ops, model.nbonds))
                log_c = jnp.log(jnp.maximum(scales_g, 1e-30))
                perm, nsw = tempering_step(
                    n_g, betas_g, k_swap, parity, nb_g, log_c
                )
            else:
                perm, nsw = tempering_step(n_g, betas_g, k_swap, parity)
            perm = jnp.where(do_swap_t, perm, jnp.arange(perm.shape[0],
                                                         dtype=jnp.int32))
            take = jax.lax.dynamic_slice(perm, (lo,), (R_l,))
            betas_c = betas_g[take]
            if hetero or signed:
                scales_c = scales_g[take]
            if signed:
                xors_c = xors_g[take]
            if hb_kind == "per_replica":
                hb_g = type(hb_c)(
                    cum_max_w=gather(hb_c.cum_max_w), total=gather(hb_c.total)
                )
                hb_c = type(hb_c)(
                    cum_max_w=hb_g.cum_max_w[take], total=hb_g.total[take]
                )
            parity = jnp.where(do_swap_t, 1 - parity, parity)
            nswaps = nswaps + jnp.where(do_swap_t, nsw, 0)
            out = (n_l, new.state if collect_states else None,
                   betas_c if collect_states else None)
            return (new, betas_c, scales_c, xors_c, hb_c, parity, nswaps), out

        carry0 = (sse, betas, scales, xors, hb,
                  jnp.asarray(parity, jnp.int32), jnp.int32(0))
        xs = (jnp.arange(nsweeps, dtype=jnp.int32), do_swap)
        (sse, betas, scales, xors, hb, parity, nswaps), (
            ns, states, betas_t
        ) = jax.lax.scan(body, carry0, xs, length=nsweeps)
        # Advance the replicated key past every per-sweep stream.
        sse = sse._replace(key=jax.random.fold_in(base_key, nsweeps))
        outs = (sse, betas, scales, xors, hb, parity, nswaps, ns, states,
                betas_t)
        if debug_rep_check:
            # Replication-invariant fingerprint (``check_vma=False`` disables
            # the static check): every value computed redundantly per device
            # from replicated inputs — swap count, parity, advanced key —
            # broadcast along the local replica rows with a P(ax, None) out
            # spec. Outside, the [R, 3] rows are identical iff every device
            # really did compute the same replicated values (tested on the
            # CPU mesh; see tests/test_tempering_sharded.py).
            fp = jnp.stack([
                nswaps.astype(jnp.float32),
                parity.astype(jnp.float32),
                jnp.sum(jax.random.key_data(sse.key).astype(jnp.float32)),
            ])
            outs = outs + (jnp.broadcast_to(fp, (R_l, 3)),)
        return outs

    rep = P()
    sse_spec_t = {
        "ops": {"bond": P(None, ax), "inputs": P(None, None, ax),
                "outputs": P(None, None, ax)},
        "state": P(ax, None), "key": rep,
    }

    def sse_spec(tmpl):
        return type(tmpl)(
            ops=type(tmpl.ops)(**sse_spec_t["ops"]),
            state=sse_spec_t["state"], key=sse_spec_t["key"],
        )

    def specs(sse, scales, xors, hb):
        sp_scales = P(ax, None)
        sp_xors = P(ax, None) if xors is not None else rep
        if hb is None:
            sp_hb = rep
        elif hb_kind == "per_replica":
            sp_hb = type(hb)(cum_max_w=P(ax, None), total=P(ax))
        else:
            sp_hb = type(hb)(cum_max_w=rep, total=rep)
        in_specs = (sse_spec(sse), P(ax), sp_scales, sp_xors, sp_hb, rep,
                    rep, rep)
        out_specs = (
            sse_spec(sse), P(ax), sp_scales, sp_xors, sp_hb, rep, rep,
            P(None, ax),
            P(None, ax, None) if collect_states else rep,
            P(None, ax) if collect_states else rep,
        )
        if debug_rep_check:
            out_specs = out_specs + (P(ax, None),)
        return in_specs, out_specs

    def run(sse, betas, scales, xors, hb, parity, do_swap, model):
        in_specs, out_specs = specs(sse, scales, xors, hb)
        f = jax.shard_map(
            chunk, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
            check_vma=False,
        )
        return f(sse, betas, scales, xors, hb, parity, do_swap, model)

    return jax.jit(run)


def tempering_sweep_chunk_sharded(
    sse,
    betas: jax.Array,
    scales: jax.Array,
    parity: jax.Array,
    do_swap: jax.Array,
    model,
    nsweeps: int,
    *,
    mesh,
    axis_name: str = "replicas",
    hb=None,
    heatbath: bool = False,
    hetero: bool = False,
    collect_states: bool = False,
    cluster_caps: tuple[int, int] | None = None,
    xors: jax.Array | None = None,
    debug_rep_check: bool = False,
):
    """:func:`tempering_sweep_chunk` under an explicit ``jax.shard_map``
    over ``mesh``'s ``axis_name`` axis: every sweep op is forced
    replica-local, so the only cross-device traffic per tempering iteration
    is the label vectors the swap actually exchanges — ``n[R]``/``beta[R]``
    always, plus the ``[R, NB]`` label tables (scales/xors/heat-bath rows)
    on heterogeneous or signed ladders. Under plain GSPMD the same program
    all-gathers ``[S, R]`` cluster-label intermediates (measured 196 KB vs
    a 16 KB yardstick at the audit shape — ``scripts/collectives_audit.py``),
    which this wrapper eliminates by construction.

    RNG: sweep randomness folds the device index into the per-sweep key, so
    replicas draw independent (device-count-dependent) streams — results
    are statistically equivalent to, but not bit-identical with, the
    unsharded chunk. The swap draw uses the replicated key so every device
    computes the identical permutation redundantly (no communication).

    Requires ``R % mesh.devices.size == 0``. The reference's analog is the
    rayon thread pool (``tempering_container.rs:315-478``); this is its
    device-mesh equivalent per SURVEY.md §2's parallelism inventory."""
    R = betas.shape[0]
    names = (axis_name,) if isinstance(axis_name, str) else tuple(axis_name)
    ndev = int(np.prod([mesh.shape[n] for n in names]))
    if R % ndev:
        raise ValueError(f"replicas {R} not divisible by mesh size {ndev}")
    if not isinstance(axis_name, str):
        axis_name = names  # hashable for the lru_cache key
    signed = xors is not None
    if hb is None:
        hb_kind = "none"
    elif hb.cum_max_w.ndim == 2:
        hb_kind = "per_replica"
    else:
        hb_kind = "shared"
    fn = _sharded_chunk_fn(
        mesh, axis_name, nsweeps, heatbath, hetero, collect_states,
        cluster_caps, signed, hb_kind, debug_rep_check,
    )
    return fn(sse, betas, scales, xors, hb, parity, do_swap, model)


class TemperingContainer:
    """Batched parallel tempering over a :class:`QmcIsingGraph` ensemble.

    Mirrors ``TemperingContainer`` / ``ParallelQmcTimeSteps``
    (``tempering_container.rs:53-238, 315-478``): all replicas advance
    together (the rayon-thread variant *is* the batch axis here), neighbor
    swaps alternate parity, and sampled states can be grouped by temperature.

    Heterogeneous ladders: pass per-beta ``transverse_scales`` /
    ``coupling_scales`` / ``longitudinal_scales`` to temper in field or
    coupling space as well; swaps then exchange the whole parameter label
    (the reference's distinct-Hamiltonian graphs, ``tempering_traits.rs``).
    """

    def __init__(
        self,
        edges,
        transverse: float,
        longitudinal: float = 0.0,
        *,
        betas: Sequence[float],
        replicas_per_beta: int = 1,
        seed: int = 0,
        transverse_scales: Sequence[float] | None = None,
        coupling_scales: Sequence[float] | None = None,
        longitudinal_scales: Sequence[float] | None = None,
    ):
        betas = np.asarray(betas, dtype=np.float32)
        R = len(betas) * replicas_per_beta
        self.graph = QmcIsingGraph(
            edges, transverse, longitudinal, replicas=R, seed=seed
        )
        self.betas = jnp.asarray(np.repeat(betas, replicas_per_beta))

        def expand(x):
            if x is None:
                return None
            x = np.asarray(x, np.float32)
            assert x.shape == betas.shape, "one scale per beta"
            return np.repeat(x, replicas_per_beta)

        ts = expand(transverse_scales)
        cs = expand(coupling_scales)
        ls = expand(longitudinal_scales)
        self.hetero = any(s is not None for s in (ts, cs, ls))
        ones = np.ones(R, np.float32)
        per_class = np.stack(
            [cs if cs is not None else ones,
             ts if ts is not None else ones,
             ls if ls is not None else ones], axis=1
        )  # [R, 3]: class 0 = two-site, 1 = transverse, 2 = longitudinal
        m = self.graph.model
        cls = np.asarray(tfim_bond_classes(len(edges), m.nvars, m.nbonds))
        # Per-bond multipliers [R, NB] (class scales expanded; arbitrary
        # per-bond disorder enters via add_qmc_stepper).
        self.scales = jnp.asarray(per_class[:, cls])
        self.xors = None  # i32[R, NB] sign-pattern labels (signed ladders)
        self._parity = 0
        self.total_swaps = 0
        self._key = jax.random.key(seed + 0x7E47)
        self._heatbath = False
        self._hb = None
        self._mesh = None  # set by shard_over: mesh for the sharded chunk
        self._mesh_axis = "replicas"
        self._pending = None  # incremental graphs live only on `new()` builders

    # -- incremental construction (tempering_container.rs:53-74) ------------

    @classmethod
    def new(cls, seed: int = 0) -> "TemperingContainer":
        """Empty container to be filled with :meth:`add_qmc_stepper`
        (``TemperingContainer::new``, ``tempering_container.rs:53-61``)."""
        self = object.__new__(cls)
        self._pending = []
        self._seed = int(seed)
        self.graph = None
        self.betas = None
        self.hetero = False
        self.xors = None
        self._parity = 0
        self.total_swaps = 0
        self._heatbath = False
        self._hb = None
        self._mesh = None
        self._mesh_axis = "replicas"
        return self

    def add_qmc_stepper(self, q: QmcIsingGraph, beta: float) -> None:
        """Append a graph at inverse temperature ``beta``
        (``add_qmc_stepper``, ``tempering_container.rs:65-74``). Raises
        ``ValueError`` where the reference returns ``Err``: incompatible
        shapes, different edge sets, or zero/nonzero coupling mismatches.
        Arbitrary same-sign per-bond coupling disorder is accepted via
        per-*bond* multiplier labels — the reference's Ising
        ``relative_weight`` path (``tempering_traits.rs:117-155``) — and
        **mixed-sign couplings** (±J disorder) are accepted too, as
        substate-XOR labels driving the op-resolved swap acceptance — the
        batched form of the reference's generic ``OpWeights`` op walk
        (``tempering_traits.rs:163-196``)."""
        if self._pending is None or self.graph is not None:
            raise ValueError("container already materialized; add graphs first")
        if self._pending:
            base = self._pending[0][0]
            if q.nvars != base.nvars or q.model.nbonds != base.model.nbonds:
                raise ValueError("graph shapes do not match the ladder")
            _relative_bond_params(base, q)  # raises when not representable
        self._pending.append((q, float(beta)))

    def _finalize(self) -> None:
        """Materialize graphs added via :meth:`add_qmc_stepper` into the
        batched replica-axis form (states stacked, op strings grown to the
        max cutoff and concatenated — the reference syncs cutoffs before
        swapping too, ``tempering_container.rs:129-137``)."""
        if self._pending is None:
            return
        if not self._pending:
            raise ValueError("no graphs added to the tempering container")
        pend, self._pending = self._pending, None
        base = pend[0][0]
        R = sum(q.replicas for q, _ in pend)
        max_m = max(q.cutoff for q, _ in pend)
        state = np.concatenate([np.asarray(q.sse.state) for q, _ in pend])
        g = QmcIsingGraph(
            base.edges, base.transverse, base.longitudinal, max_m,
            replicas=R, seed=self._seed, state=state,
        )
        grown = [_ops.grow(q.sse.ops, max_m) for q, _ in pend]
        g.sse = g.sse._replace(
            ops=type(grown[0])(
                bond=jnp.concatenate([o.bond for o in grown], axis=1),
                inputs=jnp.concatenate([o.inputs for o in grown], axis=2),
                outputs=jnp.concatenate([o.outputs for o in grown], axis=2),
            )
        )
        g._growth_pending = True
        g._growth_stable = 0
        self.graph = g
        self.betas = jnp.asarray(
            np.concatenate([np.full(q.replicas, b, np.float32) for q, b in pend])
        )
        params = [_relative_bond_params(base, q) for q, _ in pend]
        sc = np.concatenate(
            [np.tile(s[None], (q.replicas, 1))
             for (q, _), (s, _) in zip(pend, params)]
        )  # [R, NB]
        xr = np.concatenate(
            [np.tile(x[None], (q.replicas, 1))
             for (q, _), (_, x) in zip(pend, params)]
        )  # [R, NB]
        self.hetero = bool(np.max(np.abs(sc - 1.0)) > 1e-12)
        self.scales = jnp.asarray(sc)
        self.xors = jnp.asarray(xr) if xr.any() else None
        self._key = jax.random.key(self._seed + 0x7E47)
        if self._heatbath:
            self.set_enable_heatbath(True)

    @property
    def rng_key(self) -> jax.Array:
        """The container's PRNG key (``rng_mut``, ``tempering_container.rs:236``)."""
        return self._key

    @rng_key.setter
    def rng_key(self, key) -> None:
        self._key = key

    def set_enable_heatbath(self, enable: bool) -> None:
        """Heat-bath diagonal updates for the whole ladder
        (``set_enable_heatbath``, ``qmc_ising.rs:444-486``). Heterogeneous
        ladders get per-replica cumulative bond-weight tables — the
        reference's per-graph ``BondWeights``."""
        from isingmontecarlo_tpu.sse import diagonal as _diag

        self._heatbath = enable
        if self._pending is not None:
            return  # deferred until the added graphs are materialized
        if enable:
            self._hb = _diag.make_heatbath_tables(
                self.graph.model, self._bond_scale()
            )
        else:
            self._hb = None

    @property
    def replicas(self) -> int:
        self._finalize()
        return self.graph.replicas

    def _split(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def _bond_scale(self) -> jax.Array | None:
        return self.scales if self.hetero else None  # [R, NB]

    @property
    def class_scales(self) -> np.ndarray:
        """``f32[R, 3]`` (coupling, transverse, longitudinal) multipliers,
        read at a representative bond of each TFIM class — meaningful for
        class-proportional ladders (the general state is per-bond
        ``self.scales``)."""
        self._finalize()
        m = self.graph.model
        ne = len(self.graph.edges)
        n = m.nvars
        sc = np.asarray(self.scales)
        ones = np.ones(sc.shape[0], np.float32)
        cs = sc[:, 0] if ne > 0 else ones
        ts = sc[:, ne]
        ls = sc[:, ne + n] if m.nbonds > ne + n else ones
        return np.stack([cs, ts, ls], axis=1)

    # -- mirrors tempering_container.rs:77-81 ------------------------------
    def timesteps(self, t: int, chunk: int = 16) -> None:
        """Advance every replica ``t`` sweeps at its own temperature.

        Starts in a per-step growth phase (see
        ``QmcIsingGraph.timesteps_measure``): a cold cutoff left truncated
        for a whole chunk biases the ensemble toward low op counts."""
        self._finalize()
        done = 0
        g = self.graph
        stable = 2 if not g._growth_pending else g._growth_stable
        while done < t:
            todo = 1 if stable < 2 else min(chunk, t - done)
            g.sse, _, _, _ = multi_sweep(
                g.sse,
                self.betas,
                g.model,
                todo,
                hb=self._hb,
                heatbath=self._heatbath,
                bond_scale=self._bond_scale(),
                cluster_caps=g._cluster_caps,
                bond_xor=self.xors,
            )
            done += todo
            before = g.cutoff
            g._maybe_grow()
            stable = 0 if g.cutoff != before else stable + 1
        g._growth_stable = stable
        g._growth_pending = stable < 2

    # -- mirrors tempering_container.rs:121-163 ----------------------------
    def tempering_step(self) -> int:
        """One alternating-parity neighbor-swap sweep; returns swap count."""
        self._finalize()
        n = _ops.op_count(self.graph.sse.ops)
        if self.xors is not None:
            perm, swaps = tempering_step(
                n, self.betas, self._split(), self._parity,
                ops=self.graph.sse.ops, model=self.graph.model,
                scales=self.scales, xors=self.xors,
            )
            self.xors = self.xors[perm]
        else:
            if self.hetero:
                n_bond = _ops.bond_counts(
                    self.graph.sse.ops, self.graph.model.nbonds
                )
                log_c = jnp.log(jnp.maximum(self.scales, 1e-30))
            else:
                n_bond = log_c = None
            perm, swaps = tempering_step(
                n, self.betas, self._split(), self._parity, n_bond, log_c
            )
        self.betas = self.betas[perm]
        if self.hetero:
            self.scales = self.scales[perm]
            if self._hb is not None:  # per-replica tables follow their labels
                self._hb = type(self._hb)(
                    cum_max_w=self._hb.cum_max_w[perm],
                    total=self._hb.total[perm],
                )
        self._parity = 1 - self._parity
        self.total_swaps += int(swaps)
        return int(swaps)

    # -- mirrors tempering_container.rs:166-208 / :411-451 -----------------
    def timesteps_sample(
        self,
        t: int,
        swap_freq: int = 1,
        sampling_freq: int | None = None,
        chunk: int = 32,
    ):
        """Interleave sweeps, swaps, and state sampling.

        Returns ``(states bool[S, R, N], betas_at_sample f32[S, R])`` so
        samples can be grouped by temperature afterwards.

        After the cold-start growth phase (per-step dispatches while the
        cutoff still grows) the whole run/swap/sample loop executes in
        jit-fused chunks of ``chunk`` sweeps (:func:`tempering_sweep_chunk`)
        — one host dispatch per chunk instead of one per sweep, the batched
        answer to the reference's rayon driver
        (``tempering_container.rs:411-478``)."""
        self._finalize()
        freq = sampling_freq or 1
        g = self.graph
        states, bet = [], []
        step = 0
        # Growth phase: single-sweep dispatches so the cutoff can track
        # n + n/2 after every timestep (see QmcIsingGraph.timesteps_measure).
        while step < t and g._growth_pending:
            self.timesteps(1, chunk=1)
            if (step + 1) % swap_freq == 0:
                self.tempering_step()
            if (step + 1) % freq == 0:
                states.append(np.asarray(g.sse.state))
                bet.append(np.asarray(self.betas))
            step += 1
        while step < t:
            todo = min(chunk, t - step)
            do_swap = jnp.asarray(
                [(step + i + 1) % swap_freq == 0 for i in range(todo)]
            )
            samp = [(step + i + 1) % freq == 0 for i in range(todo)]
            kw = dict(
                hb=self._hb, heatbath=self._heatbath, hetero=self.hetero,
                collect_states=any(samp), cluster_caps=g._cluster_caps,
                xors=self.xors,
            )
            if self._mesh is not None:
                # shard_map over the mesh replica axis: collective traffic
                # is the label vectors only (scripts/collectives_audit.py).
                (g.sse, self.betas, self.scales, self.xors, hb, parity,
                 nswaps, _ns, st, bt) = tempering_sweep_chunk_sharded(
                    g.sse, self.betas, self.scales, self._parity, do_swap,
                    g.model, todo, mesh=self._mesh,
                    axis_name=self._mesh_axis, **kw,
                )
            else:
                (g.sse, self.betas, self.scales, self.xors, hb, parity,
                 nswaps, _ns, st, bt) = tempering_sweep_chunk(
                    g.sse, self.betas, self.scales, self._parity, do_swap,
                    g.model, todo, **kw,
                )
            if self._hb is not None:
                self._hb = hb
            self._parity = int(parity)
            self.total_swaps += int(nswaps)
            if any(samp):
                st = np.asarray(st)
                bt = np.asarray(bt)
                for i, s in enumerate(samp):
                    if s:
                        states.append(st[i])
                        bet.append(bt[i])
            step += todo
            g._maybe_grow()
        S = len(states)
        return (
            np.stack(states) if S else np.zeros((0, self.replicas, self.graph.nvars), bool),
            np.stack(bet) if S else np.zeros((0, self.replicas), np.float32),
        )

    # -- per-replica autocorrelations (tempering_container.rs:482-633) -----
    def calculate_variable_autocorrelations(
        self, t: int, swap_freq: int = 1, sampling_freq: int | None = None
    ) -> np.ndarray:
        """Spin autocorrelation per replica ``f32[R, S]`` (the
        ``TemperingContainer`` autocorrelation surface)."""
        from isingmontecarlo_tpu.analysis import autocorr as _ac

        states, _ = self.timesteps_sample(t, swap_freq, sampling_freq)
        s = 2.0 * jnp.asarray(states, jnp.float32) - 1.0  # [S, R, N]
        out = []
        for r in range(self.replicas):
            out.append(np.asarray(_ac.fft_autocorrelation(s[:, r])))
        return np.stack(out)

    def calculate_bond_autocorrelations(
        self, t: int, swap_freq: int = 1, sampling_freq: int | None = None
    ) -> np.ndarray:
        from isingmontecarlo_tpu.analysis import autocorr as _ac
        from isingmontecarlo_tpu.lattice import edge_arrays

        states, _ = self.timesteps_sample(t, swap_freq, sampling_freq)
        ev, ej = edge_arrays(self.graph.edges)
        out = []
        for r in range(self.replicas):
            out.append(
                np.asarray(
                    _ac.bond_autocorrelation(jnp.asarray(states[:, r : r + 1]), ev, ej)
                )
            )
        return np.stack(out)

    # -- multi-chip sharding ------------------------------------------------

    def shard_over(self, mesh, axis_name: str = "replicas") -> None:
        """Shard the replica axis over a :class:`jax.sharding.Mesh` so sweeps
        run data-parallel across devices via XLA collectives — the batched
        replacement for the reference's rayon thread pool
        (``tempering_container.rs:315-478``). The swap step's cross-device
        traffic is only the tiny per-replica ``(n, beta)`` vectors."""
        self._finalize()
        from jax.sharding import NamedSharding, PartitionSpec as P

        if self.replicas % mesh.devices.size:
            raise ValueError(
                f"replicas {self.replicas} not divisible by mesh size "
                f"{mesh.devices.size}"
            )
        self._mesh = mesh
        self._mesh_axis = axis_name
        sse = self.graph.sse
        sh = type(sse)(
            ops=type(sse.ops)(
                bond=NamedSharding(mesh, P(None, axis_name)),
                inputs=NamedSharding(mesh, P(None, None, axis_name)),
                outputs=NamedSharding(mesh, P(None, None, axis_name)),
            ),
            state=NamedSharding(mesh, P(axis_name, None)),
            key=NamedSharding(mesh, P()),
        )
        self.graph.sse = jax.device_put(sse, sh)
        rsh = NamedSharding(mesh, P(axis_name))
        self.betas = jax.device_put(self.betas, rsh)
        self.scales = jax.device_put(self.scales, NamedSharding(mesh, P(axis_name, None)))
        if self.xors is not None:
            self.xors = jax.device_put(
                self.xors, NamedSharding(mesh, P(axis_name, None))
            )

    def states_by_temperature(self):
        """Current states ordered by ascending beta (temperature grouping)."""
        self._finalize()
        order = np.argsort(np.asarray(self.betas))
        return np.asarray(self.graph.sse.state)[order], np.asarray(self.betas)[order]

    # -- small accessors (tempering_container.rs:211-238) -------------------

    def iter_over_states(self, f) -> None:
        """Call ``f(state_row, beta)`` for every replica
        (``tempering_container.rs:211-216``)."""
        self._finalize()
        states = np.asarray(self.graph.sse.state)
        betas = np.asarray(self.betas)
        for r in range(self.replicas):
            f(states[r], float(betas[r]))

    def graph_ref(self):
        """The batched graph and its per-replica betas — the analog of the
        reference's ``&[(Q, beta)]`` (``tempering_container.rs:219-221``)."""
        self._finalize()
        return self.graph, self.betas

    def graph_mut(self):
        """``tempering_container.rs:223-225``."""
        self._finalize()
        return self.graph, self.betas

    def num_graphs(self) -> int:
        """``tempering_container.rs:227-229``."""
        self._finalize()
        return self.replicas

    def get_total_swaps(self) -> int:
        """``tempering_container.rs:231-233``."""
        return self.total_swaps

    def verify(self) -> bool:
        self._finalize()
        if self.xors is None:
            return self.graph.verify()
        # Signed ladders: the positive-weight oracle must judge each replica
        # under its OWN sign-pattern label (flipped bonds legitimately hold
        # ops with zero base-table weight).
        sse = self.graph.sse
        return bool(
            jnp.all(
                _ops.verify(sse.ops, sse.state, self.graph.model, self.xors)
            )
        )
