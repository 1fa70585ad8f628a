"""Tensor operator-string storage — the batched replacement for ``FastOps``
(``src/sse/fast_ops.rs:35-49``).

The reference threads doubly-linked lists through heap nodes to get O(1)
insert/remove at any imaginary-time slot ``p``. Here the op string is stored
as fixed-capacity struct-of-arrays tensors and *derive* per-variable adjacency
on demand with a sort along the time axis (segmented-scan style), which
removes all mutation bookkeeping and vectorizes across replicas:

- ``bond: i32[M, R]`` — bond id per slot, ``-1`` = identity.
- ``inputs/outputs: bool[K, M, R]`` — per-leg spin states
  (the ``BasicOp`` substates, ``src/sse/qmc_traits/op_container.rs:163-401``).

Layout note: imaginary time ``M`` is the second-to-last axis and replicas
``R`` the last (minor) axis, so elementwise update math vectorizes across
replicas with contiguous loads, and sorts/scans run along time.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from isingmontecarlo_tpu.sse.model import BondModel
from isingmontecarlo_tpu.sse.tables import bond_fetch


class OpString(NamedTuple):
    bond: jax.Array  # i32[M, R]
    inputs: jax.Array  # bool[K, M, R]
    outputs: jax.Array  # bool[K, M, R]

    @property
    def cutoff(self) -> int:
        """The imaginary-time capacity M (reference `cutoff`)."""
        return self.bond.shape[0]

    @property
    def replicas(self) -> int:
        return self.bond.shape[1]

    @property
    def max_legs(self) -> int:
        return self.inputs.shape[0]


def empty_opstring(cutoff: int, replicas: int, max_legs: int = 2) -> OpString:
    return OpString(
        bond=jnp.full((cutoff, replicas), -1, jnp.int32),
        inputs=jnp.zeros((max_legs, cutoff, replicas), bool),
        outputs=jnp.zeros((max_legs, cutoff, replicas), bool),
    )


def grow(ops: OpString, new_cutoff: int) -> OpString:
    """Re-pad to a larger cutoff (the reference grows `cutoff` dynamically,
    ``qmc_ising.rs:786``; here growth is a host-side re-allocation)."""
    m = ops.cutoff
    if new_cutoff <= m:
        return ops
    pad = new_cutoff - m
    return OpString(
        bond=jnp.pad(ops.bond, ((0, pad), (0, 0)), constant_values=-1),
        inputs=jnp.pad(ops.inputs, ((0, 0), (0, pad), (0, 0))),
        outputs=jnp.pad(ops.outputs, ((0, 0), (0, pad), (0, 0))),
    )


def new_from_ops(
    cutoff: int, ops, *, replicas: int | None = None, max_legs: int = 2
) -> OpString:
    """Bulk-build an op string from explicit ``(p, bond, inputs, outputs)``
    tuples — the constructor tests and converters use
    (``FastOpsTemplate::new_from_ops``, ``fast_ops.rs:80-173``).

    ``ops`` is a flat iterable of tuples for a single replica, or — with
    ``replicas`` given — one such iterable per replica. ``inputs`` /
    ``outputs`` are per-leg spin sequences (length ≤ ``max_legs``)."""
    import numpy as np

    per_rep = [list(ops)] if replicas is None else [list(x) for x in ops]
    if replicas is not None and len(per_rep) != replicas:
        raise ValueError(f"expected {replicas} per-replica op lists")
    R = len(per_rep)
    bond = np.full((cutoff, R), -1, np.int32)
    ins = np.zeros((max_legs, cutoff, R), bool)
    outs = np.zeros((max_legs, cutoff, R), bool)
    for r, lst in enumerate(per_rep):
        for p, b, i_bits, o_bits in lst:
            bond[p, r] = b
            for leg, v in enumerate(i_bits):
                ins[leg, p, r] = bool(v)
            for leg, v in enumerate(o_bits):
                outs[leg, p, r] = bool(v)
    return OpString(jnp.asarray(bond), jnp.asarray(ins), jnp.asarray(outs))


def op_count(ops: OpString) -> jax.Array:
    """``n`` per replica (``OpContainer::get_n``)."""
    return jnp.sum(ops.bond >= 0, axis=0).astype(jnp.int32)


def bond_counts(ops: OpString, nbonds: int) -> jax.Array:
    """Per-bond op counts ``i32[R, NB]`` (the reference's optional bond
    counters, ``fast_ops.rs:45, 360-365``, used by tempering weights)."""
    m, r = ops.bond.shape
    rows = jnp.broadcast_to(jnp.arange(r, dtype=jnp.int32)[None, :], (m, r))
    b = jnp.where(ops.bond >= 0, ops.bond, nbonds)  # overflow row dropped
    counts = jnp.zeros((r, nbonds), jnp.int32)
    return counts.at[rows.ravel(), b.ravel()].add(1, mode="drop")


def leg_valid(ops: OpString, model: BondModel) -> jax.Array:
    """bool[K, M, R]: leg slot has a real variable."""
    return op_vars(ops, model) >= 0


def op_vars(ops: OpString, model: BondModel) -> jax.Array:
    """i32[K, M, R]: variable per leg (−1 where invalid), one per-leg fetch
    each so the result is laid out legs-major."""
    N = model.nvars
    K = model.max_legs
    b = jnp.maximum(ops.bond, 0)
    bv_nn = jnp.where(model.bond_vars >= 0, model.bond_vars, N)
    v = jnp.stack([bond_fetch(bv_nn[:, k], b) for k in range(K)])  # [K, M, R]
    return jnp.where((ops.bond >= 0)[None] & (v < N), v, -1)


def _seg_broadcast(flags, vals, reverse: bool = False):
    """Propagate ``vals`` from flagged rows forward (``reverse=False``) or
    backward through each run — the segmented-broadcast associative scan
    (combiner keeps the value of the most recent flagged row)."""
    if reverse:
        flags, vals = flags[::-1], vals[::-1]

    def comb(a, b):
        fa, va = a
        fb, vb = b
        return fa | fb, jnp.where(fb, vb, va)

    _, out = jax.lax.associative_scan(comb, (flags, vals), axis=0)
    return out[::-1] if reverse else out


def worldline_maps(ops: OpString, model: BondModel):
    """Flat-leg successor AND predecessor maps (periodic) derived by one sort
    of all legs along imaginary time — the batched replacement for the
    reference's per-variable doubly-linked lists (``fast_ops.rs:176-207``).

    Flat leg index ``f = l*M + p``. Returns ``(wnext, wprev, leg_var,
    (order, svar, seg_start))`` with ``wnext/wprev/leg_var: i32[K*M, R]``
    (self-maps for invalid legs); the order info is reused by callers that
    need per-variable first-leg lookups.

    Gather-free on the hot path: the flat index rides the leg sort as a
    payload operand, the
    sorted variable comes back out of the sort key itself, wrap targets are
    segmented-broadcast scans of ``order`` from run heads/tails, and the
    back-permute to flat leg space is a second sort keyed by the
    permutation.
    """
    M, R = ops.bond.shape
    K = ops.max_legs
    KM = K * M
    _BIG = jnp.int32(2**30)

    vars_kmr = op_vars(ops, model)  # [K, M, R] lane-major fetches
    leg_var = vars_kmr.reshape(KM, R)
    p_of_f = jnp.arange(KM, dtype=jnp.int32) % M
    self_f = jnp.broadcast_to(jnp.arange(KM, dtype=jnp.int32)[:, None], (KM, R))

    # Unique keys (invalid legs tie-break by flat index, matching the old
    # stable argsort), so the sort is a bijection with deterministic order.
    key = jnp.where(leg_var >= 0, leg_var * M + p_of_f[:, None], _BIG + self_f)
    skey, order = jax.lax.sort((key, self_f), dimension=0, num_keys=1)
    svar = jnp.where(skey < _BIG, skey // M, -1)

    seg_start = jnp.concatenate(
        [jnp.ones((1, R), bool), svar[1:] != svar[:-1]], axis=0
    )
    seg_end = jnp.concatenate(
        [svar[:-1] != svar[1:], jnp.ones((1, R), bool)], axis=0
    )
    # Flat index of each run's first/last leg, broadcast over the run: the
    # periodic wrap targets for the run's tail/head.
    first_ord = _seg_broadcast(seg_start, order)
    last_ord = _seg_broadcast(seg_end, order, reverse=True)
    nxt_same = jnp.concatenate(
        [svar[1:] == svar[:-1], jnp.zeros((1, R), bool)], axis=0
    )
    prv_same = jnp.concatenate(
        [jnp.zeros((1, R), bool), svar[:-1] == svar[1:]], axis=0
    )
    ord_up = jnp.concatenate([order[1:], order[-1:]], axis=0)
    ord_dn = jnp.concatenate([order[:1], order[:-1]], axis=0)
    tgt_next = jnp.where(nxt_same, ord_up, first_ord)
    tgt_prev = jnp.where(prv_same, ord_dn, last_ord)

    # Back-permute to flat leg space with a sort keyed by the permutation
    # (order is a bijection, so payload row j lands at row order[j]) — one
    # multi-operand sort instead of two [KM, R] scatters.
    _, wnext, wprev = jax.lax.sort(
        (order, tgt_next, tgt_prev), dimension=0, num_keys=1
    )
    wnext = jnp.where(leg_var >= 0, wnext, self_f)
    wprev = jnp.where(leg_var >= 0, wprev, self_f)
    return wnext, wprev, leg_var, (order, svar, seg_start)


def is_diagonal(ops: OpString) -> jax.Array:
    """bool[M, R] (identity slots count as diagonal). Padded legs always hold
    equal in/out values by construction."""
    return jnp.all(ops.inputs == ops.outputs, axis=0)


def substate_index(bits: jax.Array) -> jax.Array:
    """bool[K, ...] -> i32[...] with bit l = slot l."""
    k = bits.shape[0]
    weights = (1 << jnp.arange(k, dtype=jnp.int32)).reshape((k,) + (1,) * (bits.ndim - 1))
    return jnp.sum(bits.astype(jnp.int32) * weights, axis=0)


def op_weights(
    ops: OpString, model: BondModel, bond_xor: jax.Array | None = None
) -> jax.Array:
    """f32[M, R]: matrix element of every op (1.0 for identities).
    ``bond_xor: i32[R, NB]`` applies per-replica sign-pattern labels as
    substate-column permutations (see ``diagonal._xor_si``)."""
    b = jnp.maximum(ops.bond, 0)
    si = substate_index(ops.inputs)
    so = substate_index(ops.outputs)
    if bond_xor is not None:
        rows = jnp.arange(ops.replicas, dtype=jnp.int32)[None, :]
        x = bond_xor[rows, b]
        si = si ^ x
        so = so ^ x
    if model.full_w is not None:
        w = model.full_w[b, si, so]
    else:
        w = jnp.where(si == so, model.diag_w[b, si], 0.0)
    return jnp.where(ops.bond >= 0, w, 1.0)


def log_relative_weight(
    ops: OpString, model_a: BondModel, model_b: BondModel
) -> tuple[jax.Array, jax.Array]:
    """Generic op-walking relative weight — the ``OpWeights`` fallback
    (``OpWeights::relative_weight_for_hamiltonians``,
    ``src/sse/parallel_tempering/tempering_traits.rs:163-196``): evaluate
    every op's matrix element under both Hamiltonians' tables and product
    the ratios. Returns ``(f32[R] log prod w_b/w_a, bool[R] is_zero)``;
    ``is_zero`` marks replicas whose string has zero weight under ``model_b``
    (the reference returns 0.0 there), where the log is meaningless.

    Used for tempering between Hamiltonian pairs with no positive per-bond
    scale (see :func:`isingmontecarlo_tpu.parallel.tempering.swap_qmc_steppers`).
    """
    wa = op_weights(ops, model_a)  # [M, R], 1.0 at identities
    wb = op_weights(ops, model_b)
    occupied = ops.bond >= 0
    is_zero = jnp.any((wb <= 0.0) & occupied, axis=0)
    logw = jnp.sum(
        jnp.log(jnp.maximum(wb, 1e-30)) - jnp.log(jnp.maximum(wa, 1e-30)),
        axis=0,
    )
    return logw, is_zero


def log_weight_delta(
    ops: OpString,
    model: BondModel,
    scale_a: jax.Array,  # f32[R, NB] per-bond multipliers of label a
    xor_a: jax.Array,  # i32[R, NB] sign-pattern masks of label a
    scale_b: jax.Array,
    xor_b: jax.Array,
) -> tuple[jax.Array, jax.Array]:
    """Per-replica ``log W(string | label_b) - log W(string | label_a)``
    where a *label* is (per-bond multiplier, per-bond substate-XOR mask)
    relative to the shared base ``model`` — the batched, label-space form
    of :func:`log_relative_weight` used by signed tempering ladders: one
    fused ``[M, R]`` pass instead of the reference's per-op walk
    (``tempering_traits.rs:163-196``). Returns ``(delta f32[R], blocked
    bool[R])``; ``blocked`` marks replicas whose string has zero weight
    under label b (swap impossible — matches the reference returning 0)."""
    from isingmontecarlo_tpu.sse.tables import (
        class_select, fetch_xor, row_select, row_select3,
    )

    b = jnp.maximum(ops.bond, 0)
    occupied = ops.bond >= 0
    si = substate_index(ops.inputs)
    so = substate_index(ops.outputs)
    rows = jnp.arange(ops.replicas, dtype=jnp.int32)[None, :]
    SS = 1 << ops.max_legs
    use_cls = model.wtab_full is not None and model.wtab_full.size <= 64
    cls_f = bond_fetch(model.cls_full, b) if use_cls else None

    def w_under(xor):
        x = fetch_xor(xor, b)  # [M, R]
        if model.full_w is not None and use_cls:
            w = class_select(model.wtab_full, cls_f, (si ^ x) * SS + (so ^ x))
        elif model.full_w is not None:
            w = row_select3(model.full_w, b, si ^ x, so ^ x)
        else:
            w = jnp.where(si == so, row_select(model.diag_w, b, si ^ x), 0.0)
        return w

    wa = w_under(xor_a)
    wb = w_under(xor_b)
    blocked = jnp.any(occupied & (wb <= 0.0), axis=0)
    dlog_tab = jnp.where(
        occupied,
        jnp.log(jnp.maximum(wb, 1e-30)) - jnp.log(jnp.maximum(wa, 1e-30)),
        0.0,
    )
    dlog_scale = jnp.where(
        occupied,
        (jnp.log(jnp.maximum(scale_b, 1e-30))
         - jnp.log(jnp.maximum(scale_a, 1e-30)))[rows, b],
        0.0,
    )
    return jnp.sum(dlog_tab + dlog_scale, axis=0), blocked


def itime_fold(ops: OpString, state: jax.Array, model: BondModel, fold_fn, init):
    """Streaming ``imaginary_time_fold`` (``qmc_stepper.rs:165-167``): folds
    ``fold_fn(acc, state_at_p)`` (``state_at_p: bool[R, N]``) over all ``M``
    propagated imaginary-time states WITHOUT materializing the full
    ``bool[M, R, N]`` trajectory (:func:`itime_states` does) — the right
    shape for 32²/M≈7000 measurement folds. ``fold_fn`` must be traceable
    (it runs inside ``lax.scan``); the accumulator can be any pytree."""
    R = ops.replicas
    K = ops.max_legs
    vars_ = op_vars(ops, model)
    valid = vars_ >= 0
    rows = jnp.arange(R)

    def step(carry, xs):
        prop, acc = carry
        vars_p, valid_p, out_p = xs
        acc = fold_fn(acc, prop)
        for l in range(K):
            idx = jnp.where(valid_p[l], vars_p[l], model.nvars)
            prop = prop.at[rows, idx].set(out_p[l], mode="drop")
        return (prop, acc), None

    (_, acc), _ = jax.lax.scan(
        step,
        (state, init),
        (
            jnp.moveaxis(vars_, 1, 0),
            jnp.moveaxis(valid, 1, 0),
            jnp.moveaxis(ops.outputs, 1, 0),
        ),
    )
    return acc


@functools.partial(jax.jit, static_argnames=())
def verify(
    ops: OpString, state: jax.Array, model: BondModel,
    bond_xor: jax.Array | None = None,
) -> jax.Array:
    """Worldline integrity oracle per replica (``OpContainer::verify``,
    ``src/sse/qmc_traits/op_container.rs:137-159`` plus the positive-weight
    check of ``qmc_ising.rs:829-861``).

    Propagates ``state`` through all ops: every op's inputs must match the
    propagated state, outputs overwrite it, and the final state must equal the
    initial one (periodic worldlines). Returns ``bool[R]``.
    """
    R = ops.replicas
    K = ops.max_legs
    vars_ = op_vars(ops, model)  # [K, M, R]
    valid = vars_ >= 0
    rows = jnp.arange(R)

    def step(carry, xs):
        prop, ok = carry
        vars_p, valid_p, in_p, out_p = xs  # [K,R],[K,R],[K,R],[K,R]
        for l in range(K):
            idx = jnp.where(valid_p[l], vars_p[l], 0)
            cur = prop[rows, idx]
            ok = ok & jnp.where(valid_p[l], cur == in_p[l], True)
        for l in range(K):
            idx = jnp.where(valid_p[l], vars_p[l], model.nvars)
            prop = prop.at[rows, idx].set(out_p[l], mode="drop")
        return (prop, ok), None

    (prop, ok), _ = jax.lax.scan(
        step,
        (state, jnp.ones((R,), bool)),
        (
            jnp.moveaxis(vars_, 1, 0),
            jnp.moveaxis(valid, 1, 0),
            jnp.moveaxis(ops.inputs, 1, 0),
            jnp.moveaxis(ops.outputs, 1, 0),
        ),
    )
    ok = ok & jnp.all(prop == state, axis=1)
    ok = ok & jnp.all(op_weights(ops, model, bond_xor) > 0.0, axis=0)
    return ok


def itime_states(ops: OpString, state: jax.Array, model: BondModel) -> jax.Array:
    """All propagated imaginary-time states ``bool[M, R, N]`` (the
    ``imaginary_time_fold`` capability, ``qmc_stepper.rs:165-167``).

    Memory is O(M R N); intended for measurement at modest sizes.
    """
    R = ops.replicas
    K = ops.max_legs
    vars_ = op_vars(ops, model)
    valid = vars_ >= 0
    rows = jnp.arange(R)

    def step(prop, xs):
        vars_p, valid_p, out_p = xs
        out_state = prop
        for l in range(K):
            idx = jnp.where(valid_p[l], vars_p[l], model.nvars)
            out_state = out_state.at[rows, idx].set(out_p[l], mode="drop")
        return out_state, prop

    _, states = jax.lax.scan(
        step,
        state,
        (
            jnp.moveaxis(vars_, 1, 0),
            jnp.moveaxis(valid, 1, 0),
            jnp.moveaxis(ops.outputs, 1, 0),
        ),
    )
    return states
