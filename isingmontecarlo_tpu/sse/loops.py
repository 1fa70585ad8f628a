"""Directed-loop (off-diagonal) updates — reference
``src/sse/qmc_traits/directed_loop.rs``.

Reference semantics: pick a random op, leg, and direction; repeatedly choose
an exit leg with probability proportional to the matrix element of the op
with entrance+exit legs toggled (``h(op, entrance, exit)``,
``directed_loop.rs:111-143``), toggle the op, hop along the worldline to the
adjacent op (updating the p=0 state when wrapping the periodic boundary,
``directed_loop.rs:267-287``), and stop when the walk returns to the initial
(op, leg) (``directed_loop.rs:258-297``).

Batched form: every replica advances its own walker in lockstep inside one
``lax.while_loop``; worldline adjacency (next/prev op per leg) is derived once
per update by sorting legs along imaginary time (ops do not move during loop
updates — only their in/out bits toggle). Exit-leg weights are table lookups
in ``model.full_w``.

Safety deviation: walks are capped at ``4*K*M + 16`` hops; replicas whose
loop has not closed by then are reverted wholesale (op string and state),
counting as rejected moves. The reference would spin forever on a
non-closing walk.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from isingmontecarlo_tpu.sse.model import BondModel
from isingmontecarlo_tpu.sse.tables import bond_fetch
from isingmontecarlo_tpu.sse.opstring import OpString, op_count, substate_index

_BIG = jnp.int32(2**30)


def _take0(arr, idx):
    return jnp.take_along_axis(arr, idx, axis=0)


def _worldline_next_prev(ops: OpString, model: BondModel):
    """Flat-leg successor AND predecessor maps (periodic), plus leg vars.

    ``f = l*M + p``; returns ``(wnext, wprev, leg_var)`` each ``i32[K*M, R]``.
    """
    from isingmontecarlo_tpu.sse.opstring import worldline_maps

    wnext, wprev, leg_var, _ = worldline_maps(ops, model)
    return wnext, wprev, leg_var


class _WalkCarry(NamedTuple):
    si: jax.Array  # i32[M, R] input substate indices (mutated during walk)
    so: jax.Array  # i32[M, R] output substate indices
    state: jax.Array  # bool[R, N]
    p: jax.Array  # i32[R] current op slot
    leg: jax.Array  # i32[R] current entrance leg slot
    side: jax.Array  # i32[R] 0 = Inputs, 1 = Outputs
    done: jax.Array  # bool[R]
    steps: jax.Array  # i32[]
    key: jax.Array


@functools.partial(jax.jit, static_argnames=("cap_hops", "return_stats"))
def loop_update(
    ops: OpString,
    state: jax.Array,
    key: jax.Array,
    model: BondModel,
    cap_hops: int | None = None,
    return_stats: bool = False,
) -> tuple[OpString, jax.Array]:
    """One directed-loop update per replica. Returns updated ``(ops, state)``
    (plus ``reverted: bool[R]`` with ``return_stats``).

    ``cap_hops`` overrides the default ``4*K*M + 16`` walk cap (the bias
    test forces it small to exercise the revert path). Reverting a
    non-closing walk wholesale preserves detailed balance: a directed loop
    and its reversal visit the same ops with the same weight products, so
    "closes within the cap" is symmetric between a move and its inverse —
    capping is a symmetric proposal filter, not a bias
    (``tests/test_sse.py::test_loop_cap_revert_unbiased`` checks this
    against ED with a forced-small cap)."""
    M, R = ops.bond.shape
    K = ops.max_legs
    KM = K * M
    rows = jnp.arange(R)
    assert model.full_w is not None, "loop updates need full interaction matrices"

    wnext, wprev, leg_var = _worldline_next_prev(ops, model)
    b_safe = jnp.maximum(ops.bond, 0)
    arity = bond_fetch(model.arity(), b_safe)  # [M, R]

    si0 = substate_index(ops.inputs)  # i32[M, R]
    so0 = substate_index(ops.outputs)

    # --- initial walker: the n-th non-identity op, random leg & direction ---
    k_n, k_leg, k_side, k_walk = jax.random.split(key, 4)
    n = op_count(ops)  # i32[R]
    occ = (ops.bond >= 0).astype(jnp.int32)
    cum = jnp.cumsum(occ, axis=0)  # [M, R]
    target = jax.random.randint(k_n, (R,), 0, jnp.maximum(n, 1))
    p0 = jnp.argmax(cum > target[None, :], axis=0).astype(jnp.int32)  # [R]
    ar0 = arity[p0, rows]
    l0 = jax.random.randint(k_leg, (R,), 0, jnp.maximum(ar0, 1))
    s0 = jax.random.randint(k_side, (R,), 0, 2)
    active0 = n > 0

    def h_weights(si_p, so_p, bond_p, ent_l, ent_s, ar):
        """Weights of all 2K exit legs: [2K, R]. Exit index e = side*K + leg."""
        ent_in = jnp.where(ent_s == 0, 1 << ent_l, 0)
        ent_out = jnp.where(ent_s == 1, 1 << ent_l, 0)
        si_e = si_p ^ ent_in
        so_e = so_p ^ ent_out
        ws = []
        for s in range(2):
            for l in range(K):
                si_x = si_e ^ (0 if s else (1 << l))
                so_x = so_e ^ ((1 << l) if s else 0)
                w = model.full_w[bond_p, si_x, so_x]
                ws.append(jnp.where(l < ar, w, 0.0))
        return jnp.stack(ws)  # [2K, R] order: inputs legs then outputs legs

    def body(c: _WalkCarry) -> _WalkCarry:
        key, k_exit = jax.random.split(c.key)
        active = ~c.done & active0

        bond_p = jnp.maximum(ops.bond[c.p, rows], 0)
        ar = arity[c.p, rows]
        si_p = c.si[c.p, rows]
        so_p = c.so[c.p, rows]

        w = h_weights(si_p, so_p, bond_p, c.leg, c.side, ar)  # [2K, R]
        tot = jnp.sum(w, axis=0)
        u = jax.random.uniform(k_exit, (R,)) * tot
        cw = jnp.cumsum(w, axis=0)
        exit_idx = jnp.sum((u[None, :] >= cw).astype(jnp.int32), axis=0)
        exit_idx = jnp.minimum(exit_idx, 2 * K - 1)
        exit_s = exit_idx // K
        exit_l = exit_idx % K

        # Toggle entrance and exit legs on the op.
        ent_in = jnp.where(c.side == 0, 1 << c.leg, 0)
        ent_out = jnp.where(c.side == 1, 1 << c.leg, 0)
        ex_in = jnp.where(exit_s == 0, 1 << exit_l, 0)
        ex_out = jnp.where(exit_s == 1, 1 << exit_l, 0)
        new_si_p = si_p ^ ent_in ^ ex_in
        new_so_p = so_p ^ ent_out ^ ex_out
        si = c.si.at[c.p, rows].set(jnp.where(active, new_si_p, si_p))
        so = c.so.at[c.p, rows].set(jnp.where(active, new_so_p, so_p))

        # Close if the exit leg is the initial (op, leg, side)
        # (directed_loop.rs:258-260).
        closed_a = (c.p == p0) & (exit_l == l0) & (exit_s == s0)

        # Hop along the worldline.
        f = exit_l * M + c.p  # flat leg id
        f_next = jnp.where(exit_s == 1, wnext[f, rows], wprev[f, rows])
        p_next = f_next % M
        l_next = f_next // M
        # Boundary wrap: moving up past the end / down past the start
        # updates the p=0 state (directed_loop.rs:267-287).
        wrapped = jnp.where(exit_s == 1, p_next <= c.p, p_next >= c.p)
        var = leg_var[f, rows]
        boundary_bit = jnp.where(
            exit_s == 1,
            (new_so_p >> exit_l) & 1,
            (new_si_p >> exit_l) & 1,
        ).astype(bool)
        upd = active & ~closed_a & wrapped & (var >= 0)
        state = c.state.at[rows, jnp.where(upd, var, model.nvars)].set(
            boundary_bit, mode="drop"
        )

        side_next = 1 - exit_s  # enter the neighbor on the opposite side
        closed_b = (p_next == p0) & (l_next == l0) & (side_next == s0)

        done = c.done | (active & (closed_a | closed_b))
        return _WalkCarry(
            si=si,
            so=so,
            state=state,
            p=jnp.where(active & ~done, p_next, c.p),
            leg=jnp.where(active & ~done, l_next, c.leg),
            side=jnp.where(active & ~done, side_next, c.side),
            done=done,
            steps=c.steps + 1,
            key=key,
        )

    cap = 4 * KM + 16 if cap_hops is None else cap_hops

    def cond(c: _WalkCarry):
        return jnp.any(~c.done & active0) & (c.steps < cap)

    init = _WalkCarry(
        si=si0,
        so=so0,
        state=state,
        p=p0,
        leg=l0,
        side=s0,
        done=jnp.zeros((R,), bool),
        steps=jnp.int32(0),
        key=k_walk,
    )
    out = jax.lax.while_loop(cond, body, init)

    completed = out.done | ~active0
    # Revert replicas whose walk did not close (see module docstring).
    si = jnp.where(completed[None, :], out.si, si0)
    so = jnp.where(completed[None, :], out.so, so0)
    new_state = jnp.where(completed[:, None], out.state, state)

    # Unpack substate indices back to per-leg bits.
    bit = jnp.arange(K, dtype=jnp.int32).reshape(K, 1, 1)
    new_inputs = ((si[None] >> bit) & 1).astype(bool)
    new_outputs = ((so[None] >> bit) & 1).astype(bool)
    # Padded legs keep equal in/out (they are zero in substate encoding). ✓
    new_ops = OpString(bond=ops.bond, inputs=new_inputs, outputs=new_outputs)
    if return_stats:
        return new_ops, new_state, ~completed
    return new_ops, new_state
