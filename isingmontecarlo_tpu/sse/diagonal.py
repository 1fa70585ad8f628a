"""SSE diagonal (Metropolis) and heat-bath updates.

Reference semantics (``src/sse/qmc_traits/diagonal.rs:84-191``, Sandvik
PRB 59 14157 eqs. 19a/19b via arXiv:1909.10591):

Sweep imaginary-time slots ``p = 0..M`` carrying the propagated state and the
op count ``n``:

- identity slot: draw a bond ``b`` uniformly; insert a diagonal op with
  probability ``min(1, beta NB <s|H_b|s> / (M - n))``.
- diagonal op: remove with probability ``min(1, (M - n + 1) / (beta NB W))``.
- off-diagonal op: propagate the state through its outputs.

Heat-bath variant (``src/sse/qmc_traits/heatbath.rs:148-209``): insert with
probability ``bW_tot / (M - n + bW_tot)`` where ``bW_tot = beta * sum_b
max_w(b)``; pick the bond from the max-weight distribution (cumulative table +
searchsorted) and accept ``u * max_w(b) < W``; remove any diagonal op with
probability ``(M - n + 1) / (M - n + 1 + bW_tot)``.

Batched form: every replica's sweep runs at once. The per-slot proposal
weights are computed for all slots up front (:func:`_parallel_weights`), so
the only sequential piece left is the op-count carry over the M slots — the
CUDA kernel of ``ops/diag_carry.py`` on a GPU, a ``lax.scan`` elsewhere. All
randomness is pre-generated as counter-based uniforms ``[M, R]``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from isingmontecarlo_tpu.ops import backend
from isingmontecarlo_tpu.ops.diag_carry import carry_decisions
from isingmontecarlo_tpu.sse.model import BondModel
from isingmontecarlo_tpu.sse.opstring import OpString, op_count
from isingmontecarlo_tpu.sse.tables import bond_fetch as _bond_fetch
from isingmontecarlo_tpu.sse.tables import class_select as _class_select
from isingmontecarlo_tpu.sse.tables import fetch_xor as _fetch_xor
from isingmontecarlo_tpu.sse.tables import row_select
from isingmontecarlo_tpu.sse.tables import searchsorted_left as _searchsorted_left


class HeatBathTables(NamedTuple):
    """Precomputed ``BondWeights`` (``heatbath.rs:10-61``). Per-model
    (``cum_max_w: f32[NB]``, scalar total) or per-replica
    (``f32[R, NB]`` / ``f32[R]``) when bond scales differ across the batch —
    the reference's per-graph ``BondWeights`` in a heterogeneous tempering
    ladder."""

    cum_max_w: jax.Array  # f32[NB] or f32[R, NB] inclusive cumulative maxima
    total: jax.Array  # f32[] or f32[R] total weight


def make_heatbath_tables(
    model: BondModel, bond_scale: jax.Array | None = None
) -> HeatBathTables:
    maxw = model.max_diag_w()
    if bond_scale is None:
        cum = jnp.cumsum(maxw)
        return HeatBathTables(cum_max_w=cum, total=cum[-1])
    cum = jnp.cumsum(maxw[None, :] * bond_scale, axis=1)  # [R, NB]
    return HeatBathTables(cum_max_w=cum, total=cum[:, -1])


def _xor_si(si, bond_xor, b, rows):
    """Substate index for weight-table lookups under a per-replica sign
    pattern. A sign-flipped coupling's weight table is EXACTLY the base
    table with substate columns permuted by an XOR mask (Ising two-site:
    ``|J| ∓ J`` swaps aligned/anti-aligned, i.e. flip one leg's bit;
    longitudinal: ``|h| ± h`` swaps up/down): ``w_flip(b, s) = w(b, s ^
    m_b)``. ``bond_xor: i32[R, NB]`` holds per-replica masks (0 = base
    sign); the stored spin states stay physical — only lookups permute.
    This is the label-swap representation of sign disorder that
    ``tempering_traits.rs:163-196`` handles by op-walking."""
    if bond_xor is None:
        return si
    rr = rows.reshape((1,) * (si.ndim - 1) + (-1,))
    return si ^ bond_xor[rr, b]


# Class-table weight lookups replace ``diag_w`` gathers when the model has
# at most this many (class, substate) cells: the select chain is elementwise
# work on [M, R] grids.
_CLASS_MAX_CELLS = 64

def _use_class_tables(model) -> bool:
    return (
        model.wtab is not None
        and model.wtab.shape[0] * model.wtab.shape[1] <= _CLASS_MAX_CELLS
    )


def _weight_lookup(model, b, si, bond_xor, rows):
    """``diag_w[b, si ^ xor_mask]`` on an ``[M, R]`` (bond, substate) grid:
    class-table select chain when the model factorizes small, else the
    row-gather + where-chain of :func:`row_select`."""
    if _use_class_tables(model):
        if bond_xor is not None:
            si = si ^ _fetch_xor(bond_xor, b)
        return _class_select(model.wtab, _bond_fetch(model.cls, b), si)
    return row_select(model.diag_w, b, _xor_si(si, bond_xor, b, rows))


def _gather_state_bits(state, vars_p, rows):
    """state bool[R, N], vars_p i32[K, R] (−1 pads) -> bits bool[K, R]."""
    bits = []
    for l in range(vars_p.shape[0]):
        idx = jnp.where(vars_p[l] >= 0, vars_p[l], 0)
        bits.append(jnp.where(vars_p[l] >= 0, state[rows, idx], False))
    return jnp.stack(bits)


def _substate_idx(bits):
    k = bits.shape[0]
    w = (1 << jnp.arange(k, dtype=jnp.int32)).reshape((k,) + (1,) * (bits.ndim - 1))
    return jnp.sum(bits.astype(jnp.int32) * w, axis=0)


# Cap, in 32-bit words, on one M-chunk of the packed flip-parity tensor
# [Mc, R, W] (W = ceil(N / 32)). The XOR associative_scan holds about four
# tensors of a chunk's size at once, so 2^28 words (1 GiB) bounds the
# precompute at a few GiB: a small share of the 60 GB a JAX process takes of
# an 80 GB H100 by default, leaving the rest to the op string and to the
# cluster update's label problem. At 32^2 R=512 (M ~ 7,000, W = 32) the whole
# string is one chunk of 1.2e8 words.
_PAR_MAX_WORDS = 1 << 28


def _parallel_weights(ops, state, u1, model, hb, heatbath, bond_xor=None):
    """Everything the diagonal sweep needs per slot, computed upfront.

    Key fact: a diagonal sweep only inserts/removes *diagonal* ops, which do
    not change worldline propagation — the propagated state at every slot is
    fixed by the (immutable) off-diagonal ops. So the proposal bonds (drawn
    unconditionally from pre-generated uniforms, exactly as the sequential
    scan does) and their matrix elements can be evaluated for all slots in
    parallel: spin of var v just below slot p = state[v] XOR (parity of
    off-diagonal flips on v's worldline before p), an exclusive XOR-scan
    along imaginary time. Returns ``(b_new, bits_new [K, M, R], w_new)``.

    Parities are packed 32 variables to a word: variable ``v`` is bit
    ``v % 32`` of word ``v // 32``. Each slot's toggles reach their words by
    a native scatter-add (one op per slot with distinct legs, so the added
    bits are distinct and the sum is their XOR), the XOR scan runs over
    ``[M, R, W]`` words, and a native gather reads each proposed leg's word.
    Above ``_PAR_MAX_WORDS`` the scan runs in M-chunks threaded by the XOR
    carry (exact — XOR is associative).
    """
    M, R = ops.bond.shape
    K = ops.max_legs
    N = model.nvars
    NB = model.nbonds
    W = -(-N // 32)
    rows = jnp.arange(R, dtype=jnp.int32)

    # --- proposal bonds for every slot (same draw as the sequential path) --
    if heatbath:
        b_new = _searchsorted_left(hb.cum_max_w, u1 * hb.total)
        b_new = jnp.minimum(b_new, NB - 1)
    else:
        b_new = jnp.minimum((u1 * NB).astype(jnp.int32), NB - 1)

    # --- packed flip-parity words ------------------------------------------
    vars_all = model.bond_vars[jnp.maximum(ops.bond, 0)]  # [M, R, K]
    leg_ok = (vars_all >= 0) & (ops.bond >= 0)[..., None]
    tog = jnp.moveaxis(ops.inputs != ops.outputs, 0, -1) & leg_ok
    v = jnp.where(leg_ok, vars_all, 0)
    one = jnp.uint32(1)
    bit = jnp.where(tog, one << (v % 32).astype(jnp.uint32), jnp.uint32(0))
    vq = model.bond_vars[b_new]  # [M, R, K]
    q_ok = vq >= 0
    vq = jnp.where(q_ok, vq, 0)
    st = jnp.pad(state.astype(jnp.uint32), ((0, 0), (0, 32 * W - N)))
    state_w = jnp.sum(
        st.reshape(R, W, 32) << jnp.arange(32, dtype=jnp.uint32),
        axis=-1, dtype=jnp.uint32,
    )  # [R, W]
    rr = rows[None, :, None]
    words = []
    par0 = jnp.zeros((R, W), jnp.uint32)
    n_chunks = max(1, -(-(M * R * W) // _PAR_MAX_WORDS))
    Mc = -(-M // n_chunks)
    for c0 in range(0, M, Mc):
        c1 = min(c0 + Mc, M)
        mc = c1 - c0
        p_idx = jnp.broadcast_to(
            jnp.arange(mc, dtype=jnp.int32)[:, None, None], (mc, R, K)
        )
        flips = jnp.zeros((mc, R, W), jnp.uint32).at[
            p_idx, jnp.broadcast_to(rr, (mc, R, K)), v[c0:c1] // 32
        ].add(bit[c0:c1])
        inc = jax.lax.associative_scan(jnp.bitwise_xor, flips, axis=0)
        par = par0[None] ^ jnp.concatenate(
            [jnp.zeros((1, R, W), jnp.uint32), inc[:-1]], axis=0
        )
        words.append(jnp.take_along_axis(par, vq[c0:c1] // 32, axis=2))
        par0 = par0 ^ inc[-1]
    pw = words[0] if len(words) == 1 else jnp.concatenate(words, axis=0)
    sw = state_w[rr, vq // 32]  # [M, R, K]
    bits_new = (((pw ^ sw) >> (vq % 32).astype(jnp.uint32)) & one == one) & q_ok
    weights = (1 << jnp.arange(K, dtype=jnp.int32))[None, None, :]
    si_new = jnp.sum(bits_new.astype(jnp.int32) * weights, axis=2)  # [M, R]
    w_new = _weight_lookup(model, b_new, si_new, bond_xor, rows)
    return b_new, jnp.moveaxis(bits_new, -1, 0), w_new  # bits [K, M, R]


def _ins_rem(n, u0, idp, dgp, *extra, M, heatbath, bw_tot):
    """Insert/remove decisions at op count ``n`` — the single definition of
    the acceptance arithmetic (eqs 19a/19b, ``diagonal.rs:141-191`` /
    ``heatbath.rs:149-209``) for the sequential carry scan; the carry kernel
    (``ops/diag_carry.py``) evaluates the same expressions in the same order,
    so both are bit-identical."""
    mmn = (M - n).astype(jnp.float32)
    if heatbath:
        (insw,) = extra
        ins_try = u0 * (mmn + bw_tot) < bw_tot
        insert = idp & ins_try & insw
        remove = dgp & (u0 * (mmn + 1.0 + bw_tot) < (mmn + 1.0))
    else:
        ni, nr = extra
        insert = idp & (u0 * mmn < ni)
        remove = dgp & (u0 * nr < (mmn + 1.0))
    return insert, remove


@functools.partial(jax.jit, static_argnames=("heatbath", "unroll"))
def _diagonal_update_fast(
    ops: OpString,
    state: jax.Array,
    beta: jax.Array,
    key: jax.Array,
    model: BondModel,
    hb: HeatBathTables | None = None,
    heatbath: bool = False,
    bond_scale: jax.Array | None = None,
    unroll: int = 8,
    bond_xor: jax.Array | None = None,
) -> OpString:
    """Precomputed-weights diagonal sweep: identical Markov chain to
    :func:`diagonal_update` (same uniforms, same acceptance arithmetic), but
    the sequential scan carries only the op count ``n`` — every per-slot
    quantity is a precomputed ``[M, R]`` tensor (see
    :func:`_parallel_weights`), so the per-step body is a handful of
    ``[R]``-vector ops instead of state-array gathers/scatters."""
    M, R = ops.bond.shape
    NB = model.nbonds
    beta = jnp.asarray(beta, jnp.float32)
    if beta.ndim == 0:
        beta = jnp.broadcast_to(beta, (R,))
    rows = jnp.arange(R)

    u = jax.random.uniform(key, (3, M, R))
    n0 = op_count(ops)
    b_new, bits_new, w_new = _parallel_weights(
        ops, state, u[1], model, hb, heatbath, bond_xor=bond_xor
    )

    is_ident = ops.bond < 0
    is_diag = jnp.all(ops.inputs == ops.outputs, axis=0) & ~is_ident
    b_safe = jnp.maximum(ops.bond, 0)
    si_cur = jnp.sum(
        ops.inputs.astype(jnp.int32)
        * (1 << jnp.arange(ops.max_legs, dtype=jnp.int32))[:, None, None],
        axis=0,
    )
    w_cur = _weight_lookup(model, b_safe, si_cur, bond_xor, rows)
    if bond_scale is not None:
        w_new = w_new * bond_scale[rows[None, :], b_new]
        w_cur = w_cur * bond_scale[rows[None, :], b_safe]

    if heatbath:
        bw_tot = beta * hb.total  # [R]
        if _use_class_tables(model):
            # max over the class row == max_diag_w()[b_new] exactly (same
            # floats, order-independent max), selected without a gather.
            maxw_cls = jnp.max(model.wtab, axis=1)  # [C]
            cls_new = _bond_fetch(model.cls, b_new)
            maxw = _class_select(maxw_cls[:, None], cls_new, jnp.int32(0))
        else:
            maxw = jnp.max(model.diag_w[b_new], axis=-1)
        if bond_scale is not None:
            maxw = maxw * bond_scale[rows[None, :], b_new]
        ins_w = u[2] * maxw < w_new  # [M, R], n-independent part
    else:
        num_ins = beta[None, :] * NB * w_new  # [M, R]
        num_rem = beta[None, :] * NB * w_cur

    bwt = bw_tot if heatbath else jnp.float32(0.0)

    def step(n, xs):
        u0, idp, dgp = xs[:3]
        insert, remove = _ins_rem(
            n, u0, idp, dgp, *xs[3:], M=M, heatbath=heatbath, bw_tot=bwt
        )
        n = n + insert.astype(jnp.int32) - remove.astype(jnp.int32)
        return n, (insert, remove)

    if heatbath:
        xs = (u[0], is_ident, is_diag, ins_w)
    else:
        xs = (u[0], is_ident, is_diag, num_ins, num_rem)
    if backend.gpu_kernels():
        p1, p2 = (ins_w, None) if heatbath else (num_ins, num_rem)
        insert, remove = carry_decisions(
            n0, u[0], is_ident, is_diag, p1, p2, bwt, heatbath=heatbath
        )
    else:
        _, (insert, remove) = jax.lax.scan(step, n0, xs, unroll=unroll)

    new_bond = jnp.where(insert, b_new, jnp.where(remove, -1, ops.bond))
    keep_in = jnp.where(insert[None], bits_new, ops.inputs)
    keep_in = jnp.where(remove[None], False, keep_in)
    changed = new_bond != ops.bond
    new_out = jnp.where(changed[None], keep_in, ops.outputs)
    new_in_full = jnp.where(changed[None], keep_in, ops.inputs)
    return OpString(bond=new_bond, inputs=new_in_full, outputs=new_out)


def diagonal_update(
    ops: OpString,
    state: jax.Array,  # bool[R, N]
    beta: jax.Array,  # f32[] or f32[R]
    key: jax.Array,
    model: BondModel,
    hb: HeatBathTables | None = None,
    heatbath: bool = False,
    bond_scale: jax.Array | None = None,  # f32[R, NB]
    unroll: int = 4,
    bond_xor: jax.Array | None = None,  # i32[R, NB] sign-pattern masks
) -> OpString:
    """One full diagonal sweep (dispatcher). The precomputed-weights fast
    path chunks its parity tensors to the element cap, so it applies at any
    size; the sequential full scan (`_diagonal_update_scan`) remains as the
    equivalence oracle. Both run the identical Markov chain."""
    del unroll
    return _diagonal_update_fast(
        ops, state, beta, key, model, hb=hb, heatbath=heatbath,
        bond_scale=bond_scale, bond_xor=bond_xor,
    )


@functools.partial(jax.jit, static_argnames=("heatbath", "unroll"))
def _diagonal_update_scan(
    ops: OpString,
    state: jax.Array,  # bool[R, N]
    beta: jax.Array,  # f32[] or f32[R]
    key: jax.Array,
    model: BondModel,
    hb: HeatBathTables | None = None,
    heatbath: bool = False,
    bond_scale: jax.Array | None = None,  # f32[R, NB]
    unroll: int = 4,
    bond_xor: jax.Array | None = None,  # i32[R, NB] sign-pattern masks
) -> OpString:
    """One full diagonal sweep as a sequential scan carrying ``(state, n)``.

    The p=0 state is unchanged by construction (only diagonal ops are inserted
    or removed; the reference likewise sweeps a copy of the state,
    ``diagonal.rs:101-111``).

    ``bond_scale`` optionally multiplies every bond's matrix elements per
    replica — the heterogeneous-Hamiltonian support for parallel tempering
    ladders in coupling/field space (reference tempering swaps whole graphs
    with different ``(J, transverse, longitudinal)``,
    ``tempering_traits.rs:117-155``). All other update kinds (cluster, loop,
    RVB) only ever use *ratios* of same-bond or same-class weights, so a
    class-uniform scale cancels there and needs no plumbing.
    """
    if heatbath and bond_scale is not None:
        assert hb is not None and hb.cum_max_w.ndim == 2, (
            "per-replica bond scales with heat-bath need per-replica tables "
            "(make_heatbath_tables(model, bond_scale))"
        )
    M, R = ops.bond.shape
    K = ops.max_legs
    NB = model.nbonds
    beta = jnp.asarray(beta, jnp.float32)
    if beta.ndim == 0:
        beta = jnp.broadcast_to(beta, (R,))

    rows = jnp.arange(R)
    u = jax.random.uniform(key, (3, M, R))
    n0 = op_count(ops)

    bond_vars = model.bond_vars  # [NB, K]
    diag_w = model.diag_w  # [NB, 2^K]

    if heatbath:
        assert hb is not None
        bw_tot = beta * hb.total  # [R]
        max_w_tab = model.max_diag_w()  # [NB]

    def step(carry, xs):
        prop, n = carry
        bond_p, in_p, out_p, u0, u1, u2 = xs
        # classify
        is_ident = bond_p < 0
        is_diag = jnp.all(in_p == out_p, axis=0) & ~is_ident
        is_offdiag = ~is_ident & ~is_diag

        # --- propagate off-diagonal ops (diagonal.rs:155-161) -------------
        b_safe = jnp.maximum(bond_p, 0)
        vars_cur = jnp.moveaxis(bond_vars[b_safe], -1, 0)  # [K, R]
        new_prop = prop
        for l in range(K):
            idx = jnp.where(is_offdiag & (vars_cur[l] >= 0), vars_cur[l], model.nvars)
            new_prop = new_prop.at[rows, idx].set(out_p[l], mode="drop")
        prop = new_prop

        mmn = (M - n).astype(jnp.float32)  # M - n

        # --- proposal bond ------------------------------------------------
        if heatbath:
            if hb.cum_max_w.ndim == 2:  # per-replica tables [R, NB]
                tgt = (u1 * hb.total)[:, None]
                b_new = jnp.sum(hb.cum_max_w < tgt, axis=1).astype(jnp.int32)
            else:
                b_new = jnp.searchsorted(hb.cum_max_w, u1 * hb.total).astype(
                    jnp.int32
                )
            b_new = jnp.minimum(b_new, NB - 1)
        else:
            b_new = jnp.minimum((u1 * NB).astype(jnp.int32), NB - 1)
        vars_new = jnp.moveaxis(bond_vars[b_new], -1, 0)  # [K, R]
        bits_new = _gather_state_bits(prop, vars_new, rows)  # [K, R]
        w_new = diag_w[
            b_new, _xor_si(_substate_idx(bits_new), bond_xor, b_new, rows)
        ]  # [R]

        # --- current op weight (for removal) ------------------------------
        w_cur = diag_w[
            b_safe, _xor_si(_substate_idx(in_p), bond_xor, b_safe, rows)
        ]

        if bond_scale is not None:
            w_new = w_new * bond_scale[rows, b_new]
            w_cur = w_cur * bond_scale[rows, b_safe]

        if heatbath:
            ins_try = u0 * (mmn + bw_tot) < bw_tot
            maxw = max_w_tab[b_new]
            if bond_scale is not None:
                maxw = maxw * bond_scale[rows, b_new]
            insert = is_ident & ins_try & (u2 * maxw < w_new)
            remove = is_diag & (u0 * (mmn + 1.0 + bw_tot) < (mmn + 1.0))
        else:
            num = beta * NB * w_new
            insert = is_ident & (u0 * mmn < num)
            num_r = beta * NB * w_cur
            remove = is_diag & (u0 * num_r < (mmn + 1.0))

        new_bond = jnp.where(insert, b_new, jnp.where(remove, -1, bond_p))
        keep_in = jnp.where(insert[None], bits_new, in_p)
        keep_in = jnp.where(remove[None], False, keep_in)
        new_n = n + insert.astype(jnp.int32) - remove.astype(jnp.int32)
        return (prop, new_n), (new_bond, keep_in)

    xs = (
        ops.bond,
        jnp.moveaxis(ops.inputs, 1, 0),
        jnp.moveaxis(ops.outputs, 1, 0),
        u[0],
        u[1],
        u[2],
    )
    # unroll: the per-slot body is small vector work ([R]-wide); unrolling
    # amortizes the loop overhead over several imaginary-time slots.
    (_, _), (new_bond, new_in) = jax.lax.scan(
        step, (state, n0), xs, unroll=unroll
    )
    new_in = jnp.moveaxis(new_in, 0, 1)  # [K, M, R]
    # Inserted/removed slots are diagonal: outputs follow inputs there; slots
    # holding off-diagonal ops are untouched by the sweep.
    changed = new_bond != ops.bond
    new_out = jnp.where(changed[None], new_in, ops.outputs)
    new_in_full = jnp.where(changed[None], new_in, ops.inputs)
    return OpString(bond=new_bond, inputs=new_in_full, outputs=new_out)
