"""Batched zero-energy worm walks (reference ``src/classical/graph.rs:179-318``).

Semantics of a single worm (reference ``do_worm_flip``):

1. Pick a random start site, record ``starting_e`` = coupling-only dE of
   flipping it, flip it.
2. Repeatedly, from the current endpoint, enumerate neighbor moves (excluding
   the site we came from). Candidates are flips with coupling-only ``dE == 0``
   (continuation) or ``dE == -starting_e`` (resolution). If any resolving
   candidate exists, choose only among resolving candidates; otherwise choose
   uniformly among continuations. With no candidates, turn around (re-flip the
   current endpoint, undoing the last move).
3. The worm closes when the applied move's ``dE`` cancels ``starting_e``.
   If the path length exceeds ``nvars`` the update fails and all flips are
   reverted (``graph.rs:283-316``).
4. On success, the net-flipped set (XOR of the visit path) is accepted or
   reverted with a Metropolis test on the longitudinal-bias energy change.

Double moves (``WormMove::Double``, ``graph.rs:224-240``): from endpoint
``v``, besides single flips of each neighbor ``ov``, the candidate set also
contains pairs ``(ov, oov)`` — flip ``ov`` and one of *its* neighbors
``oov`` — with combined ``dE = c(ov) + c(oov) + 4 J(ov,oov) sigma_ov
sigma_oov`` (the cross term corrects ``c(oov)`` for ``ov`` having flipped).
After a double move the new endpoint is ``oov`` and ``ov`` becomes the banned
back-step. Turn-arounds re-apply the previous move reversed
(``graph.rs:252-262``).

Deviations from the reference:

- The final bias Metropolis test uses the physical energy change
  ``dE_bias = sum_v 2 h_v sigma_v^{before}`` of the net flip. The reference
  evaluates ``2 h_v sigma_v^{after}`` (``graph.rs:303-306``), which is the
  negation of the energy change of the flip it just performed; we follow the
  physical convention (identical behavior for ``h = 0``, which is what the
  reference's own worm tests exercise).

Batched design: one worm per replica, advanced in lockstep by a single
``lax.while_loop`` whose body does O(max_degree) vector work per replica;
finished lanes idle until all replicas close or fail.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from isingmontecarlo_tpu.classical.metropolis import GraphTables, sigma

_EPS = 1e-6


class _WormCarry(NamedTuple):
    spins: jax.Array  # bool[R, N]
    flipped: jax.Array  # bool[R, N]  net parity of flips (visit path XOR)
    cur: jax.Array  # i32[R]     current worm endpoint
    last: jax.Array  # i32[R]     site we came from
    mv_a: jax.Array  # i32[R]     previous move, first site
    mv_b: jax.Array  # i32[R]     previous move, second site (== mv_a if single)
    steps: jax.Array  # i32[R]
    done: jax.Array  # bool[R]
    failed: jax.Array  # bool[R]
    key: jax.Array


def _coupling_delta_e(spins, tables: GraphTables, v):
    """Coupling-only dE of flipping site ``v`` per replica (graph.rs:155-177).

    ``v: i32[R]`` -> ``f32[R]``.
    """
    s = sigma(spins)  # [R, N]
    neigh = jnp.where(tables.neigh >= 0, tables.neigh, 0)
    w = jnp.where(tables.neigh >= 0, tables.nj, 0.0)
    nv = neigh[v]  # [R, D]
    wv = w[v]  # [R, D]
    sv = jnp.take_along_axis(s, v[:, None], axis=1)  # [R, 1]
    sn = jnp.take_along_axis(s, nv, axis=1)  # [R, D]
    return jnp.sum(-2.0 * wv * sv * sn, axis=-1)


def _delta_e_candidates(spins, tables: GraphTables, v):
    """dE of flipping each neighbor of ``v``: ``f32[R, D]`` (+ validity mask)."""
    s = sigma(spins)  # [R, N]
    neigh = jnp.where(tables.neigh >= 0, tables.neigh, 0)
    w = jnp.where(tables.neigh >= 0, tables.nj, 0.0)
    cand = neigh[v]  # [R, D] neighbor ids of the endpoint
    valid = tables.neigh[v] >= 0  # [R, D]
    # dE of flipping candidate c: -2 sum_j J_cj sigma_c sigma_j
    nc = neigh[cand]  # [R, D, D2]
    wc = w[cand]  # [R, D, D2]
    sn = s[jnp.arange(s.shape[0])[:, None, None], nc]  # [R, D, D2]
    sc = s[jnp.arange(s.shape[0])[:, None], cand][:, :, None]  # [R, D, 1]
    de = jnp.sum(-2.0 * wc * sc * sn, axis=-1)  # [R, D]
    return cand, de, valid


def _choose(key, weights):
    """Uniformly choose an index among ``weights > 0`` per row; -1 if none."""
    R, D = weights.shape
    total = jnp.sum(weights, axis=-1)
    u = jax.random.uniform(key, (R,)) * total
    cum = jnp.cumsum(weights, axis=-1)
    idx = jnp.sum((u[:, None] >= cum).astype(jnp.int32), axis=-1)
    idx = jnp.minimum(idx, D - 1)
    return jnp.where(total > 0, idx, -1)


@functools.partial(jax.jit, static_argnames=("allow_doubles",))
def worm_sweep(
    spins: jax.Array,
    key: jax.Array,
    beta: jax.Array,
    tables: GraphTables,
    allow_doubles: bool = True,
) -> jax.Array:
    """Run one worm update per replica. ``spins: bool[R, N]`` -> updated.

    ``allow_doubles`` enables the reference's two-site worm moves
    (``graph.rs:224-240``; the main move path passes ``true``,
    ``graph.rs:389-397``).
    """
    R, N = spins.shape
    D = tables.neigh.shape[1]
    beta = jnp.asarray(beta, jnp.float32)
    neigh = jnp.where(tables.neigh >= 0, tables.neigh, 0)  # [N, D]
    njw = jnp.where(tables.neigh >= 0, tables.nj, 0.0)

    key, k_start = jax.random.split(key)
    start = jax.random.randint(k_start, (R,), 0, N)
    starting_e = _coupling_delta_e(spins, tables, start)

    rows = jnp.arange(R)
    spins0 = spins
    spins = spins.at[rows, start].set(~spins[rows, start])
    flipped = jnp.zeros_like(spins).at[rows, start].set(True)

    carry = _WormCarry(
        spins=spins,
        flipped=flipped,
        cur=start,
        last=start,
        mv_a=start,
        mv_b=start,
        steps=jnp.zeros((R,), jnp.int32),
        done=jnp.zeros((R,), bool),
        failed=jnp.zeros((R,), bool),
        key=key,
    )

    def cond(c: _WormCarry):
        return jnp.any(~(c.done | c.failed))

    def _cvals(spins_b):
        """Coupling-only flip dE of every site: f32[R, N]."""
        from isingmontecarlo_tpu.classical.metropolis import local_field

        return -2.0 * sigma(spins_b) * local_field(spins_b, tables)

    def body(c: _WormCarry) -> _WormCarry:
        key, k_choice = jax.random.split(c.key)
        s = sigma(c.spins)  # [R, N]
        cvals = _cvals(c.spins)  # [R, N]

        # Single candidates: each neighbor ov of the endpoint.
        ov = neigh[c.cur]  # [R, D]
        valid_ov = (tables.neigh[c.cur] >= 0) & (ov != c.last[:, None])
        de_s = jnp.take_along_axis(cvals, ov, axis=1)  # [R, D]

        if allow_doubles:
            # Double candidates (ov, oov): dE = c(ov) + c(oov)
            #   + 4 J(ov,oov) sigma_ov sigma_oov  (graph.rs:224-240).
            oov = neigh[ov]  # [R, D, D]
            j2 = njw[ov]  # [R, D, D]
            valid_oov = (
                valid_ov[:, :, None]
                & (tables.neigh[ov] >= 0)
                & (oov != c.cur[:, None, None])
                & (oov != ov[:, :, None])
            )
            c_oov = jnp.take_along_axis(
                cvals[:, None, :].repeat(D, axis=1).reshape(R * D, N),
                oov.reshape(R * D, D),
                axis=1,
            ).reshape(R, D, D)
            s_ov = jnp.take_along_axis(s, ov, axis=1)[:, :, None]  # [R, D, 1]
            s_oov = jnp.take_along_axis(
                s[:, None, :].repeat(D, axis=1).reshape(R * D, N),
                oov.reshape(R * D, D),
                axis=1,
            ).reshape(R, D, D)
            de_d = de_s[:, :, None] + c_oov + 4.0 * j2 * s_ov * s_oov
            # Combined candidate vector: [R, D + D*D].
            all_de = jnp.concatenate([de_s, de_d.reshape(R, D * D)], axis=1)
            all_valid = jnp.concatenate(
                [valid_ov, valid_oov.reshape(R, D * D)], axis=1
            )
        else:
            all_de = de_s
            all_valid = valid_ov

        is_cont = all_valid & (jnp.abs(all_de) < _EPS)
        is_res = all_valid & (jnp.abs(all_de + starting_e[:, None]) < _EPS)
        any_res = jnp.any(is_res, axis=-1)
        cand_mask = jnp.where(any_res[:, None], is_res, is_cont | is_res)

        choice = _choose(k_choice, cand_mask.astype(jnp.float32))
        has_choice = choice >= 0
        safe = jnp.maximum(choice, 0)
        is_double_choice = has_choice & (safe >= D) if allow_doubles else jnp.zeros((R,), bool)
        d1 = jnp.where(safe >= D, (safe - D) // D, safe)
        d2 = jnp.where(safe >= D, (safe - D) % D, 0)
        mv_a_sel = ov[rows, d1]  # ov (or the single move var)
        oov_sel = neigh[mv_a_sel][rows, d2]
        mv_b_sel = jnp.where(is_double_choice, oov_sel, mv_a_sel)

        # Turn-around: re-apply the previous move reversed
        # (graph.rs:252-262). Reversed double (a, b) -> (b, a).
        ta_a = jnp.where(c.mv_a == c.mv_b, c.cur, c.mv_b)
        ta_b = jnp.where(c.mv_a == c.mv_b, c.cur, c.mv_a)

        mv_a = jnp.where(has_choice, mv_a_sel, ta_a)
        mv_b = jnp.where(has_choice, mv_b_sel, ta_b)
        is_double = mv_a != mv_b

        # dE of the applied move under the current state.
        c_a = cvals[rows, mv_a]
        c_b = cvals[rows, mv_b]
        jab = jnp.sum(
            jnp.where(neigh[mv_a] == mv_b[:, None], njw[mv_a], 0.0), axis=1
        )
        de_pair = c_a + c_b + 4.0 * jab * s[rows, mv_a] * s[rows, mv_b]
        move_de = jnp.where(is_double, de_pair, c_a)

        active = ~(c.done | c.failed)
        # Flip mv_a, then mv_b where double.
        new_spins = c.spins.at[rows, mv_a].set(
            jnp.where(active, ~c.spins[rows, mv_a], c.spins[rows, mv_a])
        )
        new_spins = new_spins.at[rows, mv_b].set(
            jnp.where(active & is_double, ~new_spins[rows, mv_b], new_spins[rows, mv_b])
        )
        new_flipped = c.flipped.at[rows, mv_a].set(
            jnp.where(active, ~c.flipped[rows, mv_a], c.flipped[rows, mv_a])
        )
        new_flipped = new_flipped.at[rows, mv_b].set(
            jnp.where(
                active & is_double, ~new_flipped[rows, mv_b], new_flipped[rows, mv_b]
            )
        )

        # Endpoint/back-step bookkeeping (graph.rs:272-278): after Single the
        # banned site is the previous endpoint; after Double(a, b) the
        # endpoint is b and the banned site is a.
        new_cur = jnp.where(is_double, mv_b, mv_a)
        new_last = jnp.where(is_double, mv_a, c.cur)

        closed = jnp.abs(move_de + starting_e) < _EPS
        steps = c.steps + 1
        too_long = steps > N

        return _WormCarry(
            spins=new_spins,
            flipped=new_flipped,
            cur=jnp.where(active, new_cur, c.cur),
            last=jnp.where(active, new_last, c.last),
            mv_a=jnp.where(active, mv_a, c.mv_a),
            mv_b=jnp.where(active, mv_b, c.mv_b),
            steps=jnp.where(active, steps, c.steps),
            done=c.done | (active & closed),
            failed=c.failed | (active & ~closed & too_long),
            key=key,
        )

    out = jax.lax.while_loop(cond, body, carry)

    # Failed worms revert entirely (graph.rs:311-316).
    spins = jnp.where(out.failed[:, None], spins0, out.spins)
    flipped = jnp.where(out.failed[:, None], False, out.flipped)

    # Bias Metropolis test on the net flip (see module docstring).
    s_before = sigma(jnp.where(flipped, ~spins, spins))
    de_bias = jnp.sum(
        jnp.where(flipped, 2.0 * tables.biases[None, :] * s_before, 0.0), axis=-1
    )
    key, k_acc = jax.random.split(out.key)
    u = jax.random.uniform(k_acc, (R,))
    keep = u < jnp.exp(-beta * jnp.maximum(de_bias, 0.0))
    spins = jnp.where((keep | out.failed)[:, None], spins, jnp.where(flipped, ~spins, spins))
    return spins
