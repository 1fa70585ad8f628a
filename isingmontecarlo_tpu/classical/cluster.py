"""Swendsen-Wang cluster updates for classical Ising models.

The reference has no classical cluster move (its classical moves are
single-spin, edge, and worm flips, ``src/classical/graph.rs``); this module
adds the standard Swendsen-Wang / Wolff family because it is the right tool
for the 256^2 temperature-sweep workload (BASELINE.md config 2) and it
vectorizes perfectly:

1. Activate each *satisfied* bond (``J sigma_i sigma_j = -|J|``) with
   probability ``1 - exp(-2 beta |J|)``.
2. Label connected components of the activated-bond graph by iterated
   min-label propagation with pointer jumping (O(log N) rounds of gathers).
3. Flip every cluster independently with probability 1/2; with longitudinal
   biases, accept each cluster's flip with the Metropolis factor of its bias
   energy change instead.

All arrays carry a leading replica axis ``R``.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from isingmontecarlo_tpu.classical.metropolis import GraphTables, sigma


def _connected_components(active, edges, n):
    """Min-label connected components.

    ``active: bool[R, E]`` activation per edge, ``edges: i32[E, 2]``.
    Returns ``labels: i32[R, N]`` where each vertex holds the min vertex id of
    its component.
    """
    R = active.shape[0]
    labels = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None, :], (R, n))
    va = edges[:, 0]
    vb = edges[:, 1]
    rows = jnp.arange(R)[:, None]

    def body(state):
        labels, _ = state
        la = labels[:, va]
        lb = labels[:, vb]
        mn = jnp.minimum(la, lb)
        big = jnp.iinfo(jnp.int32).max
        upd_a = jnp.where(active, mn, big)
        upd_b = jnp.where(active, mn, big)
        new = labels.at[rows, va[None, :]].min(upd_a)
        new = new.at[rows, vb[None, :]].min(upd_b)
        # Pointer jumping: a vertex's label is a vertex id, chase it twice.
        new = jnp.minimum(new, jnp.take_along_axis(new, new, axis=1))
        new = jnp.minimum(new, jnp.take_along_axis(new, new, axis=1))
        return new, jnp.any(new != labels)

    def cond(state):
        return state[1]

    labels, _ = jax.lax.while_loop(
        cond, lambda s: body(s), (labels, jnp.asarray(True))
    )
    return labels


@functools.partial(jax.jit, static_argnames=())
def swendsen_wang_sweep(
    spins: jax.Array,
    key: jax.Array,
    beta: jax.Array,
    tables: GraphTables,
) -> jax.Array:
    """One Swendsen-Wang sweep on an arbitrary weighted graph.

    ``beta`` may be scalar or ``f32[R]``.
    """
    R, N = spins.shape
    beta = jnp.asarray(beta, jnp.float32)
    bcol = beta[:, None] if beta.ndim else beta

    k_bond, k_flip, k_acc = jax.random.split(key, 3)
    s = sigma(spins)
    va = tables.edges[:, 0]
    vb = tables.edges[:, 1]
    j = tables.ej  # [E]
    satisfied = j[None, :] * s[:, va] * s[:, vb] < 0.0  # [R, E]
    p_act = 1.0 - jnp.exp(-2.0 * bcol * jnp.abs(j)[None, :])
    active = satisfied & (jax.random.uniform(k_bond, satisfied.shape) < p_act)

    labels = _connected_components(active, tables.edges, N)

    # Per-cluster flip decision, keyed by cluster root id.
    coin = jax.random.bernoulli(k_flip, 0.5, (R, N))
    flip = jnp.take_along_axis(coin, labels, axis=1)  # [R, N]

    has_bias = jnp.any(tables.biases != 0.0)

    def biased(flip):
        # dE_bias of flipping cluster c = sum_{v in c} 2 h_v sigma_v.
        de_v = 2.0 * tables.biases[None, :] * s  # [R, N]
        de_c = jnp.zeros((R, N), jnp.float32).at[
            jnp.arange(R)[:, None], labels
        ].add(de_v)
        u = jax.random.uniform(k_acc, (R, N))
        acc_c = u < jnp.exp(-bcol * jnp.maximum(de_c, 0.0))
        return flip & jnp.take_along_axis(acc_c, labels, axis=1)

    flip = jax.lax.cond(has_bias, biased, lambda f: f, flip)
    return spins ^ flip


@functools.partial(jax.jit, static_argnames=("nsweeps", "measure"))
def swendsen_wang_run(
    spins: jax.Array,
    key: jax.Array,
    beta: jax.Array,
    tables: GraphTables,
    nsweeps: int,
    measure: bool = False,
):
    """Fused driver: ``nsweeps`` SW sweeps under one jit; optionally returns
    per-sweep energies ``f32[T, R]``."""
    from isingmontecarlo_tpu.classical.metropolis import energy

    def body(carry, _):
        spins, key = carry
        key, sub = jax.random.split(key)
        spins = swendsen_wang_sweep(spins, sub, beta, tables)
        out = energy(spins, tables) if measure else None
        return (spins, key), out

    (spins, _), es = jax.lax.scan(body, (spins, key), None, length=nsweeps)
    return spins, es


@functools.partial(jax.jit, static_argnames=())
def wolff_sweep(
    spins: jax.Array,
    key: jax.Array,
    beta: jax.Array,
    tables: GraphTables,
) -> jax.Array:
    """Wolff single-cluster update, one cluster per replica.

    Implemented as Swendsen-Wang bond activation followed by flipping only the
    component containing a random seed site — equivalent in distribution to
    growing a single Wolff cluster (without bias fields).
    """
    R, N = spins.shape
    beta = jnp.asarray(beta, jnp.float32)
    bcol = beta[:, None] if beta.ndim else beta

    k_bond, k_seed = jax.random.split(key)
    s = sigma(spins)
    va = tables.edges[:, 0]
    vb = tables.edges[:, 1]
    j = tables.ej
    satisfied = j[None, :] * s[:, va] * s[:, vb] < 0.0
    p_act = 1.0 - jnp.exp(-2.0 * bcol * jnp.abs(j)[None, :])
    active = satisfied & (jax.random.uniform(k_bond, satisfied.shape) < p_act)

    labels = _connected_components(active, tables.edges, N)
    seed = jax.random.randint(k_seed, (R,), 0, N)
    seed_label = labels[jnp.arange(R), seed]  # [R]
    flip = labels == seed_label[:, None]
    return spins ^ flip
