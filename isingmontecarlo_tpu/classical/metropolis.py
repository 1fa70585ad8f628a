"""Color-parallel Metropolis updates for classical Ising models.

Semantics mirror the reference (``src/classical/graph.rs``):

- Energy: ``E = sum_edges J * (s_i == s_j ? +1 : -1) + sum_i (s_i ? -h_i : +h_i)``
  (``graph.rs:430-447``; spins map ``true -> +1``).
- Single-spin flip ``dE = -2 * sum_j J_vj * sigma_v sigma_j + 2 h_v sigma_v``
  (``graph.rs:91-119``).
- Metropolis acceptance ``dE <= 0`` always, else ``exp(-beta dE)``
  (``graph.rs:339-347``).
- Paired edge flip: flip both endpoints of an edge, ``dE`` omits the shared
  edge's coupling (``graph.rs:122-153``).

Batched reformulation: instead of one random site per move, all sites of a
graph-color class are updated simultaneously (non-adjacent => independent
acceptances; the sweep over color classes is a valid sequential composition of
parallel Metropolis kernels). Edge flips use an edge coloring (matching classes)
the same way. Everything is batched over a leading replica axis ``R``.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.ops import backend, checkerboard


class GraphTables(NamedTuple):
    """Static (device-resident) compiled form of a classical Ising graph."""

    neigh: jax.Array  # i32[N, D]  padded neighbor indices, -1 = pad
    nj: jax.Array  # f32[N, D]  couplings aligned with neigh
    biases: jax.Array  # f32[N]
    site_color: jax.Array  # i32[N]
    n_site_colors: int  # static
    edges: jax.Array  # i32[E, 2]
    ej: jax.Array  # f32[E]
    edge_color: jax.Array  # i32[E]
    n_edge_colors: int  # static


def build_tables(edges, biases) -> GraphTables:
    nvars = len(biases)
    neigh, nj = lattice.adjacency(nvars, edges)
    site_color = lattice.greedy_coloring(nvars, edges)
    edge_color = lattice.greedy_edge_coloring(nvars, edges)
    ev, ej = lattice.edge_arrays(edges)
    return GraphTables(
        neigh=jnp.asarray(neigh),
        nj=jnp.asarray(nj),
        biases=jnp.asarray(np.asarray(biases, dtype=np.float32)),
        site_color=jnp.asarray(site_color),
        n_site_colors=int(site_color.max()) + 1 if nvars else 1,
        edges=jnp.asarray(ev),
        ej=jnp.asarray(ej),
        edge_color=jnp.asarray(edge_color),
        n_edge_colors=int(edge_color.max()) + 1 if len(edges) else 1,
    )


def sigma(spins: jax.Array) -> jax.Array:
    """bool -> +-1 float32 (true -> +1, matching ``graph.rs:430-447``)."""
    return 2.0 * spins.astype(jnp.float32) - 1.0


def local_field(spins: jax.Array, tables: GraphTables) -> jax.Array:
    """``f32[R, N]``: ``sum_j J_vj sigma_j`` over neighbors of each site."""
    s = sigma(spins)  # [R, N]
    neigh = jnp.where(tables.neigh >= 0, tables.neigh, 0)  # [N, D]
    sn = s[:, neigh]  # [R, N, D]
    w = jnp.where(tables.neigh >= 0, tables.nj, 0.0)  # [N, D]
    # A multiply and sum in f32, not a dot: a GPU may run an f32 dot in
    # TF32 (about three digits), which would round real couplings.
    return jnp.sum(sn * w[None], axis=-1)


def energy(spins: jax.Array, tables: GraphTables) -> jax.Array:
    """Total energy per replica, ``f32[R]`` (``graph.rs:430-447``)."""
    s = sigma(spins)
    bond_e = 0.5 * jnp.sum(local_field(spins, tables) * s, axis=-1)
    bias_e = -jnp.sum(tables.biases[None, :] * s, axis=-1)
    return bond_e + bias_e


def magnetization(spins: jax.Array) -> jax.Array:
    """``sum_i sigma_i`` per replica, ``f32[R]``."""
    return jnp.sum(sigma(spins), axis=-1)


def _accept(key, beta, delta_e, shape):
    """Metropolis acceptance mask (``graph.rs:339-347``)."""
    u = jax.random.uniform(key, shape)
    return u < jnp.exp(-beta * jnp.maximum(delta_e, 0.0))


@functools.partial(jax.jit, static_argnames=("n_colors",))
def _spin_flip_sweep(spins, key, beta, tables: GraphTables, n_colors: int):
    beta = jnp.asarray(beta, jnp.float32)
    beta_col = beta[..., None] if beta.ndim else beta
    for c in range(n_colors):
        key, sub = jax.random.split(key)
        mask = tables.site_color == c  # [N]
        field = local_field(spins, tables)  # [R, N]
        s = sigma(spins)
        delta_e = -2.0 * field * s + 2.0 * tables.biases[None, :] * s
        acc = _accept(sub, beta_col, delta_e, spins.shape)
        spins = jnp.where(mask[None, :] & acc, ~spins, spins)
    return spins


def spin_flip_sweep(
    spins: jax.Array,
    key: jax.Array,
    beta: jax.Array,
    tables: GraphTables,
) -> jax.Array:
    """One full color-parallel Metropolis sweep over all sites.

    Equivalent work to ``nvars`` single-site attempts of ``do_spin_flip``
    (``graph.rs:91-119``), executed color class by color class.
    ``beta`` may be scalar or ``f32[R]`` (per-replica temperatures).
    """
    return _spin_flip_sweep(spins, key, beta, tables, tables.n_site_colors)


@functools.partial(jax.jit, static_argnames=("n_colors",))
def _edge_flip_sweep(spins, key, beta, tables: GraphTables, n_colors: int,
                     attempt_p=None):
    beta = jnp.asarray(beta, jnp.float32)
    beta_col = beta[..., None] if beta.ndim else beta

    va = tables.edges[:, 0]  # [E]
    vb = tables.edges[:, 1]
    for c in range(n_colors):
        key, sub = jax.random.split(key)
        mask = tables.edge_color == c  # [E]
        if attempt_p is not None:
            # Edge importance sampling (graph.rs:321-336 / :131-141): the
            # reference draws the edge for each attempt proportionally to its
            # coupling weight; here each edge in the class attempts with
            # probability w_e / w_max, giving the same attempt-frequency
            # profile per sweep.
            key, ka = jax.random.split(key)
            mask = mask & (
                jax.random.uniform(ka, attempt_p.shape) < attempt_p
            )
        field = local_field(spins, tables)  # [R, N]
        s = sigma(spins)
        # delta_e(v omitting partner) = -2 (field_v - J_e sigma_partner) sigma_v
        #                              + 2 h_v sigma_v        (graph.rs:141-148)
        sa, sb = s[:, va], s[:, vb]
        fa = field[:, va] - tables.ej[None, :] * sb
        fb = field[:, vb] - tables.ej[None, :] * sa
        de = (
            -2.0 * (fa * sa + fb * sb)
            + 2.0 * (tables.biases[va][None, :] * sa + tables.biases[vb][None, :] * sb)
        )
        acc = _accept(sub, beta_col, de, de.shape) & mask[None, :]  # [R, E]
        # Scatter the flips to both endpoints. Matching classes guarantee
        # disjoint endpoints within a class, so a plain XOR-scatter is exact.
        flips = jnp.zeros(spins.shape, dtype=bool)
        flips = flips.at[:, va].max(acc)
        flips = flips.at[:, vb].max(acc)
        spins = spins ^ flips
    return spins


def edge_flip_sweep(
    spins: jax.Array,
    key: jax.Array,
    beta: jax.Array,
    tables: GraphTables,
    attempt_p: jax.Array | None = None,
) -> jax.Array:
    """One matching-parallel paired edge-flip sweep (``graph.rs:122-153``).

    Each strong-matching class flips both endpoints of its edges; ``dE``
    counts each endpoint's neighbor couplings minus the shared edge (which is
    invariant under flipping both endpoints) plus both bias terms.
    ``attempt_p: f32[E]`` enables edge importance sampling.
    """
    return _edge_flip_sweep(
        spins, key, beta, tables, tables.n_edge_colors, attempt_p
    )


@functools.partial(jax.jit, static_argnames=("nsweeps", "n_colors", "measure"))
def _metropolis_run(spins, key, beta, tables, nsweeps, n_colors, measure):
    def body(carry, _):
        spins, key = carry
        key, sub = jax.random.split(key)
        spins = _spin_flip_sweep(spins, sub, beta, tables, n_colors)
        out = energy(spins, tables) if measure else None
        return (spins, key), out

    (spins, _), es = jax.lax.scan(body, (spins, key), None, length=nsweeps)
    return spins, es


def metropolis_run(
    spins: jax.Array,
    key: jax.Array,
    beta: jax.Array,
    tables: GraphTables,
    nsweeps: int,
    measure: bool = False,
):
    """Fused driver: ``nsweeps`` Metropolis sweeps under one jit; optionally
    returns per-sweep energies ``f32[T, R]``."""
    return _metropolis_run(
        spins, key, beta, tables, nsweeps, tables.n_site_colors, measure
    )


# ---------------------------------------------------------------------------
# Fast path: uniform 2D periodic lattice as [R, L, L] with checkerboard sweeps.
# This is the kernel behind the 256^2 classical benchmark (BASELINE.md).
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=())
def checkerboard_sweep(
    spins: jax.Array,  # bool[R, L, L]
    key: jax.Array,
    beta: jax.Array,
    j: jax.Array,
    h: jax.Array,
) -> jax.Array:
    """One full checkerboard Metropolis sweep on a periodic square lattice.

    Uniform coupling ``j`` and field ``h``; spins as ``bool[R, L, L]``.
    Two half-sweeps (even/odd parity).
    """
    R, L, _ = spins.shape
    yy = jax.lax.broadcasted_iota(jnp.int32, (L, L), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (L, L), 1)
    parity = (xx + yy) % 2

    beta = jnp.asarray(beta, jnp.float32)
    bcol = beta[..., None, None] if beta.ndim else beta

    for par in range(2):
        key, sub = jax.random.split(key)
        s = sigma(spins)
        nsum = (
            jnp.roll(s, 1, axis=-1)
            + jnp.roll(s, -1, axis=-1)
            + jnp.roll(s, 1, axis=-2)
            + jnp.roll(s, -1, axis=-2)
        )
        de = -2.0 * j * nsum * s + 2.0 * h * s
        u = jax.random.uniform(sub, spins.shape)
        acc = u < jnp.exp(-bcol * jnp.maximum(de, 0.0))
        spins = jnp.where((parity == par)[None] & acc, ~spins, spins)
    return spins


def lattice_multi_sweep(
    spins: jax.Array,  # bool[R, L, L]
    seed: int,
    beta,
    j,
    h,
    nsweeps: int,
) -> jax.Array:
    """``nsweeps`` checkerboard sweeps: the CUDA shared-memory kernel on a
    GPU for lattices it takes (``ops.checkerboard.kernel_supports``; one
    device-memory load and store in all), otherwise the fused XLA scan. The
    two draw different random streams (Philox vs threefry) and sample the
    same chain statistically."""
    L = spins.shape[-1]
    if backend.gpu_kernels() and checkerboard.kernel_supports(L):
        if isinstance(seed, int):
            seed = np.uint32(seed % (1 << 32))
        return checkerboard.checkerboard_multi_sweep(
            spins, seed, checkerboard.thresholds(beta, j, h), nsweeps,
        )

    return _lattice_scan(
        spins, jax.random.key(seed), jnp.float32(beta), jnp.float32(j),
        jnp.float32(h), nsweeps,
    )


@functools.partial(jax.jit, static_argnames=("nsweeps",))
def _lattice_scan(spins, key, beta, j, h, nsweeps: int):
    """``nsweeps`` XLA checkerboard sweeps (threefry uniforms) in one scan."""

    def body(carry, _):
        sp, key = carry
        key, sub = jax.random.split(key)
        return (checkerboard_sweep(sp, sub, beta, j, h), key), None

    (sp, _), _ = jax.lax.scan(body, (spins, key), None, length=nsweeps)
    return sp


def lattice_energy(spins: jax.Array, j: jax.Array, h: jax.Array) -> jax.Array:
    """Energy per replica for the uniform periodic lattice fast path."""
    s = sigma(spins)
    e_bond = j * (
        jnp.sum(s * jnp.roll(s, -1, axis=-1), axis=(-1, -2))
        + jnp.sum(s * jnp.roll(s, -1, axis=-2), axis=(-1, -2))
    )
    e_bias = -h * jnp.sum(s, axis=(-1, -2))
    return e_bond + e_bias
