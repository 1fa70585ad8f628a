"""Lattice / graph utilities.

The reference represents couplings as ``Vec<((usize, usize), f64)>`` edge lists
(``src/classical/graph.rs:53``, ``src/sse/qmc_ising.rs:80-95``). This build
keeps the same user-facing edge-list convention but compiles it into dense,
fixed-shape tables:

- ``edges: i32[E, 2]`` + ``couplings: f32[E]`` — the bond table.
- padded CSR adjacency ``neigh: i32[N, D]`` / ``nj: f32[N, D]`` — per-site
  neighbor lists padded to the max degree (pad index ``-1``), used by the
  classical engine for gather-based local-energy evaluation.
- greedy graph colorings — the parallel-update replacement for the reference's
  random sequential site picks: all sites of one color are updated
  simultaneously (they are mutually non-adjacent, so detailed balance holds
  color-by-color).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

Edge = tuple[int, int]


def nvars_from_edges(edges: Sequence[tuple[Edge, float]]) -> int:
    """Number of variables = max index + 1 (reference ``qmc_ising.rs:92``)."""
    return max(max(a, b) for (a, b), _ in edges) + 1


def edge_arrays(
    edges: Sequence[tuple[Edge, float]],
) -> tuple[np.ndarray, np.ndarray]:
    """Split an edge list into ``(i32[E,2], f32[E])`` arrays."""
    ev = np.asarray([[a, b] for (a, b), _ in edges], dtype=np.int32)
    ej = np.asarray([j for _, j in edges], dtype=np.float32)
    return ev, ej


def adjacency(
    nvars: int,
    edges: Sequence[tuple[Edge, float]],
) -> tuple[np.ndarray, np.ndarray]:
    """Padded per-site adjacency (the reference's ``binding_mat``,
    ``graph.rs:69-80``, as dense padded tables).

    Returns ``(neigh, nj)`` with shapes ``[N, D]``; ``neigh == -1`` marks
    padding and ``nj`` is zero there. Uses the native C++ graph compiler when
    available (:mod:`isingmontecarlo_tpu.native`), else pure Python.
    """
    from isingmontecarlo_tpu import native

    ev, ej = edge_arrays(edges)
    out = native.adjacency(nvars, ev, ej) if len(edges) else None
    if out is not None:
        return out
    lists: list[list[tuple[int, float]]] = [[] for _ in range(nvars)]
    for (a, b), j in edges:
        lists[a].append((b, j))
        lists[b].append((a, j))
    for l in lists:
        l.sort(key=lambda t: t[0])
    deg = max((len(l) for l in lists), default=0)
    deg = max(deg, 1)
    neigh = np.full((nvars, deg), -1, dtype=np.int32)
    nj = np.zeros((nvars, deg), dtype=np.float32)
    for v, l in enumerate(lists):
        for d, (ov, j) in enumerate(l):
            neigh[v, d] = ov
            nj[v, d] = j
    return neigh, nj


def greedy_coloring(nvars: int, edges: Sequence[tuple[Edge, float]]) -> np.ndarray:
    """Greedy vertex coloring; returns ``i32[N]`` color ids.

    Sites sharing a color are non-adjacent, so they can be Metropolis-updated
    in parallel (the batched replacement for the reference's one-random-site
    updates, ``graph.rs:91-119``).
    """
    from isingmontecarlo_tpu import native

    if edges:
        ev, _ = edge_arrays(edges)
        out = native.vertex_coloring(nvars, ev)
        if out is not None:
            return out
    adj: list[set[int]] = [set() for _ in range(nvars)]
    for (a, b), _ in edges:
        adj[a].add(b)
        adj[b].add(a)
    colors = np.full(nvars, -1, dtype=np.int32)
    order = sorted(range(nvars), key=lambda v: -len(adj[v]))
    for v in order:
        used = {colors[u] for u in adj[v] if colors[u] >= 0}
        c = 0
        while c in used:
            c += 1
        colors[v] = c
    return colors


def greedy_edge_coloring(
    nvars: int, edges: Sequence[tuple[Edge, float]]
) -> np.ndarray:
    """Greedy *strong* (distance-2) edge coloring.

    Used to parallelize the reference's paired edge flips
    (``graph.rs:122-153``). Edges of one color must not share vertices *and*
    must not have endpoints adjacent to each other's endpoints: flipping edge
    (a, b) changes the local field at every neighbor of a and b, so only
    distance-2-separated edges have independent Metropolis factors and may be
    accepted simultaneously.
    """
    from isingmontecarlo_tpu import native

    if edges:
        ev, _ = edge_arrays(edges)
        out = native.edge_coloring(nvars, ev)
        if out is not None:
            return out
    adj: list[set[int]] = [set() for _ in range(nvars)]
    for (a, b), _ in edges:
        adj[a].add(b)
        adj[b].add(a)
    colors = np.full(len(edges), -1, dtype=np.int32)
    # Colors forbidden at each vertex: colors of edges incident to the vertex
    # or incident to any of its neighbors.
    vert_used: list[set[int]] = [set() for _ in range(nvars)]
    for e, ((a, b), _) in enumerate(edges):
        used: set[int] = set()
        for v in (a, b):
            used |= vert_used[v]
            for u in adj[v]:
                used |= vert_used[u]
        c = 0
        while c in used:
            c += 1
        colors[e] = c
        vert_used[a].add(c)
        vert_used[b].add(c)
    return colors


# ---------------------------------------------------------------------------
# Standard lattices (the reference constructs these ad hoc in tests/benches,
# e.g. benches/end_to_end.rs:96-166 builds periodic frustrated 2D lattices).
# ---------------------------------------------------------------------------


def chain(L: int, j: float = 1.0, periodic: bool = True) -> list[tuple[Edge, float]]:
    """1D chain/ring with uniform coupling."""
    edges = [(((v, v + 1)), j) for v in range(L - 1)]
    if periodic and L > 2:
        edges.append(((L - 1, 0), j))
    return edges


def square(
    Lx: int,
    Ly: int,
    j: float = 1.0,
    periodic: bool = True,
) -> list[tuple[Edge, float]]:
    """2D square lattice with uniform coupling, row-major site indexing."""

    def idx(x: int, y: int) -> int:
        return (y % Ly) * Lx + (x % Lx)

    edges = []
    for y in range(Ly):
        for x in range(Lx):
            if periodic or x + 1 < Lx:
                edges.append(((idx(x, y), idx(x + 1, y)), j))
            if periodic or y + 1 < Ly:
                edges.append(((idx(x, y), idx(x, y + 1)), j))
    # Dedup for tiny open/periodic overlaps (Lx or Ly <= 2).
    seen = set()
    out = []
    for (a, b), jj in edges:
        k = (min(a, b), max(a, b))
        if a != b and k not in seen:
            seen.add(k)
            out.append(((a, b), jj))
    return out


def bench_two_d_periodic(l: int) -> list[tuple[Edge, float]]:
    """The reference benchmark lattice, mirrored exactly
    (``benches/end_to_end.rs:12-30``): L x L periodic, right couplings -1,
    down couplings +1/-1 by column parity (every plaquette frustrated).
    Used by ``bench.py --suite`` and the single-core C++ denominator
    (``native/ref_single_core.cpp``) so the two measure identical physics."""

    def f(i: int, j: int) -> int:
        return j * l + i

    edges: list[tuple[Edge, float]] = []
    for j in range(l):
        for i in range(l):
            edges.append(((f(i, j), f((i + 1) % l, j)), -1.0))
    for j in range(l):
        for i in range(l):
            edges.append(((f(i, j), f(i, (j + 1) % l)), 1.0 if i % 2 == 0 else -1.0))
    return edges


def frustrated_square(
    Lx: int, Ly: int, j: float = 1.0, periodic: bool = True
) -> list[tuple[Edge, float]]:
    """2D periodic lattice with alternating-sign couplings, mirroring the
    frustrated benchmark lattices of ``benches/end_to_end.rs:100-118`` (sign
    depends on parity of the site coordinates)."""

    def idx(x: int, y: int) -> int:
        return (y % Ly) * Lx + (x % Lx)

    edges = []
    for y in range(Ly):
        for x in range(Lx):
            sx = j if (x + y) % 2 == 0 else -j
            if periodic or x + 1 < Lx:
                edges.append(((idx(x, y), idx(x + 1, y)), sx))
            if periodic or y + 1 < Ly:
                edges.append(((idx(x, y), idx(x, y + 1)), -sx))
    seen = set()
    out = []
    for (a, b), jj in edges:
        k = (min(a, b), max(a, b))
        if a != b and k not in seen:
            seen.add(k)
            out.append(((a, b), jj))
    return out
