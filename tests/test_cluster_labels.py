"""Partition oracle for the segment-contracted cluster labeling.

The batched cluster construction (``sse/cluster.py``) must produce the
same partition of op sides as the reference's BFS cluster expansion
(``src/sse/qmc_traits/cluster.rs:193-271``): sides of one op connect unless
the op is a cluster edge (constant single-var op,  ``cluster.rs:276-286``),
and worldline neighbors connect periodically. This test checks label
equivalence against a brute-force union-find on op strings produced by real
sweeps.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.sse import cluster as _cluster
from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep


def brute_partition(bond, is_const_tab, bond_vars):
    """Union-find over op sides (node 2p = in side, 2p+1 = out side)."""
    M = bond.shape[0]
    parent = list(range(2 * M))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    def union(a, b):
        ra, rb = find(a), find(b)
        if ra != rb:
            parent[max(ra, rb)] = min(ra, rb)

    per_var = {}
    for p in range(M):
        b = bond[p]
        if b < 0:
            continue
        vs = [v for v in bond_vars[b] if v >= 0]
        if not (bool(is_const_tab[b]) and len(vs) == 1):
            union(2 * p, 2 * p + 1)
        for v in vs:
            per_var.setdefault(v, []).append(p)
    for ps in per_var.values():
        for i, p in enumerate(ps):
            union(2 * p + 1, 2 * ps[(i + 1) % len(ps)])
    return [find(2 * p) for p in range(M)], [find(2 * p + 1) for p in range(M)]


@pytest.mark.parametrize(
    "L,beta,transverse,longitudinal,seed",
    [
        (3, 1.0, 1.0, 0.0, 0),
        (3, 2.0, 0.7, 0.3, 1),
        (4, 1.0, 1.5, 0.0, 2),
        (4, 0.5, 1.0, 0.5, 3),
        (2, 4.0, 2.0, 0.0, 4),
    ],
)
def test_labels_match_union_find(L, beta, transverse, longitudinal, seed):
    edges = lattice.frustrated_square(L, L)
    g = QmcIsingGraph(
        edges, transverse=transverse, longitudinal=longitudinal,
        replicas=4, seed=seed,
    )
    g.sse, _, _, _ = multi_sweep(g.sse, jnp.float32(beta), g.model, 12)
    g._maybe_grow()
    ops, model = g.sse.ops, g.model
    labels = np.asarray(_cluster.cluster_labels(ops, model))  # [2M, R]
    bond = np.asarray(ops.bond)
    bv = np.asarray(model.bond_vars)
    ic = np.asarray(model.is_constant)
    M, R = bond.shape
    for r in range(R):
        ref_in, ref_out = brute_partition(bond[:, r], ic, bv)
        fwd, bwd = {}, {}
        for p in range(M):
            if bond[p, r] < 0:
                continue
            for ref_l, got_l in (
                (ref_in[p], labels[2 * p, r]),
                (ref_out[p], labels[2 * p + 1, r]),
            ):
                assert fwd.setdefault(ref_l, got_l) == got_l, f"r={r} p={p}"
                assert bwd.setdefault(got_l, ref_l) == ref_l, f"r={r} p={p}"


def test_labels_large_m_compact_branch():
    """A cutoff large enough that the compact label branch actually runs
    (``_compacted_labels`` falls back to the full-size loop when the static
    cap would not shrink the problem): S = M + N + 1 must exceed
    ``max(256, S//2) + 64``. Same brute-force partition oracle."""
    edges = lattice.frustrated_square(4, 4)
    g = QmcIsingGraph(edges, transverse=1.2, replicas=4, seed=5, cutoff=640)
    g.sse, _, _, _ = multi_sweep(g.sse, jnp.float32(2.0), g.model, 10)
    ops, model = g.sse.ops, g.model
    M = ops.bond.shape[0]
    S = M + model.nvars + 1
    C = max(256, 16 * (-(-(S // 2) // 16)))
    assert C + 64 < S, (C, S)  # compact branch is reachable at this size
    labels = np.asarray(_cluster.cluster_labels(ops, model))
    bond = np.asarray(ops.bond)
    bv = np.asarray(model.bond_vars)
    ic = np.asarray(model.is_constant)
    _, R = bond.shape
    for r in range(R):
        ref_in, ref_out = brute_partition(bond[:, r], ic, bv)
        fwd, bwd = {}, {}
        for p in range(M):
            if bond[p, r] < 0:
                continue
            for ref_l, got_l in (
                (ref_in[p], labels[2 * p, r]),
                (ref_out[p], labels[2 * p + 1, r]),
            ):
                assert fwd.setdefault(ref_l, got_l) == got_l, f"r={r} p={p}"
                assert bwd.setdefault(got_l, ref_l) == ref_l, f"r={r} p={p}"


def test_head_f_has_op_matches_leg_scatter():
    """The sweep driver derives the free-spin occupation map from the
    segment graph (``head_f < K*M``); it must equal the per-leg scatter that
    ``resample_free_spins`` builds when no map is passed."""
    import jax

    from isingmontecarlo_tpu.sse import opstring as _ops

    edges = lattice.frustrated_square(3, 3)
    # Low transverse field + tiny beta leaves some vars op-free.
    g = QmcIsingGraph(edges, transverse=0.2, replicas=8, seed=13)
    g.sse, _, _, _ = multi_sweep(g.sse, jnp.float32(0.05), g.model, 6)
    ops, model = g.sse.ops, g.model

    sg = _cluster.segment_graph(ops, model)
    KM = ops.max_legs * ops.bond.shape[0]
    has_op_sg = np.asarray((sg.head_f < KM).T)

    vars_ = _ops.op_vars(ops, model)
    ref = np.zeros((ops.replicas, model.nvars), bool)
    v = np.asarray(vars_)
    for r in range(ops.replicas):
        for val in v[:, :, r].ravel():
            if val >= 0:
                ref[r, val] = True
    assert not ref.all(), "test needs at least one op-free var"
    assert np.array_equal(has_op_sg, ref)


def test_wrap_einsum_matches_scatter_fallback(monkeypatch):
    """``segment_graph``'s wrap-edge/head-index digit-plane einsum branch
    must equal the scatter fallback (which production only reaches at
    footprints beyond the gate, e.g. 32^2)."""
    edges = lattice.frustrated_square(4, 4)
    g = QmcIsingGraph(edges, transverse=1.2, replicas=8, seed=9)
    g.sse, _, _, _ = multi_sweep(g.sse, jnp.float32(1.5), g.model, 10)
    g._maybe_grow()
    ops, model = g.sse.ops, g.model

    sg_einsum = _cluster.segment_graph(ops, model)
    monkeypatch.setattr(_cluster, "_WRAP_EINSUM_MAX", 0)
    sg_scatter = _cluster.segment_graph(ops, model)

    for name in ("seg_in", "seg_out", "u", "v", "nseg", "head_f"):
        a = np.asarray(getattr(sg_einsum, name))
        b = np.asarray(getattr(sg_scatter, name))
        assert np.array_equal(a, b), name
