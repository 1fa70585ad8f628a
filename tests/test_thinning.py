"""Round-4 program-size reductions must be behavior-preserving:

- ``multi_sweep(cluster_every=k)`` runs the nested-scan form (no per-sweep
  cond; full blocks + a cluster-less tail for any ``nsweeps % k``); it must
  be bit-identical to the explicit sweep-by-sweep composition with the same
  flag schedule.
- ``_cluster_update_impl`` with host caps skips (all-False flips) on cap
  overflow instead of running a full-size fallback pipeline; with ample
  caps it is bit-identical to the cap-less full path.
"""

import jax
import jax.numpy as jnp
import pytest

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.sse import cluster as _cluster
from isingmontecarlo_tpu.sse import opstring as _ops
from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep, sweep


def _equilibrated(replicas=4, seed=3, nsweeps=6):
    g = QmcIsingGraph(
        lattice.square(4, 4, j=1.0), transverse=1.0, cutoff=96,
        replicas=replicas, seed=seed,
    )
    beta = jnp.float32(1.0)
    g.sse, _, _, _ = multi_sweep(g.sse, beta, g.model, nsweeps)
    return g, beta


@pytest.mark.parametrize("k,ns", [(3, 6), (3, 7), (4, 3)])
def test_nested_thinning_bit_identical_to_sweep_composition(k, ns):
    # ns % k != 0 exercises the cluster-less tail scan (the per-sweep cond
    # fallback it replaced compiled a double-size program); ns < k exercises
    # the zero-block case.
    g, beta = _equilibrated()
    sse_a, ns_a, _, succ_a = multi_sweep(
        g.sse, beta, g.model, ns, cluster_every=k
    )
    # Ground truth: the same schedule, composed sweep by sweep.
    sse_b = g.sse
    ns_rows = []
    succ_b = jnp.zeros((g.replicas,), jnp.int32)
    for i in range(ns):
        sse_b, s = sweep(
            sse_b, beta, g.model, do_cluster=(i % k == k - 1)
        )
        succ_b = succ_b + s
        ns_rows.append(_ops.op_count(sse_b.ops))
    assert jnp.array_equal(ns_a, jnp.stack(ns_rows))
    assert jnp.array_equal(succ_a, succ_b)
    assert jnp.array_equal(sse_a.ops.bond, sse_b.ops.bond)
    assert jnp.array_equal(sse_a.ops.inputs, sse_b.ops.inputs)
    assert jnp.array_equal(sse_a.ops.outputs, sse_b.ops.outputs)
    assert jnp.array_equal(sse_a.state, sse_b.state)


@pytest.mark.parametrize("k,ns", [(1, 6), (3, 7)])
def test_traced_cluster_flags_bit_identical_to_static_schedule(k, ns):
    """``cluster_flags`` (traced schedule; ONE compiled program for every
    thinning factor, the compile-cost fix for the 32² k-ladder) must be
    bit-identical to the static ``cluster_every=k`` form."""
    g, beta = _equilibrated()
    sse_a, ns_a, _, succ_a = multi_sweep(
        g.sse, beta, g.model, ns, cluster_every=k
    )
    flags = jnp.arange(ns, dtype=jnp.int32) % k == k - 1
    sse_b, ns_b, _, succ_b = multi_sweep(
        g.sse, beta, g.model, ns, cluster_flags=flags
    )
    assert jnp.array_equal(ns_a, ns_b)
    assert jnp.array_equal(succ_a, succ_b)
    assert jnp.array_equal(sse_a.ops.bond, sse_b.ops.bond)
    assert jnp.array_equal(sse_a.state, sse_b.state)


def test_nested_thinning_collect_states_shape_and_order():
    g, beta = _equilibrated()
    _, ns_a, st_a, _ = multi_sweep(
        g.sse, beta, g.model, 4, cluster_every=2, collect_states=True
    )
    _, ns_b, st_b, _ = multi_sweep(
        g.sse, beta, g.model, 4, cluster_every=1, collect_states=True
    )
    assert st_a.shape == st_b.shape == (4, g.replicas, g.nvars)
    assert ns_a.shape == (4, g.replicas)


def test_cluster_caps_ample_matches_full_path():
    g, beta = _equilibrated()
    key = jax.random.key(11)
    M = g.cutoff
    S = M + g.nvars + 1
    ops_f, st_f = _cluster.cluster_update(
        g.sse.ops, g.sse.state, key, g.model
    )
    # Ample explicit caps: compact branch taken, same labels -> same flips.
    lc = 16 * (-(-(S // 2) // 16))
    ec = g.model.max_legs * M  # generous
    ops_c, st_c = _cluster.cluster_update(
        g.sse.ops, g.sse.state, key, g.model, label_cap=lc, edge_cap=ec
    )
    assert jnp.array_equal(ops_f.inputs, ops_c.inputs)
    assert jnp.array_equal(ops_f.outputs, ops_c.outputs)
    assert jnp.array_equal(st_f, st_c)


def test_cluster_cap_overflow_skips_not_corrupts():
    g, beta = _equilibrated()
    key = jax.random.key(11)
    # Absurdly small caps: overflow guaranteed -> the update must be a
    # no-op (valid thinner schedule), never a mislabeled flip.
    sg = _cluster.segment_graph(g.sse.ops, g.model)
    assert int(jnp.max(sg.nseg)) > 15, "state too small to overflow cap=16"
    ops_s, st_s = _cluster.cluster_update(
        g.sse.ops, g.sse.state, key, g.model, label_cap=16, edge_cap=16
    )
    assert jnp.array_equal(ops_s.inputs, g.sse.ops.inputs)
    assert jnp.array_equal(ops_s.outputs, g.sse.ops.outputs)
    assert jnp.array_equal(st_s, g.sse.state)
