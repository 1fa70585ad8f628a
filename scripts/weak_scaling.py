#!/usr/bin/env python
"""Weak/strong-scaling table for the sharded tempering chunk: ms/sweep of
``tempering_sweep_chunk_sharded`` at fixed R while the replica axis shards
over 1, 2, 4, 8 devices. The collectives audit (scripts/collectives_audit.py)
shows what moves; this records how it scales. On the virtual CPU mesh the
numbers show the sharding overhead's structure, not device throughput.

Run with (virtual CPU mesh):
  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python scripts/weak_scaling.py [L] [R,R,...] [nsweeps]
"""
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.parallel.tempering import (
    tempering_sweep_chunk_sharded,
)
from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep

L = int(sys.argv[1]) if len(sys.argv) > 1 else 8
R_LIST = (
    tuple(int(r) for r in sys.argv[2].split(","))
    if len(sys.argv) > 2
    else (64, 512)
)
NS = int(sys.argv[3]) if len(sys.argv) > 3 else 4

devs = jax.devices()
assert len(devs) >= 8, (
    "run with XLA_FLAGS=--xla_force_host_platform_device_count=8"
)
edges = lattice.bench_two_d_periodic(L)

for R in R_LIST:
    g = QmcIsingGraph(edges, transverse=1.0, replicas=R, seed=7)
    beta0 = jnp.float32(1.0)
    for _ in range(6):
        g.sse, ns, _, _ = multi_sweep(g.sse, beta0, g.model, 2)
        float(jnp.sum(ns))
        g._maybe_grow()
    betas = jnp.asarray(np.linspace(0.8, 1.6, R), jnp.float32)
    scales = jnp.ones((R, g.model.nbonds), jnp.float32)
    do_swap = jnp.ones((NS,), bool)
    for nd in (1, 2, 4, 8):
        mesh = Mesh(np.array(devs[:nd]), axis_names=("replicas",))

        def run(sse):
            return tempering_sweep_chunk_sharded(
                sse, betas, scales, jnp.int32(0), do_swap, g.model, NS,
                mesh=mesh, hetero=True,
            )

        out = run(g.sse)  # compile
        jax.block_until_ready(out[0].ops.bond)
        best = 1e9
        for _ in range(3):
            t0 = time.perf_counter()
            out = run(g.sse)
            jax.block_until_ready(out[0].ops.bond)
            best = min(best, time.perf_counter() - t0)
        print(
            f"L={L} R={R:<4} devices={nd}  {best / NS * 1e3:8.2f} ms/sweep"
            f"  (cutoff={g.cutoff}, nswaps={int(out[6])})",
            flush=True,
        )
