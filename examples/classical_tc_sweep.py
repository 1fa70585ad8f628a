"""BASELINE configs 1-2: classical 2D Ising across the phase transition.

256x256 checkerboard Metropolis (the CUDA kernel on a GPU) swept through
temperatures around the Onsager critical point T_c = 2/ln(1+sqrt(2)) ~ 2.269,
printing energy and |magnetization| per site; then Swendsen-Wang cluster
sweeps at T_c on a 64x64 graph, where single-site dynamics suffer critical
slowing down and cluster moves decorrelate in a handful of sweeps
(``classical/cluster.py``; the reference's worm/edge moves play this role at
``src/classical/graph.rs:122-318``).

Run: python examples/classical_tc_sweep.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.classical.lattice_ising import LatticeIsing
from isingmontecarlo_tpu.classical.metropolis import build_tables
from isingmontecarlo_tpu.classical.cluster import swendsen_wang_run

L, R = 256, 16
TC = 2.0 / np.log(1.0 + np.sqrt(2.0))

print(f"{L}x{L} checkerboard Metropolis, R={R} replicas (T_c ~ {TC:.4f}):")
for t in (1.8, 2.1, TC, 2.5, 3.0):
    # Ordered start: |M| then tracks the spontaneous-magnetization branch
    # (a random start at low T coarsens through long-lived domain walls).
    g = LatticeIsing(
        L, j=-1.0, replicas=R, seed=int(t * 100),
        state=np.ones((L, L), bool),
    )
    g.run_sweeps(400, beta=1.0 / t)
    e = float(jnp.mean(g.get_energy())) / (L * L)
    m = float(jnp.mean(jnp.abs(g.get_magnetization()))) / (L * L)
    print(f"  T={t:5.3f}  E/site={e:+.4f}  |M|/site={m:.4f}")

Lc, Rc = 64, 16
print(f"\n{Lc}x{Lc} Swendsen-Wang at T_c, R={Rc} replicas:")
edges = lattice.square(Lc, Lc, j=-1.0)
tables = build_tables(edges, [0.0] * (Lc * Lc))
key = jax.random.key(7)
spins = jax.random.bernoulli(key, 0.5, (Rc, Lc * Lc))
spins, es = swendsen_wang_run(
    spins, key, jnp.float32(1.0 / TC), tables, 60, measure=True
)
e = float(jnp.mean(es[-20:])) / (Lc * Lc)
print(f"  E/site={e:+.4f} after 60 cluster sweeps "
      f"(Onsager E_c/site = -sqrt(2) ~ -1.4142)")
