#!/usr/bin/env python
"""Binder-cumulant crossing at the 2D Ising critical point.

Demonstrates the observable estimators (analysis/observables.py) on the
classical engine: for each lattice size, sweep temperatures around
T_c = 2/ln(1+sqrt(2)) ~ 2.269 and print U4 = 1 - <m^4>/(3<m^2>^2) averaged
over replicas. Curves for different L cross near T_c (standard
finite-size-scaling diagnostic; the reference leaves observables to the
caller — ``timesteps_sample``, ``qmc_stepper.rs:23-40``).

Usage: python examples/binder_crossing.py [sweeps] [replicas]
"""
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np

import jax
import jax.numpy as jnp

from isingmontecarlo_tpu.analysis import binder_cumulant
from isingmontecarlo_tpu.classical import metropolis

SWEEPS = int(sys.argv[1]) if len(sys.argv) > 1 else 400
R = int(sys.argv[2]) if len(sys.argv) > 2 else 64
TC = 2.0 / np.log(1.0 + np.sqrt(2.0))
TEMPS = [2.0, 2.15, TC, 2.4, 2.6]
SIZES = [8, 16]

print(f"device: {jax.devices()[0]}  (T_c = {TC:.4f})", file=sys.stderr)
print(f"{'T':>6} " + " ".join(f"U4(L={L})" for L in SIZES))
for T in TEMPS:
    row = []
    for L in SIZES:
        key = jax.random.key(L * 1000 + int(T * 100))
        key, k0 = jax.random.split(key)
        spins = jax.random.bernoulli(k0, 0.5, (R, L, L))
        beta = jnp.float32(1.0 / T)
        # Equilibrate, then sample.
        for _ in range(SWEEPS):
            key, sub = jax.random.split(key)
            spins = metropolis.checkerboard_sweep(spins, sub, beta,
                                                  jnp.float32(-1.0),
                                                  jnp.float32(0.0))
        samples = []
        for _ in range(SWEEPS // 4):
            key, sub = jax.random.split(key)
            spins = metropolis.checkerboard_sweep(spins, sub, beta,
                                                  jnp.float32(-1.0),
                                                  jnp.float32(0.0))
            samples.append(spins)
        stacked = jnp.stack(samples).reshape(len(samples), R, L * L)
        u4 = float(jnp.mean(binder_cumulant(stacked)))
        row.append(u4)
    print(f"{T:6.3f} " + " ".join(f"{u: 8.4f}" for u in row))
print("expect: U4 -> 2/3 below T_c, -> 0 above; curves cross near T_c")
