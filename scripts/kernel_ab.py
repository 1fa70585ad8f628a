#!/usr/bin/env python
"""Each CUDA kernel against the plain-XLA path it replaces, on one GPU.

For the checkerboard kernel (256^2, R=64) and the diagonal-update carry
kernel (32^2 SSE benchmark lattice, R=512, beta=1, M ~ 7,000) this checks
the kernel bit for bit against its reference, then times the kernel, the
XLA path it replaces, and the end-to-end step that contains it, both ways
(``ops.backend.plain_xla`` switches the kernels off). Prints one line per
measurement with the card's name and power limit.

Usage: python scripts/kernel_ab.py [--reps N]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from isingmontecarlo_tpu import compile_cache, lattice  # noqa: E402
from isingmontecarlo_tpu.classical import metropolis as _metro  # noqa: E402
from isingmontecarlo_tpu.ops import backend, checkerboard, diag_carry  # noqa: E402
from isingmontecarlo_tpu.sse import diagonal as _diag  # noqa: E402
from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep  # noqa: E402
from isingmontecarlo_tpu.sse.opstring import op_count  # noqa: E402


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def timed(fn, *args, reps: int):
    """(first-call seconds, median steady milliseconds) of ``fn(*args)``."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, float(np.median(ts)) * 1e3


def report(label, first, ms, extra=""):
    print(f"{label:<52} compile+first {first:7.2f} s  steady {ms:10.4f} ms"
          f"{extra}", flush=True)


def classical(reps: int, L: int = 256, R: int = 64, NS: int = 100) -> None:
    spins = jax.random.bernoulli(jax.random.key(0), 0.5, (R, L, L))
    thr = checkerboard.thresholds(0.44, -1.0, 0.0)
    seed = np.uint32(12345)
    a = checkerboard.checkerboard_multi_sweep(spins, seed, thr, 10)
    b = checkerboard.checkerboard_twin(spins, seed, thr, 10)
    same = bool(jnp.array_equal(a, b))
    print(f"checkerboard kernel == jnp twin (L={L}, R={R}, 10 sweeps): {same}",
          flush=True)
    assert same
    run = jax.jit(
        lambda s: _metro.lattice_multi_sweep(s, 7, 0.44, -1.0, 0.0, NS)
    )
    first, ms = timed(run, spins, reps=reps)
    rate = R * L * L * NS / (ms * 1e-3)
    report(f"classical {L}^2 R={R} x{NS} sweeps: kernel", first, ms,
           f"  {rate:.4e} attempts/s")
    with backend.plain_xla():
        run = jax.jit(
            lambda s: _metro.lattice_multi_sweep(s, 7, 0.44, -1.0, 0.0, NS)
        )
        first, ms = timed(run, spins, reps=reps)
    rate = R * L * L * NS / (ms * 1e-3)
    report(f"classical {L}^2 R={R} x{NS} sweeps: XLA threefry", first, ms,
           f"  {rate:.4e} attempts/s")


def sse(reps: int, L: int = 32, R: int = 512, cutoff: int = 7040) -> None:
    g = QmcIsingGraph(lattice.bench_two_d_periodic(L), transverse=1.0,
                      replicas=R, seed=7, cutoff=cutoff)
    beta = jnp.float32(1.0)
    for _ in range(3):
        g.sse, ns, _, _ = multi_sweep(g.sse, beta, g.model, 4)
        g._maybe_grow()
    caps = g._cluster_caps
    ops, state, model = g.sse.ops, g.sse.state, g.model
    M = ops.bond.shape[0]
    print(f"{L}^2 R={R}: cutoff M={M}, mean n={float(jnp.mean(op_count(ops))):.0f}",
          flush=True)
    key = jax.random.key(3)
    hbt = _diag.make_heatbath_tables(model)

    def diag(heatbath):
        return jax.jit(lambda o: _diag._diagonal_update_fast(
            o, state, beta, key, model, hb=hbt if heatbath else None,
            heatbath=heatbath))

    outs = {}
    for hb in (False, True):
        name = "heat-bath" if hb else "Metropolis"
        f = diag(hb)
        outs[hb] = f(ops)
        first, ms = timed(f, ops, reps=reps)
        report(f"diagonal update {name}: carry kernel", first, ms)
    with backend.plain_xla():
        for hb in (False, True):
            name = "heat-bath" if hb else "Metropolis"
            f = diag(hb)
            ref = f(ops)
            same = all(
                bool(jnp.array_equal(x, y))
                for x, y in zip(jax.tree.leaves(outs[hb]), jax.tree.leaves(ref))
            )
            print(f"diagonal update {name}: kernel == lax carry (M={M}, "
                  f"R={R}): {same}", flush=True)
            assert same
            first, ms = timed(f, ops, reps=reps)
            report(f"diagonal update {name}: XLA carry (lax.scan)", first, ms)

    # Carry stage alone on the precomputed inputs.
    u = jax.random.uniform(key, (3, M, R))
    n0 = op_count(ops)
    _, _, w_new = _diag._parallel_weights(ops, state, u[1], model, None, False)
    is_ident = ops.bond < 0
    is_diag = jnp.all(ops.inputs == ops.outputs, axis=0) & ~is_ident
    num = beta * model.nbonds * w_new
    kind, thr = diag_carry.pack(is_ident, is_diag, num, num, heatbath=False)
    kern = jax.jit(lambda: diag_carry.carry_kernel(
        n0, u[0], kind, thr, None, heatbath=False))
    first, ms = timed(kern, reps=reps)
    report("carry stage: CUDA kernel", first, ms)
    seq = jax.jit(lambda: diag_carry.carry_reference(
        n0, u[0], kind, thr, None, heatbath=False))
    first, ms = timed(seq, reps=reps)
    report("carry stage: lax.scan", first, ms)
    same = bool(jnp.array_equal(kern(), seq()))
    print(f"carry stage kernel == lax.scan: {same}", flush=True)
    assert same
    pre = jax.jit(lambda o: _diag._parallel_weights(o, state, u[1], model,
                                                    None, False)[1])
    first, ms = timed(pre, ops, reps=reps)
    report("flip-parity precompute (int32 words, XLA)", first, ms)

    sweep = lambda s: multi_sweep(s, beta, model, 4, cluster_caps=caps)[1]  # noqa: E731
    first, ms = timed(sweep, g.sse, reps=reps)
    report(f"multi_sweep x4 {L}^2 R={R}: kernels", first, ms)
    with backend.plain_xla():
        first, ms = timed(sweep, g.sse, reps=reps)
        report(f"multi_sweep x4 {L}^2 R={R}: plain XLA", first, ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    if jax.devices()[0].platform != "gpu":
        print("kernel_ab: no GPU found", file=sys.stderr)
        return 1
    compile_cache.enable()
    print(f"card: {card()}", flush=True)
    classical(args.reps)
    sse(args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
