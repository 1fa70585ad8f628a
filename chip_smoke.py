#!/usr/bin/env python
"""Smoke run of the main paths on one NVIDIA GPU, in one process.

Phases, each through the public entry points:

(a) kernels: the checkerboard kernel against its plain-jnp twin (256^2,
    R=64, 10 sweeps) and the SSE diagonal update with its carry kernel
    against the same update with the ``lax.scan`` carry (32^2 benchmark
    lattice, R=512, M ~ 7,000; Metropolis and heat-bath), bit for bit.
(b) classical physics: ``LatticeIsing`` 256^2, R=64, energy per site at
    beta = 0.3 and 0.6 against Onsager's exact value, through the kernel and
    through the XLA threefry path; one ``GraphState.do_time_step`` at 256^2
    with its energy against a float64 recomputation.
(c) SSE physics: ``QmcIsingGraph`` 32^2, R=512, beta=1, grown to its steady
    cutoff; energy per site against the C++ single-core oracle
    (``native/ref_single_core.cpp``); ``verify()`` after Metropolis+cluster,
    heat-bath and RVB (16^2, beta=10) timesteps; ``__graft_entry__.entry()``.
(d) only with ``--four``, and then alone: sharded parallel tempering at
    32^2, R=512 over four cards against the same ladder on one card.

Prints the card, each phase's result, each comparison with its tolerance,
and compile and steady-step seconds. The last line of standard output is
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``;
with no GPU, or when any phase fails, it exits non-zero without that line.

Usage: python chip_smoke.py [--four]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import traceback

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from isingmontecarlo_tpu import compile_cache, lattice  # noqa: E402
from isingmontecarlo_tpu.ops import backend, checkerboard  # noqa: E402

FAILURES: list[str] = []
CARD = ""

# Sizes a user runs: the classical 256^2 benchmark lattice and the SSE
# benchmark lattice (benches/end_to_end.rs) at 32^2 with 512 replicas.
CLASSICAL_L, CLASSICAL_R = 256, 64
SSE_L, SSE_R, SSE_CUTOFF = 32, 512, 6400
RVB_L, RVB_R = 16, 32
TEMPER_SWEEPS, TEMPER_CUTOFF = 256, 14000


def say(msg: str) -> None:
    print(msg, flush=True)


def check(name: str, ok: bool, detail: str) -> None:
    say(f"  [{'PASS' if ok else 'FAIL'}] {name}: {detail}")
    if not ok:
        FAILURES.append(name)


def block_sem(x: np.ndarray, blocks: int = 10) -> float:
    """Standard error of the mean of a correlated series by blocking."""
    x = np.asarray(x, np.float64)
    n = len(x) // blocks * blocks
    means = x[:n].reshape(blocks, -1).mean(axis=1)
    return float(means.std(ddof=1) / math.sqrt(blocks))


def onsager_energy(beta: float) -> float:
    """Exact energy per site of the square-lattice ferromagnet, J = 1."""
    t = 2.0 * beta
    k = 2.0 * math.sinh(t) / math.cosh(t) ** 2
    a, b = 1.0, math.sqrt(max(0.0, 1.0 - k * k))
    for _ in range(40):  # arithmetic-geometric mean
        a, b = (a + b) / 2.0, math.sqrt(a * b)
    K = math.pi / (2.0 * a)
    return -(1.0 / math.tanh(t)) * (
        1.0 + (2.0 / math.pi) * (2.0 * math.tanh(t) ** 2 - 1.0) * K
    )


# --------------------------------------------------------------------------
# SSE 32^2 state shared by phases (a) and (c)
# --------------------------------------------------------------------------

_SSE = {}


def sse32():
    """QmcIsingGraph on the 32^2 benchmark lattice, R=512, beta=1, grown
    from a cutoff just under steady state through the public timesteps()."""
    if "g" not in _SSE:
        from isingmontecarlo_tpu.sse.ising import QmcIsingGraph

        g = QmcIsingGraph(lattice.bench_two_d_periodic(SSE_L),
                          transverse=1.0, replicas=SSE_R, seed=7,
                          cutoff=SSE_CUTOFF)
        t0 = time.perf_counter()
        g.timesteps(48, 1.0)
        say(f"  {SSE_L}^2 R={SSE_R} growth + equilibration: {time.perf_counter() - t0:.1f} s "
            f"(compiles included), cutoff M={g.cutoff}")
        _SSE["g"] = g
    return _SSE["g"]


# --------------------------------------------------------------------------
# (a) kernels against their references
# --------------------------------------------------------------------------


def phase_kernels() -> None:
    from isingmontecarlo_tpu.sse import diagonal as _diag

    L, R = CLASSICAL_L, CLASSICAL_R
    spins = jax.random.bernoulli(jax.random.key(0), 0.5, (R, L, L))
    thr = checkerboard.thresholds(0.44, -1.0, 0.0)
    a = checkerboard.checkerboard_multi_sweep(spins, np.uint32(11), thr, 10)
    b = checkerboard.checkerboard_twin(spins, np.uint32(11), thr, 10)
    diff = int(jnp.sum(a != b))
    check("checkerboard kernel vs jnp twin", diff == 0,
          f"L={L} R={R} 10 sweeps, {diff} differing spins of {R * L * L} "
          f"(tolerance: bit-identical; acceptance thresholds f32)")

    g = sse32()
    ops, state, model = g.sse.ops, g.sse.state, g.model
    M = ops.bond.shape[0]
    for heatbath in (False, True):
        hbt = _diag.make_heatbath_tables(model) if heatbath else None

        def run():
            return _diag._diagonal_update_fast(
                ops, state, jnp.float32(1.0), jax.random.key(5), model,
                hb=hbt, heatbath=heatbath,
            )

        got = run()
        with backend.plain_xla():
            want = run()
        same = all(
            bool(jnp.array_equal(x, y))
            for x, y in zip(jax.tree.leaves(got), jax.tree.leaves(want))
        )
        name = "heat-bath" if heatbath else "Metropolis"
        check(f"carry kernel vs lax.scan carry ({name})", same,
              f"M={M} R={SSE_R}, full diagonal-update op strings "
              f"(tolerance: bit-identical; f32 round-to-nearest, no FMA)")


# --------------------------------------------------------------------------
# (b) classical physics
# --------------------------------------------------------------------------


def lattice_energy_series(beta, warm, samples, every, ordered):
    from isingmontecarlo_tpu.classical import LatticeIsing

    L, R = CLASSICAL_L, CLASSICAL_R
    state = np.ones((L, L), bool) if ordered else None
    m = LatticeIsing(L, j=-1.0, replicas=R, seed=3, state=state)
    t0 = time.perf_counter()
    m.run_sweeps(warm, beta=beta)
    jax.block_until_ready(m.spins)
    t_warm = time.perf_counter() - t0
    es = []
    t0 = time.perf_counter()
    for _ in range(samples):
        m.run_sweeps(every, beta=beta)
        es.append(float(jnp.mean(m.get_energy())) / (L * L))
    t_meas = time.perf_counter() - t0
    return np.array(es), t_warm, t_meas


def phase_classical() -> None:
    from isingmontecarlo_tpu.classical import GraphState

    L = CLASSICAL_L
    for beta in (0.3, 0.6):
        exact = onsager_energy(beta)
        ordered = beta > 0.44
        ek, tw, tm = lattice_energy_series(beta, 1000, 100, 10, ordered)
        sk = block_sem(ek)
        tol = 5 * sk + 1e-3
        check(f"LatticeIsing {L}^2 beta={beta} (kernel) vs Onsager",
              abs(ek.mean() - exact) < tol,
              f"E/N={ek.mean():.6f} +- {sk:.6f}, exact {exact:.6f}, "
              f"tolerance 5 sigma + 1e-3 = {tol:.6f} (float32 spins/energy)")
        say(f"    time on {CARD}: 1000 warm sweeps {tw:.2f} s (compile "
            f"included), 100 x 10 measured sweeps {tm:.2f} s")
        with backend.plain_xla():
            ex, _, tmx = lattice_energy_series(beta, 1000, 100, 10, ordered)
        sx = block_sem(ex)
        tol = 5 * math.hypot(sk, sx) + 1e-3
        check(f"LatticeIsing {L}^2 beta={beta}: kernel vs XLA threefry path",
              abs(ek.mean() - ex.mean()) < tol,
              f"{ek.mean():.6f} vs {ex.mean():.6f}, tolerance 5 sigma + 1e-3 "
              f"= {tol:.6f} (XLA path: 100 x 10 sweeps {tmx:.2f} s)")

    gs = GraphState(lattice.square(L, L, j=-1.0), [0.0] * (L * L),
                    replicas=4, seed=1)
    t0 = time.perf_counter()
    gs.do_time_step(0.44)
    e = np.asarray(gs.get_energy())
    dt = time.perf_counter() - t0
    s = np.asarray(gs.spins).reshape(4, L, L).astype(np.float64) * 2 - 1
    e64 = -(np.sum(s * np.roll(s, 1, 1), axis=(1, 2))
            + np.sum(s * np.roll(s, 1, 2), axis=(1, 2)))
    check(f"GraphState.do_time_step {L}^2 energy vs float64 recomputation",
          bool(np.all(np.isfinite(e))) and np.array_equal(e, e64),
          f"E={e.tolist()} (tolerance: exact; integer sums in float32, "
          f"no TF32 dot), {dt:.2f} s with compile")


# --------------------------------------------------------------------------
# (c) SSE physics
# --------------------------------------------------------------------------


def start_oracle():
    """Build and start the C++ single-core oracle in the background (host
    CPU only); returns its Popen."""
    src = os.path.join(HERE, "isingmontecarlo_tpu", "native",
                       "ref_single_core.cpp")
    binary = os.path.join(HERE, "isingmontecarlo_tpu", "native",
                          "_ref_single_core")
    subprocess.run(["g++", "-O2", "-std=c++17", src, "-o", binary],
                   check=True, capture_output=True, timeout=300)
    return subprocess.Popen(
        [binary, str(SSE_L), "1.0", "2000", "40000", "7", "--dump-n"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )


def phase_sse(oracle) -> None:
    from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep

    g = sse32()
    N, R = g.nvars, g.replicas
    check("verify() after growth (Metropolis diagonal + cluster)", g.verify(),
          f"R={R}")
    caps = g._cluster_caps
    beta = jnp.float32(1.0)
    comp = multi_sweep.lower(g.sse, beta, g.model, 16,
                             cluster_caps=caps).compile()
    mem = comp.memory_analysis()
    say(f"    {SSE_L}^2 R={R} 16-sweep program memory_analysis: "
        f"temp={mem.temp_size_in_bytes / 2**30:.3f} GiB "
        f"args={mem.argument_size_in_bytes / 2**20:.1f} MiB "
        f"out={mem.output_size_in_bytes / 2**20:.1f} MiB")
    t0 = time.perf_counter()
    e = np.asarray(g.timesteps(160, 1.0)) / N
    dt = time.perf_counter() - t0
    stats = jax.devices()[0].memory_stats() or {}
    say(f"    peak_bytes_in_use={stats.get('peak_bytes_in_use', 0) / 2**30:.3f} GiB")
    say(f"    time on {CARD}: 160 timesteps {SSE_L}^2 R={R} in {dt:.2f} s "
        f"(compiles included)")
    g.timesteps(16, 1.0)  # a compile here, if caps moved, stays untimed
    t0 = time.perf_counter()
    g.timesteps(32, 1.0)
    dt = time.perf_counter() - t0
    say(f"    time on {CARD}: steady {dt / 32 * 1e3:.2f} ms/timestep "
        f"({SSE_L}^2 R={R}, 2 x 16-sweep chunks, no compile)")
    check("verify() after 160 Metropolis+cluster timesteps", g.verify(),
          f"cutoff M={g.cutoff}")
    e_jax = float(e.mean())
    s_jax = float(e.std(ddof=1) / math.sqrt(R))

    out, err = oracle.communicate(timeout=600)
    if oracle.returncode != 0:
        raise RuntimeError(f"oracle failed: {err[-2000:]}")
    ns = np.array([int(ln[2:]) for ln in out.splitlines()
                   if ln.startswith("n=")], np.float64)
    summ = [ln for ln in out.splitlines() if ln.startswith("summary")][0]
    e_ref = float(summ.split("energy_per_site=")[1].split()[0])
    s_ref = block_sem(ns, 20) / N  # dE/dn = -1/(beta N)
    tol = 5 * math.hypot(s_jax, s_ref)
    check(f"SSE {SSE_L}^2 beta=1 energy per site vs C++ single-core oracle",
          abs(e_jax - e_ref) < tol,
          f"JAX {e_jax:.6f} +- {s_jax:.6f} (R={R}, 160 steps), oracle "
          f"{e_ref:.6f} +- {s_ref:.6f} (40000 steps), tolerance 5 sigma = "
          f"{tol:.6f} (float32 uniforms and weights)")

    g.set_enable_heatbath(True)
    t0 = time.perf_counter()
    g.timestep(1.0)
    dt = time.perf_counter() - t0
    check("verify() after a heat-bath timestep", g.verify(),
          f"{SSE_L}^2 R={R}, {dt:.2f} s with compile")
    g.set_enable_heatbath(False)

    h = QmcIsingGraph(lattice.bench_two_d_periodic(RVB_L), transverse=1.0,
                      replicas=RVB_R, seed=5)
    h.set_run_rvb(True, updates_per_timestep=RVB_L * RVB_L // 2)
    t0 = time.perf_counter()
    h.timesteps(2, 10.0)  # cold start: each growth step compiles once
    dt = time.perf_counter() - t0
    check(f"verify() after RVB timesteps ({RVB_L}^2, beta=10)", h.verify(),
          f"R={RVB_R}, 2 timesteps, cutoff M={h.cutoff}, RVB success rate "
          f"{h.rvb_success_rate():.3f}, {dt:.2f} s with compiles")

    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out = jax.block_until_ready(jax.jit(fn)(*args))
    same_shapes = all(
        a.shape == b.shape for a, b in zip(jax.tree.leaves(out),
                                           jax.tree.leaves(args[0]))
    )
    from isingmontecarlo_tpu.sse.opstring import verify

    ok = bool(jnp.all(verify(out.ops, out.state, __graft_entry__._tiny_tfim(8).model)))
    check("__graft_entry__.entry() step", same_shapes and ok,
          "shapes preserved, worldlines verify")


# --------------------------------------------------------------------------
# (d) four cards
# --------------------------------------------------------------------------


def tempering_run(ndev: int, sweeps: int, chunk: int):
    from jax.sharding import Mesh

    from isingmontecarlo_tpu.parallel.tempering import TemperingContainer
    from isingmontecarlo_tpu.sse.opstring import op_count

    betas = np.linspace(0.5, 2.0, 8)
    tc = TemperingContainer(lattice.bench_two_d_periodic(SSE_L), 1.0,
                            betas=betas, replicas_per_beta=SSE_R // 8,
                            seed=13)
    tc.graph.set_cutoff(TEMPER_CUTOFF)
    tc.shard_over(Mesh(np.array(jax.devices()[:ndev]), ("replicas",)))
    t0 = time.perf_counter()
    tc.timesteps_sample(sweeps // 2, chunk=chunk, sampling_freq=10**9)
    t_warm = time.perf_counter() - t0
    rows = []
    t0 = time.perf_counter()
    for _ in range(sweeps // 2 // chunk):
        tc.timesteps_sample(chunk, chunk=chunk, sampling_freq=10**9)
        n = np.asarray(op_count(tc.graph.sse.ops), np.float64)
        b = np.asarray(tc.betas)
        rows.append([n[np.isclose(b, x)].mean() for x in betas])
    t_meas = time.perf_counter() - t0
    rows = np.array(rows)  # [chunks, nbeta]
    return tc, betas, rows, t_warm, t_meas


def phase_four() -> None:
    sweeps, chunk = TEMPER_SWEEPS, 16
    res = {}
    for ndev in (4, 1):
        tc, betas, rows, tw, tm = tempering_run(ndev, sweeps, chunk)
        res[ndev] = rows
        check(f"tempering on {ndev} card(s): verify()", tc.verify(),
              f"R={SSE_R}, 8 betas x {SSE_R // 8}, {tc.get_total_swaps()} swaps")
        say(f"    time on {CARD} x{ndev}: warm {sweeps // 2} sweeps {tw:.2f} s "
            f"(compile included), measured {sweeps // 2} sweeps {tm:.2f} s")
    a, b = res[4], res[1]
    exact = bool(np.array_equal(a, b))
    worst = 0.0
    for i, beta in enumerate(betas):
        sa = a[:, i].std(ddof=1) / math.sqrt(len(a))
        sb = b[:, i].std(ddof=1) / math.sqrt(len(b))
        z = abs(a[:, i].mean() - b[:, i].mean()) / max(math.hypot(sa, sb), 1e-9)
        worst = max(worst, z)
        say(f"    beta={beta:.3f}: <n> 4 cards {a[:, i].mean():.2f} +- {sa:.2f}, "
            f"1 card {b[:, i].mean():.2f} +- {sb:.2f}, z={z:.2f}")
    say(f"  states bit-identical across device counts: {exact} (the sharded "
        f"chunk folds the device index into each sweep's key)")
    check("tempering 4 cards vs 1 card, per-beta mean op count", worst < 5.0,
          f"largest |z| = {worst:.2f} over 8 betas (tolerance 5 sigma, "
          f"chunk means)")


def main() -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card tempering phase")
    args = ap.parse_args()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs[0].platform})",
              file=sys.stderr)
        return 1
    if args.four and len(devs) < 4:
        print(f"chip_smoke: --four needs 4 GPUs, found {len(devs)}",
              file=sys.stderr)
        return 1
    compile_cache.enable()
    CARD = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    say(f"card: {CARD}")
    say(f"jax {jax.__version__}, devices: {len(devs)} x {devs[0].device_kind}")
    oracle = None
    if args.four:
        phases = [("d four-card tempering", phase_four)]
    else:
        oracle = start_oracle()
        phases = [
            ("a kernels", phase_kernels),
            ("b classical physics", phase_classical),
            ("c SSE physics", lambda: phase_sse(oracle)),
        ]
    t_all = time.perf_counter()
    try:
        for name, fn in phases:
            say(f"phase {name}:")
            t0 = time.perf_counter()
            try:
                fn()
            except Exception:  # reported, counted, and fails the run below
                traceback.print_exc()
                FAILURES.append(name)
            say(f"  phase {name} took {time.perf_counter() - t0:.1f} s")
    finally:
        if oracle is not None and oracle.poll() is None:
            oracle.kill()
            oracle.wait()
    say(f"total {time.perf_counter() - t_all:.1f} s on {CARD}")
    if FAILURES:
        say(f"FAILED: {FAILURES}")
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
