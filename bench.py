#!/usr/bin/env python
"""Headline benchmark: classical Ising spin-flip attempts/sec on one chip.

Workload: 256x256 periodic square lattice, ferromagnetic J=-1 (energy
convention of the reference, ``src/classical/graph.rs:430-447``), batched
checkerboard Metropolis sweeps fused under one jit. This is BASELINE.md's
north-star metric: >= 1e10 spin-flip attempts/sec/chip.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "attempts/sec", "vs_baseline": N/1e10}

Extra diagnostics (SSE sweep throughput, device info) go to stderr.

Usage (needs an NVIDIA GPU; exits non-zero without one):
  python bench.py            # full benchmark
  python bench.py --smoke    # tiny shapes
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from isingmontecarlo_tpu import compile_cache  # noqa: E402
from isingmontecarlo_tpu.classical import metropolis as _metro  # noqa: E402
from isingmontecarlo_tpu.ops import backend  # noqa: E402

BASELINE_FLIPS_PER_SEC = 1.0e10


@functools.partial(jax.jit, static_argnames=("nsweeps",))
def _cb_run(spins, seed, beta, j, h, nsweeps: int):
    """nsweeps fused checkerboard sweeps (the CUDA kernel on a GPU); returns
    final spins + a reduction that forces materialization."""
    spins = _metro.lattice_multi_sweep(spins, seed, beta, j, h, nsweeps)
    return spins, jnp.sum(spins)


def bench_classical(L: int, replicas: int, nsweeps: int, reps: int) -> dict:
    """Marginal throughput: time runs of ``nsweeps`` and ``5*nsweeps`` and
    divide the extra sweeps by the extra time, which removes the constant
    per-call dispatch latency; a device-to-host scalar read (``float(s)``)
    forces real completion of each run. ``lattice_multi_sweep`` picks the
    CUDA shared-memory kernel on a GPU (``ops.checkerboard``)."""
    spins = jax.random.bernoulli(jax.random.key(0), 0.5, (replicas, L, L))
    beta = jnp.float32(0.4)
    j = jnp.float32(-1.0)
    h = jnp.float32(0.0)

    from isingmontecarlo_tpu.ops import checkerboard

    kernel = backend.gpu_kernels() and checkerboard.kernel_supports(L)

    def run(sp, sd, n):
        return _cb_run(sp, sd, beta, j, h, n)

    n_small, n_big = nsweeps, 5 * nsweeps

    def timed(n: int) -> float:
        nonlocal spins
        best = float("inf")
        for r in range(reps):
            t0 = time.perf_counter()
            spins, s = run(spins, jnp.uint32(r * 7919 + n), n)
            float(s)  # forces completion
            best = min(best, time.perf_counter() - t0)
        return best

    # Warmup / compile both run lengths.
    for n in (n_small, n_big):
        spins, s = run(spins, jnp.uint32(0), n)
        float(s)

    t_small = timed(n_small)
    t_big = timed(n_big)
    dt = max(t_big - t_small, 1e-9)
    attempts = replicas * L * L * (n_big - n_small)
    return {
        "attempts_per_sec": attempts / dt,
        "seconds_small": t_small,
        "seconds_big": t_big,
        "sweeps_per_sec": replicas * (n_big - n_small) / dt,
        "path": "cuda_kernel" if kernel else "xla",
    }


def bench_sse(
    L: int, replicas: int, nsweeps: int, reps: int, cluster_every: int = 1
) -> dict:
    """Secondary: SSE TFIM sweeps/sec and energy-ESS/sec on the reference's
    LxL benchmark lattice. ESS uses the integrated autocorrelation time of
    the per-sweep energy estimator (op count), summed over independent
    replicas — the same methodology as the single-core denominator
    (scripts/ref_cpu_bench.sh). ``cluster_every=k`` thins the cluster update
    to every k-th timestep (a throughput/autocorrelation trade; see
    scripts/ess32.py). Every timed round ends with a device-to-host
    readback."""
    from isingmontecarlo_tpu import lattice
    from isingmontecarlo_tpu.analysis import effective_sample_size
    from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep

    edges = lattice.bench_two_d_periodic(L)
    # Warm-start cutoff hint just under the known steady state (16^2 R=256:
    # 1808; 32^2: ~6976): growth then converges in ~2 dispatches instead of
    # ~9, each a compile of a throwaway shape.
    hint = {16: 1700, 32: 6500}.get(L)
    g = QmcIsingGraph(
        edges, transverse=1.0, replicas=replicas, seed=7, cutoff=hint
    )
    beta = jnp.float32(1.0)
    # Grow the cutoff to steady state (short chunks until stable), then
    # equilibrate.
    stable = 0
    for _ in range(40):
        g.sse, ns, _, _ = multi_sweep(g.sse, beta, g.model, 2)
        float(jnp.sum(ns))
        before = g.cutoff
        g._maybe_grow()
        stable = stable + 1 if g.cutoff == before else 0
        if stable >= 2:
            break
    kw = dict(cluster_caps=g._cluster_caps, cluster_every=cluster_every)
    for _ in range(2):
        g.sse, ns, _, _ = multi_sweep(g.sse, beta, g.model, nsweeps, **kw)
        float(jnp.sum(ns))
        g._maybe_grow()
    best = float("inf")
    ns_all = []
    for _ in range(reps):
        t0 = time.perf_counter()
        g.sse, ns, _, _ = multi_sweep(g.sse, beta, g.model, nsweeps, **kw)
        float(jnp.sum(ns))
        best = min(best, time.perf_counter() - t0)
        ns_all.append(np.asarray(ns))
    series = np.concatenate(ns_all, axis=0)  # [reps*nsweeps, R]
    ess = effective_sample_size(series)
    return {
        "sse_replica_sweeps_per_sec": replicas * nsweeps / best,
        "sse_energy_ess_per_sec": ess / (best * len(ns_all)),
        "cutoff": g.cutoff,
    }


def bench_suite(json_path: str | None = None) -> None:
    """Reference-workload table mirroring ``benches/end_to_end.rs``:
    per-replica-timestep cost for the crate's benchmark configs (the
    reference reports ns/iter for one sequential timestep; here the cost is
    amortized over the replica batch). Printed to stderr; optionally also
    appended as JSON lines to ``json_path`` for machine comparison across
    rounds."""
    from isingmontecarlo_tpu import lattice
    from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep

    rows = []

    # Warm-start cutoff hints per row, slightly under the steady-state
    # cutoffs (n ~ (4.3-4.6) N beta, cutoff ~ 1.6 n): growth then converges
    # in ~2 dispatches, each skipped dispatch a skipped compile of a
    # throwaway shape. Undershoot costs one extra growth dispatch; overshoot
    # would inflate M permanently. Rows without a hint cold-grow.
    hints = {
        "two_d_16": 1700,
        "two_d_heatbath_16": 1700,
        "two_d_rvb_16": 14000,
        # 32^2 rows start at the steady state (ess32 pin discovery).
        "two_d_32": 6944,
        "two_d_heatbath_32": 6944,
        # beta-scaled from the rvb_04/06 equilibria (n/site/beta ~4.4,
        # cutoff ~1.5n).
        "two_d_rvb_cold_4": 11000,
        "two_d_rvb_cold_5": 17500,
        "two_d_rvb_cold_6": 24000,
        "two_d_rvb_32": 68000,
        "two_d_rvb_cold_7": 33000,
        "two_d_rvb_cold_8": 43000,
    }

    def measure(name, edges, beta, replicas, heatbath=False, rvb=0, warm=8):
        g = QmcIsingGraph(
            edges, transverse=1.0, replicas=replicas, seed=1234,
            cutoff=hints.get(name.split()[0]),
        )
        if heatbath:
            g.set_enable_heatbath(True)
        if rvb:
            g.set_run_rvb(True, updates_per_timestep=rvb)
        kw = dict(
            hb=g._hb_tables if heatbath else None,
            heatbath=heatbath,
            **g._rvb_args(),
        )
        b = jnp.float32(beta)
        # Growth phase first: short chunks until the cutoff stops moving
        # (from a cold start the cutoff grows ~1.5x per dispatch, so a fixed
        # number of fused calls under-equilibrates deep strings, e.g. the
        # beta=100 rvb_cold rows), then the fused warm rounds.
        stable = 0
        # RVB rows grow n slowly (acceptance-limited), so two quiet rounds
        # can be a false plateau — require a longer stable streak there.
        need = 6 if rvb else 2
        for _ in range(60 if rvb else 40):
            g.sse, ns, _, _ = multi_sweep(g.sse, b, g.model, 2, **kw)
            jax.block_until_ready(ns)
            before = g.cutoff
            g._maybe_grow()
            stable = stable + 1 if g.cutoff == before else 0
            if stable >= need:
                break
        for _ in range(2):
            g.sse, ns, _, _ = multi_sweep(g.sse, b, g.model, warm, **kw)
            jax.block_until_ready(ns)
            g._maybe_grow()
        # Re-snapshot per-sweep args after warmup: _maybe_grow has now set
        # the RVB active-slot compaction cutoff (and final cluster caps), so
        # the timed region runs what timesteps_measure would actually run
        # (compact-capped cluster labels included; _rvb_args carries the
        # refreshed cluster_caps).
        kw = dict(
            hb=g._hb_tables if heatbath else None,
            heatbath=heatbath,
            **g._rvb_args(),
        )

        def timed(n):
            t0 = time.perf_counter()
            _, ns, _, _ = multi_sweep(g.sse, b, g.model, n, **kw)
            float(jnp.sum(ns))
            return time.perf_counter() - t0

        timed(2)
        timed(8)
        t1 = min(timed(2) for _ in range(2))
        t2 = min(timed(8) for _ in range(2))
        per = (t2 - t1) / 6 / replicas
        print(
            f"  {name:<28} {per*1e9:12.0f} ns/replica-timestep "
            f"(R={replicas}, cutoff={g.cutoff}, n~{float(jnp.mean(ns[-1])):.0f})",
            file=sys.stderr,
        )
        row = {
            "workload": name.split()[0],
            "ns_per_replica_timestep": per * 1e9,
            "replicas": replicas,
            "cutoff": g.cutoff,
            "mean_n": float(jnp.mean(ns[-1])),
        }
        rows.append(row)
        # Append per row, not at the end: a partial JSONL survives a run
        # that outlives its time limit.
        if json_path:
            with open(json_path, "a") as f:
                f.write(json.dumps(row) + "\n")

    skip = set(
        s for s in os.environ.get("ISING_SUITE_SKIP", "").split(",") if s
    )
    done = set()
    if json_path and os.environ.get("ISING_SUITE_RESUME") == "1":
        # Resume: skip rows already recorded in the JSONL.
        try:
            with open(json_path) as f:
                done = {json.loads(ln)["workload"] for ln in f if ln.strip()}
        except OSError:
            pass

    def safe(name, *a, **kw):
        if name.split()[0] in skip or name.split()[0] in done:
            print(f"  {name:<28} skipped", file=sys.stderr)
            return
        try:
            measure(name, *a, **kw)
        except Exception as e:
            print(f"  {name:<28} failed: {e}", file=sys.stderr)

    R = 256
    print("reference benchmark workloads (benches/end_to_end.rs):", file=sys.stderr)
    # The reference's RNG-ablation rows (one_d with StdRng / ChaCha,
    # benches/end_to_end.rs:62-94) are intentionally absent: this build has
    # exactly one counter-based RNG (threefry via jax.random), so the
    # ablation has no analog; the one_d row below is the SmallRng workload.
    print(
        "  (rng-ablation rows one_d_{std,chacha}_rng: n/a — single threefry "
        "RNG by design)",
        file=sys.stderr,
    )
    safe("one_d (L=16)", lattice.chain(16), 1.0, R)
    for L in (4, 8, 16):
        safe(f"two_d_{L:02d}", lattice.bench_two_d_periodic(L), 1.0, R)
    safe("one_d_heatbath", lattice.chain(16), 1.0, R, heatbath=True)
    for L in (4, 8, 16):
        safe(
            f"two_d_heatbath_{L:02d}", lattice.bench_two_d_periodic(L), 1.0, R,
            heatbath=True,
        )
    for L in (4, 6, 8, 16):
        n = L * L
        safe(
            f"two_d_rvb_{L:02d} (beta=10)", lattice.bench_two_d_periodic(L),
            10.0, 64 if L < 16 else 16, rvb=(n + 1) // 2, warm=4,
        )
    # Cold RVB (beta=100, benches/end_to_end.rs:336-429): deep op strings,
    # more warm rounds to grow the cutoff to steady state. Replica counts
    # shrink with depth; the metric is per replica, so a smaller R trades
    # only batch amortization, not validity.
    for L, R_cold in ((4, 64), (5, 16), (6, 16)):
        n = L * L
        safe(
            f"two_d_rvb_cold_{L} (beta=100)", lattice.bench_two_d_periodic(L),
            100.0, R_cold, rvb=(n + 1) // 2, warm=10,
        )
    safe("two_d_32", lattice.bench_two_d_periodic(32), 1.0, 64)
    safe(
        "two_d_heatbath_32", lattice.bench_two_d_periodic(32), 1.0, 64,
        heatbath=True,
    )
    # The deepest RVB rows: the candidate-restricted fused pass bounds the
    # edge axis at MAX_POPS*degree, but M is tens of thousands of slots.
    for L, R_rvb, warm in ((7, 8, 10), (8, 8, 10)):
        n = L * L
        safe(
            f"two_d_rvb_cold_{L} (beta=100)", lattice.bench_two_d_periodic(L),
            100.0, R_rvb, rvb=(n + 1) // 2, warm=warm,
        )
    safe(
        "two_d_rvb_32 (beta=10)", lattice.bench_two_d_periodic(32),
        10.0, 4, rvb=(32 * 32 + 1) // 2, warm=2,
    )


BASELINE_ESS32_PER_SEC = 500.0  # single-core denominator, BASELINE.md


def _ess32_record() -> dict:
    """North-star #2 (SSE 32^2 energy-ESS/sec), in this process, through
    ``scripts/ess32.py``'s ``measure``. Config (R, nsweeps, cluster_every)
    can be overridden with ISING_BENCH_ESS_CFG="R,NS,K[,L]". NS=72 x 4
    rounds = 288 samples per replica, >= 50 tau at the long-series tau."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import ess32

    cfg = [int(x) for x in os.environ.get(
        "ISING_BENCH_ESS_CFG", "128,72,8"
    ).split(",")]
    R, ns, k = cfg[:3]
    L = cfg[3] if len(cfg) > 3 else 32
    row = ess32.measure(L, R, ns, k, 4, chunk=0)
    return {
        "sse32_ess_per_sec": row["ess_per_sec"],
        "sse32_vs_single_core": row["ess_per_sec"] / BASELINE_ESS32_PER_SEC,
        "sse32_cfg": {"replicas": R, "nsweeps": ns,
                      "cluster_every": row["cluster_every"]},
    }


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true", help="tiny shapes for CI")
    ap.add_argument("--no-sse", action="store_true", help="skip SSE diagnostic")
    ap.add_argument(
        "--suite", action="store_true",
        help="also run the reference benchmark workload table (stderr)",
    )
    ap.add_argument(
        "--suite-json", default=None,
        help="append suite rows as JSON lines to this path",
    )
    args = ap.parse_args()

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: no GPU (JAX found {dev.platform})", file=sys.stderr)
        sys.exit(1)
    compile_cache.enable(0.0)
    print(f"device: {dev.platform} ({dev.device_kind}) x{len(jax.devices())}",
          file=sys.stderr)

    if args.smoke:
        c = bench_classical(L=64, replicas=8, nsweeps=20, reps=2)
    else:
        c = bench_classical(L=256, replicas=64, nsweeps=100, reps=3)
    print(f"classical: {c}", file=sys.stderr)
    value = c["attempts_per_sec"]
    metric = (
        "classical_256sq_spinflip_attempts_per_sec"
        if not args.smoke
        else "classical_smoke_spinflip_attempts_per_sec"
    )
    record = {
        "metric": metric,
        "value": value,
        "unit": "attempts/sec",
        "vs_baseline": value / BASELINE_FLIPS_PER_SEC,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }
    # North star #2 rides the same record (extra keys on one JSON line): the
    # 32^2 SSE ESS/sec vs the 500 ESS/s single-core denominator.
    if not args.smoke and not args.no_sse:
        record.update(_ess32_record())
    if not args.no_sse:
        if args.smoke:
            s = bench_sse(L=4, replicas=32, nsweeps=8, reps=2)
        else:
            s = bench_sse(L=16, replicas=256, nsweeps=16, reps=2)
        print(f"sse: {s}", file=sys.stderr)
    print(json.dumps(record))
    sys.stdout.flush()

    if args.suite or args.suite_json:
        bench_suite(args.suite_json)


if __name__ == "__main__":
    main()
