#!/usr/bin/env python
"""Energy-ESS/sec on the SSE TFIM benchmark lattice (default 32^2) at several
replica counts, reported against the measured single-core denominator
(BASELINE.md: ~500 ESS/s).

Methodology matches bench.py's bench_sse: grow the cutoff to steady state,
equilibrate, time fused multi_sweep rounds (each ending in a device
readback), and compute ESS from the per-sweep op-count series (integrated
autocorrelation time, summed over independent replicas).

Usage: python scripts/ess32.py [L] [R,R,...] [nsweeps] [cluster_every] [reps]

``reps`` timed rounds of ``nsweeps`` each feed one concatenated series per
replica; aim for reps*nsweeps >= 50*tau so the thinning optimum is not a
statistical artifact.

PINNED MODE: with the steady-state (cutoff, label_cap, edge_cap) pinned at
or just above their converged values, the whole row (warmup, equilibration,
timing) dispatches exactly one program shape, so a warm persistent compile
cache serves it without compiling. Pins come from ``.ess32_pins.json``
(measured steady states, written by growth-mode runs), from
``ISING_ESS_PIN="cutoff,lc,ec"``, or are disabled with ``ISING_ESS_NOPIN=1``
(growth mode, which also records the measured pin). ``ISING_ESS_CHUNK=c``
times the region as host-chunked c-sweep programs. Physics is unaffected by
overshooting a pin: extra capacity is identity padding and larger label
caps only pad the label graph.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from isingmontecarlo_tpu import compile_cache, lattice  # noqa: E402
from isingmontecarlo_tpu.analysis import effective_sample_size  # noqa: E402
from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep  # noqa: E402

DENOM_ESS_PER_SEC = 500.0  # scripts/ref_cpu_bench.sh, BASELINE.md

# Warm-start cutoff hints for growth mode: capacity just under the steady
# state, so growth converges in ~2 dispatches instead of ~9.
_HINTS = {32: 6500, 16: 1700}


def _pin_file() -> str:
    return os.environ.get(
        "ISING_ESS_PIN_FILE", os.path.join(REPO, ".ess32_pins.json")
    )


def _load_pins() -> dict:
    try:
        with open(_pin_file()) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _save_pin(L, R, cutoff, lc, ec):
    pins = _load_pins()
    key = f"{L},{R}"
    old = pins.get(key)
    new = [cutoff, lc, ec]
    # Merge upward: a later run observing deeper strings raises the pin.
    if old:
        new = [max(a, b) for a, b in zip(old, new)]
    if new != old:
        pins[key] = new
        with open(_pin_file(), "w") as f:
            json.dump(pins, f, indent=1, sort_keys=True)
        print(f"(pin saved: {key} -> {new})", file=sys.stderr)


def _get_pin(L, R):
    if os.environ.get("ISING_ESS_NOPIN") == "1":
        return None
    env = os.environ.get("ISING_ESS_PIN")
    if env:
        c, lc, ec = (int(x) for x in env.split(","))
        return c, lc, ec
    pin = _load_pins().get(f"{L},{R}")
    return tuple(pin) if pin else None


def measure(L: int, R: int, NS: int, CK: int, REPS: int, hint: int = 0,
            chunk: int | None = None) -> dict:
    """One row: returns replica-sweeps/s, tau and energy-ESS/s (and prints
    the row). ``chunk`` defaults to ``ISING_ESS_CHUNK`` (0: one program)."""
    edges = lattice.bench_two_d_periodic(L)
    beta = jnp.float32(1.0)
    pin = _get_pin(L, R)
    CHUNK = int(os.environ.get("ISING_ESS_CHUNK", "0")) if chunk is None else chunk
    if pin is not None:
        cut_pin, lc_pin, ec_pin = pin
        g = QmcIsingGraph(
            edges, transverse=1.0, replicas=R, seed=7, cutoff=cut_pin
        )
        g._cluster_caps = (lc_pin, ec_pin)
        step = CHUNK or NS
        assert NS % step == 0 and step % CK == 0, (
            "need NS % chunk == 0 and chunk % cluster_every == 0"
        )
        print(
            f"(pinned: cutoff={cut_pin} caps=({lc_pin},{ec_pin}) "
            f"k={CK} chunk={step} -> one program shape)", file=sys.stderr,
        )
        # Traced thinning schedule: one compiled program serves every k.
        flags = jnp.arange(step, dtype=jnp.int32) % CK == CK - 1
        caps_pin = (lc_pin, ec_pin)

        def timed_rep(sse):
            parts = []
            for _ in range(NS // step):
                sse, ns_c, _, _ = multi_sweep(
                    sse, beta, g.model, step,
                    cluster_caps=caps_pin, cluster_flags=flags,
                )
                parts.append(ns_c)
            ns = parts[0] if len(parts) == 1 else jnp.concatenate(parts, 0)
            return sse, ns, None, None

        k_report = CK
    else:
        g = QmcIsingGraph(
            edges, transverse=1.0, replicas=R, seed=7,
            cutoff=hint or _HINTS.get(L) or None,
        )
        stable = 0
        for _ in range(40):
            g.sse, ns, _, _ = multi_sweep(g.sse, beta, g.model, 2)
            float(jnp.sum(ns))
            before = g.cutoff
            g._maybe_grow()
            stable = stable + 1 if g.cutoff == before else 0
            if stable >= 2:
                break

        def timed_rep(sse):
            if not CHUNK:
                return multi_sweep(
                    sse, beta, g.model, NS,
                    cluster_caps=g._cluster_caps, cluster_every=CK,
                )
            parts = []
            for _ in range(NS // CHUNK):
                sse, ns_c, _, _ = multi_sweep(sse, beta, g.model, CHUNK)
                parts.append(ns_c)
            return sse, jnp.concatenate(parts, axis=0), None, None

        if CHUNK:
            assert NS % CHUNK == 0, "NS must be a multiple of ISING_ESS_CHUNK"
        k_report = 1 if CHUNK else CK

    # Equilibration: rounds of the same program as the timed region. Growth
    # past a pin would reshape the program mid-measurement, so say so.
    for _ in range(4 if pin is not None else 2):
        g.sse, ns, _, _ = timed_rep(g.sse)
        float(jnp.sum(ns))
        before = g.cutoff
        before_caps = g._cluster_caps
        g._maybe_grow()
        if g.cutoff != before:
            print(
                f"WARNING: cutoff grew {before} -> {g.cutoff} "
                f"{'PAST THE PIN - re-run pin discovery' if pin else '(growth)'}",
                file=sys.stderr,
            )
        if pin is not None and g._cluster_caps != before_caps:
            # Lanes past the pinned caps skip the cluster stage: a silent
            # physics distortion, so say so.
            print(
                f"WARNING: cluster caps want {g._cluster_caps} past pinned "
                f"{before_caps} - re-run pin discovery", file=sys.stderr,
            )
    best = float("inf")
    ns_all = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        g.sse, ns, _, _ = timed_rep(g.sse)
        float(jnp.sum(ns))
        best = min(best, time.perf_counter() - t0)
        ns_all.append(np.asarray(ns))
    series = np.concatenate(ns_all, axis=0)
    ess = effective_sample_size(series)
    ess_rate = ess / (best * len(ns_all))
    n_max = int(series.max())
    caps = g._cluster_caps or (0, 0)
    sugg_cut = max(((n_max + n_max // 2 + 15) // 16) * 16 + 64, g.cutoff)
    print(
        f"(steady state: cutoff={g.cutoff} caps=({caps[0]},{caps[1]}) "
        f"n_max={n_max} -> pin ({sugg_cut},{caps[0]},{caps[1]}))",
        file=sys.stderr,
    )
    if pin is None and caps != (0, 0):
        _save_pin(L, R, sugg_cut, caps[0], caps[1])
    print(
        f"R={R:<5} k={k_report} cutoff={g.cutoff:<6}"
        f" {R * NS / best:10,.0f} replica-sweeps/s"
        f"  tau={series.size / ess:5.2f}  ESS/s={ess_rate:9.1f}"
        f"  vs_single_core={ess_rate / DENOM_ESS_PER_SEC:7.2f}x"
    )
    sys.stdout.flush()
    return {
        "replica_sweeps_per_sec": R * NS / best,
        "tau": series.size / ess,
        "ess_per_sec": ess_rate,
        "cutoff": g.cutoff,
        "cluster_every": k_report,
    }


def main(argv) -> None:
    compile_cache.enable(0.0)
    L = int(argv[1]) if len(argv) > 1 else 32
    r_list = (
        tuple(int(r) for r in argv[2].split(",")) if len(argv) > 2
        else (64, 128, 256, 512)
    )
    NS = int(argv[3]) if len(argv) > 3 else 16
    CK = int(argv[4]) if len(argv) > 4 else 1
    REPS = int(argv[5]) if len(argv) > 5 else 3
    hint = int(argv[6]) if len(argv) > 6 else int(
        os.environ.get("ISING_ESS_CUTOFF_HINT", "0")
    )
    print(f"device: {jax.devices()[0]}", file=sys.stderr)
    for R in r_list:
        measure(L, R, NS, CK, REPS, hint=hint)


if __name__ == "__main__":
    main(sys.argv)
