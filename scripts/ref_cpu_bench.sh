#!/usr/bin/env bash
# Single-core denominator for the ESS/sec north star (BASELINE.md): build and
# run the C++ reference-equivalent SSE TFIM benchmark
# (isingmontecarlo_tpu/native/ref_single_core.cpp) on the exact reference
# benchmark lattice, then compute ESS/sec with the same integrated-
# autocorrelation methodology bench.py uses for the GPU numerator.
#
# Usage: bash scripts/ref_cpu_bench.sh [L] [beta] [steps]
set -eu
cd "$(dirname "$0")/.."
L=${1:-32}
BETA=${2:-1.0}
STEPS=${3:-4000}
BIN=isingmontecarlo_tpu/native/_ref_single_core
SRC=isingmontecarlo_tpu/native/ref_single_core.cpp
if [ ! -x "$BIN" ] || [ "$SRC" -nt "$BIN" ]; then
  g++ -O3 -march=native -std=c++17 "$SRC" -o "$BIN"
fi
OUT=$(mktemp)
"$BIN" "$L" "$BETA" 1000 "$STEPS" 1234 --dump-n > "$OUT"
tail -1 "$OUT"
JAX_PLATFORMS=cpu PYTHONPATH="$PWD" python - "$OUT" <<'EOF'
import sys
import numpy as np
from isingmontecarlo_tpu.analysis import effective_sample_size

lines = open(sys.argv[1]).read().splitlines()
ns = np.array([int(l[2:]) for l in lines if l.startswith("n=")], np.float64)
summary = [l for l in lines if l.startswith("summary")][0]
ns_per_step = float(summary.split("ns_per_timestep=")[1].split()[0])
ess = effective_sample_size(ns)
steps_per_sec = 1e9 / ns_per_step
ess_per_sec = ess / len(ns) * steps_per_sec
print(f"single-core: {ns_per_step:.0f} ns/timestep, tau_int = "
      f"{len(ns)/ess:.2f} timesteps, ESS/sec = {ess_per_sec:.1f}")
EOF
