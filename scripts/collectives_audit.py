"""Multi-device communication audit for the fused tempering chunk: on a
virtual 8-device mesh, compile
``tempering_sweep_chunk`` with the replica axis sharded and inventory every
XLA collective in the optimized HLO — op kind, shape, and bytes moved — then
record weak scaling R=64 -> 512.

The design claim being checked: a sweep is embarrassingly replica-parallel,
so the ONLY cross-device traffic each tempering iteration should be the tiny
per-replica label vectors ((n, beta, scales) and the swap bookkeeping),
never the O(M x R) op-string tensors.

Usage:  python scripts/collectives_audit.py [R ...]   (default 64 512)
"""
import os
import re
import sys
import time

flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.parallel.tempering import (
    tempering_sweep_chunk,
    tempering_sweep_chunk_sharded,
    tfim_bond_classes,
)

# Default audits the shard_map chunk (the multi-chip path); AUDIT_GSPMD=1
# audits the plain-GSPMD chunk instead, which demonstrates WHY the explicit
# shard_map exists: XLA's sharding propagation all-gathers [S, R] cluster-
# label intermediates (196 KB/chunk measured at R=64 vs 16 KB yardstick).
SHARDED = os.environ.get("AUDIT_GSPMD") != "1"
from isingmontecarlo_tpu.sse import diagonal as _diag
from isingmontecarlo_tpu.sse.ising import QmcIsingGraph

_DTYPE_BYTES = {"f32": 4, "s32": 4, "u32": 4, "pred": 1, "bf16": 2,
                "f64": 8, "s64": 8, "u64": 8, "s8": 1, "u8": 1,
                "s16": 2, "u16": 2, "f16": 2}

_COLL = re.compile(
    r"^\s*(?:ROOT\s+)?%?[\w.\-]+\s*=\s*(\w+)\[([\d,]*)\][^=]*?"
    r"(all-reduce|all-gather|reduce-scatter|collective-permute|all-to-all)"
    r"[({]",
)


def audit(R: int, nsweeps: int = 4):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("replicas",))
    g = QmcIsingGraph(
        lattice.square(4, 4, j=1.0), transverse=1.0, cutoff=64,
        replicas=R, seed=0,
    )
    model = g.model
    betas = jnp.linspace(0.5, 2.0, R, dtype=jnp.float32)
    cls = np.asarray(tfim_bond_classes(len(g.edges), model.nvars, model.nbonds))
    per_class = np.stack(
        [np.ones(R), np.linspace(0.8, 1.25, R), np.ones(R)], axis=1
    ).astype(np.float32)
    scales = jnp.asarray(per_class[:, cls])
    hb = _diag.make_heatbath_tables(model, scales)

    sse = g.sse
    sh = type(sse)(
        ops=type(sse.ops)(
            bond=NamedSharding(mesh, P(None, "replicas")),
            inputs=NamedSharding(mesh, P(None, None, "replicas")),
            outputs=NamedSharding(mesh, P(None, None, "replicas")),
        ),
        state=NamedSharding(mesh, P("replicas", None)),
        key=NamedSharding(mesh, P()),
    )
    r_sh = NamedSharding(mesh, P("replicas"))
    rb_sh = NamedSharding(mesh, P("replicas", None))
    hb_sh = type(hb)(cum_max_w=rb_sh, total=r_sh)
    sse = jax.device_put(sse, sh)
    betas = jax.device_put(betas, r_sh)
    scales = jax.device_put(scales, rb_sh)
    hb = jax.device_put(hb, hb_sh)
    do_swap = jnp.ones((nsweeps,), bool)

    if SHARDED:
        def run(sse, betas, scales, hb):
            out = tempering_sweep_chunk_sharded(
                sse, betas, scales, jnp.int32(0), do_swap, model, nsweeps,
                mesh=mesh, hb=hb, heatbath=True, hetero=True,
            )
            sse, betas, scales, _x, hb, _p, nswaps, ns, _s, _b = out
            return sse, betas, scales, hb, nswaps, ns

        jf = jax.jit(run)
    else:
        def run(sse, betas, scales, hb):
            out = tempering_sweep_chunk(
                sse, betas, scales, jnp.int32(0), do_swap, model, nsweeps,
                hb=hb, heatbath=True, hetero=True,
            )
            sse, betas, scales, _x, hb, _p, nswaps, ns, _s, _b = out
            return sse, betas, scales, hb, nswaps, ns

        jf = jax.jit(run)
    lowered = jf.lower(sse, betas, scales, hb)
    compiled = lowered.compile()
    hlo = compiled.as_text()

    counts: dict = {}
    bytes_total = 0
    for line in hlo.splitlines():
        m = _COLL.search(line)
        if not m:
            continue
        dtype, dims, kind = m.groups()
        shape = [int(d) for d in dims.split(",") if d] if dims else []
        nelem = int(np.prod(shape)) if shape else 1
        nbytes = nelem * _DTYPE_BYTES.get(dtype, 4)
        key = (kind, dtype, tuple(shape))
        counts[key] = counts.get(key, 0) + 1
        bytes_total += nbytes
    print(f"== R={R}, nsweeps={nsweeps}, mesh=8 virtual devices ==")
    if not counts:
        print("  (no collectives found in optimized HLO)")
    for (kind, dtype, shape), c in sorted(counts.items()):
        nbytes = int(np.prod(shape or [1])) * _DTYPE_BYTES.get(dtype, 4)
        print(f"  {kind:20s} {dtype}{list(shape)} x{c}  ({nbytes} B each)")
    mr_bytes = 4 * g.cutoff * R
    print(f"  total collective bytes/chunk: {bytes_total}"
          f"  (one [M, R] op-bond tensor would be {mr_bytes})")
    # Design assertion (shape-based): every collective must be a per-replica
    # label vector [R] / label table [R, NB] / scalar — never an op-string
    # or cluster-label intermediate (any dim derived from the cutoff M).
    allowed_dims = {R, model.nbonds, 1}
    bad = [
        (kind, dtype, shape)
        for (kind, dtype, shape), _ in counts.items()
        if not set(shape or [1]) <= allowed_dims
    ]

    # weak scaling: wall time per chunk (CPU mesh — indicative only)
    out = jf(sse, betas, scales, hb)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = jf(*out[:4])
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    print(f"  chunk wall time (warm): {dt * 1e3:.1f} ms"
          f" ({dt * 1e3 / nsweeps:.1f} ms/sweep)")
    return bytes_total, bad


if __name__ == "__main__":
    rs = [int(a) for a in sys.argv[1:]] or [64, 512]
    for R in rs:
        b, bad = audit(R)
        if SHARDED:
            assert not bad, (
                f"non-label-vector collectives found: {bad} — replica-"
                f"sharded sweeps must only exchange (n, beta, scales) labels"
            )
    if SHARDED:
        print("collectives_audit: OK (traffic is label-vector sized)")
    else:
        print("collectives_audit: GSPMD inventory printed (no assertion)")
