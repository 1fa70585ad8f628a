"""Tracing / profiling helpers — the rebuild's answer to SURVEY.md §5
("Tracing: none in the reference; rebuild: jax.profiler traces + per-kernel
timing").

Usage::

    from isingmontecarlo_tpu import profiling

    with profiling.trace("/tmp/trace"):      # view in TensorBoard/Perfetto
        g.timesteps(100, beta)

    ms = profiling.time_fn(lambda: g.timestep(beta))   # wall-clock, synced
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture an XLA profiler trace of the host and devices into ``log_dir``."""
    with jax.profiler.trace(log_dir):
        yield


def time_fn(fn: Callable[[], object], iters: int = 3, warmup: int = 1) -> float:
    """Best wall-clock milliseconds of ``fn()`` over ``iters`` runs, blocking
    on the result."""
    for _ in range(warmup):
        jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def annotate(name: str):
    """Named profiler span (shows up in trace timelines)."""
    return jax.profiler.TraceAnnotation(name)
