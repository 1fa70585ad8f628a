"""The one place that chooses between the CUDA kernels and plain XLA.

On a GPU backend the hand-written kernels of ``kernels.cu`` run, and a
failure to build or load them is an error: there is no silent fallback to
the XLA paths. Every other backend (the CPU test mesh among them) runs the
plain-XLA paths, which are also the kernels' references. :func:`plain_xla`
runs the XLA paths on the GPU too, for comparing a kernel with its
reference on the card.
"""

from __future__ import annotations

import contextlib

import jax

_plain_xla = False


def gpu_kernels() -> bool:
    """Whether the CUDA kernels run on the default backend. On a GPU this
    builds and registers them on first call (raising if that fails)."""
    if _plain_xla or jax.default_backend() != "gpu":
        return False
    from isingmontecarlo_tpu.ops import _cuda

    _cuda.register()
    return True


@contextlib.contextmanager
def plain_xla():
    """Trace with the plain-XLA paths on every backend inside the block.
    The choice is made at trace time, so jit caches are cleared on entry
    and exit."""
    global _plain_xla
    jax.clear_caches()
    _plain_xla = True
    try:
        yield
    finally:
        _plain_xla = False
        jax.clear_caches()
