"""Build, load and register the CUDA kernels of ``kernels.cu``.

The shared library is compiled with ``nvcc`` for ``sm_90a`` on first use into
``ops/_build/`` (gitignored), named by a hash of the source and flags, so an
edited source rebuilds and an unchanged one loads at once. The build holds a
file lock, so concurrent processes compile it once. Build time is set-up time
of the first GPU call (tens of seconds).

To build ahead of time: ``python -m isingmontecarlo_tpu.ops._cuda``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading

import jax

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "kernels.cu")
_BUILD = os.path.join(_HERE, "_build")
_ARCH = "-gencode=arch=compute_90a,code=sm_90a"
_TARGETS = {
    "ising_diag_carry_metropolis": "IsingDiagCarryMetropolis",
    "ising_diag_carry_heatbath": "IsingDiagCarryHeatbath",
    "ising_checkerboard": "IsingCheckerboard",
}

_lock = threading.Lock()
_registered = False


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels need the CUDA toolkit on PATH or "
        "under /usr/local/cuda"
    )


def _flags() -> list[str]:
    return [
        _ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-I", jax.ffi.include_dir(),
    ]


def library_path() -> str:
    """Path of the shared library for the current source, built if absent."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_flags()).encode())
    so = os.path.join(_BUILD, f"libising_kernels_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD, exist_ok=True)
    with open(os.path.join(_BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not os.path.exists(so):
            tmp = f"{so}.{os.getpid()}.tmp"
            proc = subprocess.run(
                [_nvcc(), *_flags(), "-o", tmp, _SRC],
                capture_output=True, text=True, timeout=600,
            )
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{proc.stderr[-4000:]}")
            os.replace(tmp, so)
    return so


def register() -> None:
    """Load the library and register its FFI targets for CUDA (once)."""
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.cdll.LoadLibrary(library_path())
        for name, symbol in _TARGETS.items():
            jax.ffi.register_ffi_target(
                name, jax.ffi.pycapsule(getattr(lib, symbol)), platform="CUDA"
            )
        _registered = True


if __name__ == "__main__":
    print(library_path())
