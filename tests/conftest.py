"""Test configuration: CPU JAX with a virtual 8-device mesh, so the
multi-device sharding paths compile and execute without accelerators.
Tests that need an NVIDIA GPU carry the ``gpu`` marker and the ``gpu``
fixture, which skips them elsewhere; run them on a card with
``JAX_PLATFORMS=cuda python -m pytest -m gpu tests/``."""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    _flags = (_flags + " --xla_force_host_platform_device_count=8").strip()
if "--xla_cpu_max_isa" not in _flags:
    # A conservative ISA keeps XLA:CPU's JIT away from host features a
    # migrated VM may lack (and keeps cached CPU executables portable).
    _flags = _flags + " --xla_cpu_max_isa=AVX2"
os.environ["XLA_FLAGS"] = _flags

import jax  # noqa: E402  (after env setup)
import pytest  # noqa: E402

from isingmontecarlo_tpu.ops import _cuda, checkerboard, diag_carry  # noqa: E402

from isingmontecarlo_tpu import compile_cache  # noqa: E402

compile_cache.enable()


@pytest.fixture
def gpu():
    """Skip unless the default backend is a GPU (decided at run time, never
    at import, so every xdist worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU")


@pytest.fixture
def fake_gpu(monkeypatch):
    """Dispatch as on a GPU, with each kernel replaced by its plain twin —
    exercises the wrappers' packing, shapes and dispatch on the CPU."""
    calls = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(_cuda, "register", lambda: None)

    def carry(n0, u0, kind, thr, bwt, *, heatbath):
        calls.append("carry")
        return diag_carry.carry_reference(
            n0, u0, kind, thr, bwt, heatbath=heatbath
        )

    def board(spins, seed, thr, nsweeps):
        calls.append("checkerboard")
        return checkerboard.checkerboard_twin(spins, seed, thr, nsweeps)

    monkeypatch.setattr(diag_carry, "carry_kernel", carry)
    monkeypatch.setattr(checkerboard, "checkerboard_multi_sweep", board)
    jax.clear_caches()
    yield calls
    jax.clear_caches()
