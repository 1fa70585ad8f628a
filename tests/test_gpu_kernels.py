"""The CUDA kernels on the card, each against its reference. Marked ``gpu``:
they skip here and run on an NVIDIA GPU with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_kernels.py
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from isingmontecarlo_tpu import lattice
from isingmontecarlo_tpu.classical.lattice_ising import LatticeIsing
from isingmontecarlo_tpu.ops import backend, checkerboard, diag_carry
from isingmontecarlo_tpu.sse import diagonal as _diag
from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, multi_sweep

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("gpu")]


class TestCheckerboardKernel:
    @pytest.mark.parametrize("L,R", [(256, 64), (12, 3)])
    def test_bit_identical_to_twin(self, L, R):
        spins = jax.random.bernoulli(jax.random.key(0), 0.5, (R, L, L))
        thr = checkerboard.thresholds(0.44, -1.0, 0.1)
        a = checkerboard.checkerboard_multi_sweep(spins, np.uint32(7), thr, 10)
        b = checkerboard.checkerboard_twin(spins, np.uint32(7), thr, 10)
        assert np.array_equal(np.asarray(a), np.asarray(b))

    def test_lattice_ising_wrapper(self):
        m = LatticeIsing(128, j=-1.0, replicas=8, seed=1)
        e0 = float(np.mean(np.asarray(m.get_energy())))
        m.run_sweeps(100, beta=0.6)
        e1 = float(np.mean(np.asarray(m.get_energy())))
        assert e1 < e0, "ferromagnet should lower energy at low T"


class TestCarryKernel:
    @pytest.mark.parametrize("heatbath", [False, True])
    def test_diagonal_update_bit_identical(self, heatbath):
        g = QmcIsingGraph(
            lattice.frustrated_square(6, 6), transverse=1.0, replicas=40,
            seed=9,
        )
        g.sse, _, _, _ = multi_sweep(g.sse, jnp.float32(1.2), g.model, 10)
        g._maybe_grow()
        ops, state, model = g.sse.ops, g.sse.state, g.model
        hbt = _diag.make_heatbath_tables(model) if heatbath else None

        def run():
            return _diag._diagonal_update_fast(
                ops, state, jnp.float32(1.2), jax.random.key(7), model,
                hb=hbt, heatbath=heatbath,
            )

        a = run()
        with backend.plain_xla():
            b = run()
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            assert np.array_equal(np.asarray(x), np.asarray(y))

    def test_odd_shapes_match_reference(self):
        rng = np.random.default_rng(0)
        M, R = 37, 45  # neither a multiple of the slot group nor a warp
        u0 = jnp.asarray(rng.random((M, R), np.float32))
        kind = jnp.asarray(rng.integers(0, 3, (M, R)).astype(np.uint8))
        thr = jnp.asarray(rng.gamma(2.0, 20.0, (M, R)).astype(np.float32))
        n0 = jnp.asarray(rng.integers(0, M, R).astype(np.int32))
        a = diag_carry.carry_kernel(n0, u0, kind, thr, None, heatbath=False)
        b = diag_carry.carry_reference(n0, u0, kind, thr, None, heatbath=False)
        assert np.array_equal(np.asarray(a), np.asarray(b))
