"""Uniform periodic square-lattice fast path — the user-facing wrapper over
the CUDA checkerboard kernel (the 256^2 benchmark workload, BASELINE.md
config 2).

The general :class:`~isingmontecarlo_tpu.classical.graph_state.GraphState`
handles arbitrary weighted graphs through compiled adjacency tables; this
class exploits lattice uniformity: spins live as ``bool[R, L, L]``, neighbor
sums are rolls, and on a GPU (L a multiple of 4, up to 480) whole multi-sweep
runs keep each replica's field in shared memory via
:func:`isingmontecarlo_tpu.ops.checkerboard.checkerboard_multi_sweep`.
Energy conventions match ``src/classical/graph.rs:430-447``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from isingmontecarlo_tpu.classical import metropolis as _metro


class LatticeIsing:
    """Batched classical Ising model on an L x L periodic lattice with
    uniform coupling ``j`` and field ``h``."""

    def __init__(
        self,
        L: int,
        j: float = -1.0,
        h: float = 0.0,
        *,
        replicas: int = 1,
        seed: int = 0,
        state: np.ndarray | None = None,
    ):
        self.L = L
        self.j = float(j)
        self.h = float(h)
        self.replicas = replicas
        self._seed = seed
        self._sweep_counter = 0
        if state is None:
            key = jax.random.key(seed)
            self.spins = jax.random.bernoulli(key, 0.5, (replicas, L, L))
        else:
            spins = jnp.asarray(state, bool)
            if spins.ndim == 2:
                spins = jnp.broadcast_to(spins[None], (replicas, L, L))
            self.spins = spins

    def run_sweeps(self, nsweeps: int, beta: float) -> None:
        """``nsweeps`` full checkerboard Metropolis sweeps (the CUDA kernel on
        a GPU where it takes L, the fused XLA scan otherwise)."""
        self._sweep_counter += 1
        self.spins = _metro.lattice_multi_sweep(
            self.spins,
            self._seed * 1000003 + self._sweep_counter,
            beta, self.j, self.h, nsweeps,
        )

    def get_energy(self) -> jax.Array:
        """Total energy per replica ``f32[R]`` (``graph.rs:430-447``)."""
        return _metro.lattice_energy(self.spins, self.j, self.h)

    def get_magnetization(self) -> jax.Array:
        """Sum of spins (+-1) per replica."""
        s = 2.0 * self.spins.astype(jnp.float32) - 1.0
        return jnp.sum(s, axis=(-1, -2))

    def state_ref(self) -> jax.Array:
        return self.spins

    def clone_state(self) -> np.ndarray:
        return np.asarray(self.spins)
