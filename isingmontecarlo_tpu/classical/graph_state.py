"""User-facing classical Ising MC API mirroring the reference ``GraphState``
(``src/classical/graph.rs:8-453``), batched over replicas.

The reference object is a single Markov chain; this build runs ``R``
independent chains at once (the throughput comes from the batch). All
reference entry points are mirrored:

- ``GraphState.new(edges, biases, ...)`` (``graph.rs:56-60``)
- ``do_time_step(beta, ...)`` — one MC step choosing uniformly among the move
  classes (single-spin sweeps, edge-flip sweeps, worm updates)
  (``graph.rs:350-406``)
- ``get_energy()`` (``graph.rs:430-447``), state accessors
  (``graph.rs:408-428``)
- ``enable_edge_importance_sampling`` is accepted for API parity; the
  color-parallel edge sweep touches every edge each pass, so importance
  sampling of *which* edge to try is subsumed (documented no-op).

Additional entry points (not in the reference): ``swendsen_wang_step`` / ``wolff_step``
cluster moves and a uniform-lattice fast path (see
:mod:`isingmontecarlo_tpu.classical.metropolis`).
"""

from __future__ import annotations

from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from isingmontecarlo_tpu.classical import cluster as _cluster
from isingmontecarlo_tpu.classical import metropolis as _metro
from isingmontecarlo_tpu.classical import worm as _worm
from isingmontecarlo_tpu.lattice import Edge


class GraphState:
    """Batched classical Ising Monte Carlo on an arbitrary weighted graph."""

    def __init__(
        self,
        edges: Sequence[tuple[Edge, float]],
        biases: Sequence[float],
        *,
        replicas: int = 1,
        seed: int = 0,
        state: np.ndarray | None = None,
    ):
        self.edges = list(edges)
        self.nvars = len(biases)
        self.tables = _metro.build_tables(self.edges, biases)
        self.replicas = replicas
        self._key = jax.random.key(seed)
        if state is None:
            self._key, sub = jax.random.split(self._key)
            # Random initial state (graph.rs:451-453).
            self.spins = jax.random.bernoulli(sub, 0.5, (replicas, self.nvars))
        else:
            state = jnp.asarray(state, dtype=bool)
            if state.ndim == 1:
                state = jnp.broadcast_to(state[None, :], (replicas, self.nvars))
            self.spins = state
        self._only_basic_moves = False
        self._edge_attempt_p = None

    # -- constructors mirroring the reference ------------------------------

    @classmethod
    def new(cls, edges, biases, *, replicas: int = 1, seed: int = 0):
        """Mirror of ``GraphState::new`` (``graph.rs:56-60``)."""
        return cls(edges, biases, replicas=replicas, seed=seed)

    @classmethod
    def new_with_state(cls, state, edges, biases, *, replicas: int = 1, seed: int = 0):
        """Seeded variant of ``GraphState::new_with_state_and_rng``
        (``graph.rs:62-88``)."""
        return cls(edges, biases, replicas=replicas, seed=seed, state=state)

    @classmethod
    def new_with_state_and_rng(cls, state, edges, biases, rng_key, *, replicas: int = 1):
        """Mirror of ``GraphState::new_with_state_and_rng`` (``graph.rs:62-88``):
        like :meth:`new_with_state` but with an explicit PRNG key (the
        reference's caller-supplied ``R: Rng``)."""
        self = cls(edges, biases, replicas=replicas, seed=0, state=state)
        self._key = rng_key
        return self

    # -- moves -------------------------------------------------------------

    def _split(self):
        self._key, sub = jax.random.split(self._key)
        return sub

    def do_time_step(
        self,
        beta: float,
        *,
        nspinupdates: int | None = None,
        nedgeupdates: int | None = None,
        nwormupdates: int | None = None,
        only_basic_moves: bool | None = None,
    ) -> None:
        """One MC step: a uniformly chosen move class (``graph.rs:350-406``).

        The reference performs ``nspinupdates`` single random-site attempts
        (default ``nvars/2``); one color-parallel sweep performs ``nvars``
        attempts, so defaults here are scaled to match attempted-flip counts:
        ``max(1, round(nspinupdates / nvars))`` full sweeps.
        """
        only_basic = (
            self._only_basic_moves if only_basic_moves is None else only_basic_moves
        )
        n_classes = 2 if only_basic else 3
        choice = int(jax.random.randint(self._split(), (), 0, n_classes))
        if choice == 0:
            n = nspinupdates if nspinupdates is not None else max(1, self.nvars // 2)
            sweeps = max(1, round(n / max(1, self.nvars)))
            for _ in range(sweeps):
                self.spins = _metro.spin_flip_sweep(
                    self.spins, self._split(), beta, self.tables
                )
        elif choice == 1:
            n = nedgeupdates if nedgeupdates is not None else max(1, len(self.edges) // 2)
            sweeps = max(1, round(n / max(1, len(self.edges))))
            for _ in range(sweeps):
                self.spins = _metro.edge_flip_sweep(
                    self.spins, self._split(), beta, self.tables,
                    attempt_p=self._edge_attempt_p,
                )
        else:
            n = nwormupdates if nwormupdates is not None else 1
            for _ in range(n):
                self.spins = _worm.worm_sweep(
                    self.spins, self._split(), beta, self.tables
                )

    def run_timesteps(self, t: int, beta: float) -> None:
        for _ in range(t):
            self.do_time_step(beta)

    def do_spin_flip(self, beta: float) -> None:
        """One color-parallel single-spin-flip sweep (``graph.rs:91-119``;
        the reference flips one random site per call — here every replica
        attempts every site once per sweep)."""
        self.spins = _metro.spin_flip_sweep(
            self.spins, self._split(), beta, self.tables
        )

    @staticmethod
    def should_flip(key: jax.Array, beta, delta_e) -> jax.Array:
        """Batched Metropolis accept (``graph.rs:339-347``): always when
        ``delta_e <= 0``, else with probability ``exp(-beta*delta_e)``."""
        delta_e = jnp.asarray(delta_e, jnp.float32)
        u = jax.random.uniform(key, jnp.shape(delta_e))
        return (delta_e <= 0.0) | (u < jnp.exp(-beta * delta_e))

    def swendsen_wang_step(self, beta: float) -> None:
        """Extra move (not in the reference): Swendsen-Wang sweep."""
        self.spins = _cluster.swendsen_wang_sweep(
            self.spins, self._split(), beta, self.tables
        )

    def wolff_step(self, beta: float) -> None:
        """Extra move (not in the reference): Wolff cluster flip."""
        self.spins = _cluster.wolff_sweep(
            self.spins, self._split(), beta, self.tables
        )

    def enable_edge_importance_sampling(self, enable: bool) -> None:
        """Edge importance sampling (``graph.rs:321-336``): the reference
        draws flip-attempt edges proportionally to their coupling weight;
        here each edge attempts with probability ``w_e / w_max`` per sweep —
        the same attempt-frequency profile, still a valid composition of
        per-edge Metropolis kernels."""
        if enable and self.edges:
            w = jnp.abs(self.tables.ej)
            self._edge_attempt_p = w / jnp.maximum(jnp.max(w), 1e-30)
        else:
            self._edge_attempt_p = None

    # -- accessors ---------------------------------------------------------

    def get_energy(self) -> jax.Array:
        """Energy per replica, ``f32[R]`` (``graph.rs:430-447``)."""
        return _metro.energy(self.spins, self.tables)

    def get_magnetization(self) -> jax.Array:
        return _metro.magnetization(self.spins)

    def clone_state(self) -> np.ndarray:
        return np.asarray(self.spins)

    def get_state(self) -> np.ndarray:
        """Consume into the spin state (``graph.rs:409-412``)."""
        return np.asarray(self.spins)

    def state_ref(self) -> jax.Array:
        return self.spins

    def set_state(self, state) -> None:
        state = jnp.asarray(state, dtype=bool)
        if state.ndim == 1:
            state = jnp.broadcast_to(state[None, :], self.spins.shape)
        assert state.shape == self.spins.shape
        self.spins = state

    def __repr__(self) -> str:
        """Per-replica ``<bits>\\t<energy>`` lines (the reference ``Debug``
        impl, ``graph.rs:17-31``)."""
        bits = np.asarray(self.spins).astype(np.uint8)
        energies = np.asarray(self.get_energy())
        return "\n".join(
            "".join("1" if b else "0" for b in row) + f"\t{e}"
            for row, e in zip(bits, energies)
        )


def make_random_spin_state(n: int, key: jax.Array, replicas: int = 1) -> jax.Array:
    """Mirror of ``make_random_spin_state`` (``graph.rs:451-453``), batched."""
    return jax.random.bernoulli(key, 0.5, (replicas, n))
