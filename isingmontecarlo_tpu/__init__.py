"""isingmontecarlo_tpu: a batched (JAX/XLA + CUDA) Ising Monte Carlo framework.

A from-scratch rebuild of the capability surface of the `qmc` Rust crate
(Renmusxd/IsingMonteCarlo, surveyed in SURVEY.md) designed for accelerators:

- Thousands of independent replicas are batched on a leading axis ``R`` so that
  the branchy per-worldline logic of Monte Carlo updates is amortized over
  wide vector work instead of pointer-chasing linked lists
  (reference: ``src/sse/fast_ops.rs``).
- Counter-based RNG (`jax.random`, threefry) replaces the sequential `rand`
  streams so every lattice site / imaginary-time slot / replica can draw
  randomness independently and reproducibly.
- Replica ensembles (parallel tempering, reference
  ``src/sse/parallel_tempering/``) shard the replica axis over a
  `jax.sharding.Mesh`; replica exchange swaps inverse-temperature *labels*
  device-side instead of moving op-string payloads.

Layout (mirrors the reference layer map, SURVEY.md section 1):

- :mod:`isingmontecarlo_tpu.lattice` — graphs, standard lattices, colorings.
- :mod:`isingmontecarlo_tpu.classical` — classical Ising MC
  (reference ``src/classical/graph.rs``).
- :mod:`isingmontecarlo_tpu.sse` — stochastic series expansion QMC
  (reference ``src/sse/``).
- :mod:`isingmontecarlo_tpu.parallel` — parallel tempering over device meshes.
- :mod:`isingmontecarlo_tpu.analysis` — FFT autocorrelations
  (reference ``src/sse/autocorrelations.rs``).
- :mod:`isingmontecarlo_tpu.ops` — CUDA kernels for two hot paths, and the
  single switch between them and plain XLA.
"""

__version__ = "0.1.0"

from isingmontecarlo_tpu import checkpoint, lattice
from isingmontecarlo_tpu.classical import GraphState
from isingmontecarlo_tpu.parallel import TemperingContainer
from isingmontecarlo_tpu.sse import QmcIsingGraph, Qmc

__all__ = [
    "checkpoint",
    "lattice",
    "GraphState",
    "QmcIsingGraph",
    "Qmc",
    "TemperingContainer",
    "__version__",
]
