"""Stochastic Series Expansion QMC (reference: ``src/sse/``).

Batched reformulation of the reference's SSE stack:

- The operator string is a fixed-capacity struct-of-arrays tensor
  (:mod:`~isingmontecarlo_tpu.sse.opstring`) instead of linked-list nodes
  (``src/sse/fast_ops.rs``); per-variable adjacency is *derived* on demand by
  sorting legs along imaginary time.
- The Hamiltonian is compiled into dense weight tables
  (:mod:`~isingmontecarlo_tpu.sse.model`) instead of closures
  (``src/sse/ham.rs``).
- Update algorithms (diagonal, heat-bath, cluster, directed loop) are batched
  over a leading replica axis; sequential imaginary-time sweeps become
  ``lax.scan``, cluster construction becomes label propagation.
"""

from isingmontecarlo_tpu.sse.model import BondModel, tfim_model
from isingmontecarlo_tpu.sse.opstring import OpString, empty_opstring, op_count, verify
from isingmontecarlo_tpu.sse.ising import QmcIsingGraph, new_qmc, new_qmc_from_graph
from isingmontecarlo_tpu.sse.runner import Qmc

__all__ = [
    "BondModel",
    "tfim_model",
    "OpString",
    "empty_opstring",
    "op_count",
    "verify",
    "QmcIsingGraph",
    "new_qmc",
    "new_qmc_from_graph",
    "Qmc",
]
