"""Classical Ising Monte Carlo (reference: ``src/classical/graph.rs``).

Batched design: spins live as ``bool[R, N]`` (R replicas batched on the
leading axis), updates are color-parallel Metropolis sweeps, matching-parallel
edge flips, batched zero-energy worm walks, and Swendsen-Wang cluster flips on
lattices. Energy/magnetization estimators are fused reductions.
"""

from isingmontecarlo_tpu.classical.graph_state import GraphState
from isingmontecarlo_tpu.classical.lattice_ising import LatticeIsing
from isingmontecarlo_tpu.classical import metropolis, worm, cluster

__all__ = ["GraphState", "LatticeIsing", "metropolis", "worm", "cluster"]
