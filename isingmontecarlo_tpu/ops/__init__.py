"""Hand-written CUDA kernels and the choice between them and plain XLA.

- :mod:`.checkerboard`: multi-sweep checkerboard Metropolis with the spin
  field held in shared memory (classical 2-D lattice path).
- :mod:`.diag_carry`: the SSE diagonal update's sequential op-count carry.
- :mod:`.backend`: :func:`~.backend.gpu_kernels`, the single backend switch.

The kernels live in ``kernels.cu`` and are built with ``nvcc`` on first use
on a GPU (:mod:`._cuda`); each has a plain-JAX twin that the CPU tests run.
"""
