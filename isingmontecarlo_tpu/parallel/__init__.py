"""Ensemble / parallel layer: parallel tempering over the replica axis,
sharded across device meshes (reference ``src/sse/parallel_tempering/``)."""

from isingmontecarlo_tpu.parallel.tempering import (
    TemperingContainer,
    tempering_step,
)

__all__ = ["TemperingContainer", "tempering_step"]
