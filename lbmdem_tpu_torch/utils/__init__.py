"""Aux subsystems of the port: metrics, checkpointing, VTK and CSV
output (with the native writer), the asynchronous writer, profiling."""

from lbmdem_tpu_torch.utils import (async_io, checkpoint, io_vtk, metrics,
                                    profiling)

__all__ = ["async_io", "checkpoint", "io_vtk", "metrics", "profiling"]
