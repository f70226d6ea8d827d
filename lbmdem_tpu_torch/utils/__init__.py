"""Aux subsystems of the port: metrics, checkpointing, VTK and CSV
output (with the native writer), the asynchronous writer, profiling.

The submodules load on first use: the step path imports `profiling`
while `simulation` loads, and `checkpoint` imports `simulation`."""

import importlib

__all__ = ["async_io", "checkpoint", "io_vtk", "metrics", "profiling"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
