"""Tracing and timing, as the JAX package's `lbmdem_tpu/utils/
profiling.py`: `trace()` records a region with torch.profiler (host and,
on the card, CUDA activity) and exports a Chrome trace; `Timer` gives
wall timings that end in a device synchronize when given a CUDA tensor;
`mlups` is the headline throughput metric."""

from __future__ import annotations

import contextlib
import os
import time

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the region into `logdir/trace.json` (Chrome trace format,
    readable in Perfetto or chrome://tracing):
    `with profiling.trace('out/trace'): sim.run(100)`."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timer:
    """Wall-clock region timer: `with Timer(sync=t) as tm: ...`;
    tm.seconds after the block. A CUDA tensor in `sync` makes the end of
    the region wait for its device's queued work."""

    def __init__(self, sync=None):
        self._sync = sync
        self.seconds = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if isinstance(self._sync, torch.Tensor) and self._sync.is_cuda:
            torch.cuda.synchronize(self._sync.device)
        self.seconds = time.perf_counter() - self._t0
        return False


def mlups(nx: int, ny: int, steps: int, seconds: float) -> float:
    """Million lattice-site updates per second."""
    return nx * ny * steps / seconds / 1e6
