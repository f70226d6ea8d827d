"""Tracing of the program, as the JAX package's `lbmdem_tpu/utils/
profiling.py`: `trace()` records a region with torch.profiler (host and,
on the card, CUDA activity) and exports a Chrome trace.

Inside the program, `span(name)` marks a layer of the work. Under a
running torch.profiler (`trace()`, or any other) it is a host record of
the profiler's own timeline, on the device records' clock; otherwise it
is one check and a shared null context. The spans are named `lbmdem.*`
and nest:

    lbmdem.run             one Simulation.run call
      lbmdem.block         one Verlet-cadence block of the coupled chunk
        lbmdem.block.bin       periodic ghosts and tile lists
        lbmdem.block.closures  the block's step closures
      lbmdem.static.stamp  the static hoist's one stamp of its solid
                           stack (K1 and the static_binning wait)
      lbmdem.static.chunk  the static hoist's chunk: its K7 passes
      lbmdem.step          one step, coupling window or K5/K7 pass (in
                           lbmdem.block or lbmdem.static.chunk where
                           there is one)
        lbmdem.glue.inputs     travel check, ghosts, gather_tile_data
        lbmdem.glue.hydro      gather_partials and the ghost fold
        lbmdem.dem.build_slabs / lbmdem.dem.unslab
      lbmdem.sync.<site>   a wait on the device (device_wait)
      lbmdem.callback      the user's callback

Every blocking wait that `Simulation.run` makes on the device (a
device-to-host read or a synchronize, on one device or a mesh) goes
through `device_wait`, which counts it and its host-clock nanoseconds
whether or not a profiler runs. The sites: `run_end` (the call's last
synchronize), `callback` (before the user's callback), `health`
(paranoia's check), `static_binning` (the all-fixed path's one overflow
check). The coupled step itself makes none: the slab DEM's leftover
fallback reads its overflow count on the device. `counters()` reads the
counts, which only grow: take differences around a region. Reads made
outside `run` (`state`, `disk_arrays`, the snapshot helpers) are not
counted.

`static_stamped()` counts the solid stacks that the static hoist
stamps (one per Simulation, and one more after each `load_state`): a
host integer, which `counters()` reads as "static_stamps".

`fallback_steps(device)` is a count on the device that the leftover
fallback adds its steps to (those in which it integrated some disk)
without a host read; `counters()` reads it, a wait of its own, so the
program never calls it inside `run`.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

_NULL = contextlib.nullcontext()
try:
    from torch._C._profiler import _RecordFunctionFast
    _recording = torch.autograd._profiler_enabled
except ImportError:  # a torch without it records no spans; waits still count
    def _recording():
        return False
# [waits, nanoseconds waited]
_WAITS = [0, 0]
# [solid stacks the static hoist stamped]
_STAMPS = [0]
# device -> () int32 count of the leftover fallback's steps
_FALLBACK_STEPS: dict = {}


def span(name: str):
    """A context that records `name` as a host span under a running
    profiler, and the shared null context otherwise. The span is a plain
    operator record, not a user annotation: a `record_function` would
    also put a copy of itself on the device's timeline, where a reader
    of device records takes it for work."""
    if not _recording():
        return _NULL
    return _RecordFunctionFast(name)


def device_wait(site: str, fn, *args):
    """`fn(*args)`, a call that blocks until the device has caught up,
    counted as one wait with its host-clock duration, and recorded as
    the span `lbmdem.sync.<site>` under a running profiler."""
    t = time.perf_counter_ns()
    if _recording():
        with _RecordFunctionFast("lbmdem.sync." + site):
            out = fn(*args)
    else:
        out = fn(*args)
    _WAITS[1] += time.perf_counter_ns() - t
    _WAITS[0] += 1
    return out


def static_stamped() -> None:
    """Count one stamp of the static hoist's solid stack."""
    _STAMPS[0] += 1


def fallback_steps(device: torch.device) -> torch.Tensor:
    """The () int32 count of the leftover fallback's steps on `device`,
    made (zero) at first use, for the fallback to add to in place."""
    if device not in _FALLBACK_STEPS:
        _FALLBACK_STEPS[device] = torch.zeros((), dtype=torch.int32,
                                              device=device)
    return _FALLBACK_STEPS[device]


def counters() -> dict:
    """The process's waits on the device so far, {"syncs": count,
    "sync_wait_s": host seconds spent in them}, the static hoist's
    stamps ("static_stamps") and the leftover fallback's steps summed
    over devices ("fallback_steps"; reading it on the card waits for
    it)."""
    return {"syncs": _WAITS[0], "sync_wait_s": _WAITS[1] * 1e-9,
            "static_stamps": _STAMPS[0],
            "fallback_steps": sum(int(t) for t in _FALLBACK_STEPS.values())}


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the region into `logdir/trace.json` (Chrome trace format,
    readable in Perfetto or chrome://tracing), the program's `lbmdem.*`
    spans included: `with profiling.trace('out/trace'): sim.run(100)`."""
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
