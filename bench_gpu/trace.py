"""The traced window: torch.profiler's device and host records, reduced
to what the per-layer metrics read.

`Recorder` profiles the window's first TRACE_SECONDS (a workload's
"trace_seconds" where it gives one; CPU and CUDA activities): a whole
coupled window of 51 s leaves about five million records, whose
reading alone would take a minute. `reduce`
turns its records into a `Trace`: the device records in time order, the
union of their intervals (busy seconds), each hand-written kernel's
device seconds and calls (the patterns of `bench_gpu/work/`), the device
seconds no kernel claims (the glue), the operations that took most
device time and the longest idle gaps named by what the host was doing.
A window whose profiler kept no device record raises: no metric is read
from an empty trace.
"""

from __future__ import annotations

import dataclasses
import importlib
import pkgutil
import re
from typing import Dict, List, Tuple

import numpy as np

from bench_gpu import work as work_pkg


# seconds of the window that a traced run records
TRACE_SECONDS = 10.0


class NoDeviceRecords(RuntimeError):
    """torch.profiler kept no device record over the window."""


@dataclasses.dataclass
class Trace:
    """What the per-layer readers read of one traced window."""

    window_s: float  # the traced part's host-clock length
    steps: int  # LBM steps the traced part completed
    busy_s: float  # union of the device records' intervals
    records: int  # device records: kernels, copies, sets
    kernels: Dict[str, Tuple[float, int]]  # kernel -> (device s, calls)
    glue_s: float  # device seconds of records no kernel claims
    device_ops: List[Tuple[str, float]]  # most device time, by name
    idle_gaps: List[Tuple[str, float]]  # longest gaps, by host activity


def kernel_files() -> Dict[str, object]:
    """Every module of bench_gpu/work/ (one per kernel), by name."""
    mods = {}
    for info in pkgutil.iter_modules(work_pkg.__path__):
        mods[info.name] = importlib.import_module(
            f"bench_gpu.work.{info.name}")
    return mods


def short_name(name: str) -> str:
    """A device record's name without `void `, anonymous namespaces and
    the parameter list."""
    s = name.replace("void ", "").replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(s):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return s[:i].strip()
    return s.strip()


class Recorder:
    """torch.profiler over the window, CPU and CUDA activities."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def raw(self):
        """(device, host) records as (names, start_ns, end_ns): the
        records on the card (kernels, copies, sets) and every host record
        (its name read only where a gap needs one: `names` is then a list
        of the profiler's events and `host_activity` reads the name)."""
        from torch.autograd import DeviceType

        cuda = DeviceType.CUDA
        events = self.prof.profiler.kineto_results.events()
        dev_n, dev_a, dev_b, host, host_a, host_b = [], [], [], [], [], []
        for e in events:
            a = e.start_ns()
            b = a + e.duration_ns()
            if e.device_type() == cuda:
                dev_n.append(e.name())
                dev_a.append(a)
                dev_b.append(b)
            else:
                host.append(e)
                host_a.append(a)
                host_b.append(b)
        return ((dev_n, np.asarray(dev_a, np.int64),
                 np.asarray(dev_b, np.int64)),
                (host, np.asarray(host_a, np.int64),
                 np.asarray(host_b, np.int64)))


def union(a: np.ndarray, b: np.ndarray):
    """Merged intervals [(start, end)] of the intervals a[i]..b[i]."""
    order = np.argsort(a, kind="stable")
    out: List[List[int]] = []
    for s, e in zip(a[order].tolist(), b[order].tolist()):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def attribute(names: List[str], starts: np.ndarray, ends: np.ndarray,
              files: Dict[str, object]):
    """Each kernel's (device seconds, calls) and the unclaimed seconds,
    walking the device records in time order (bench_gpu/work/'s MATCH,
    WITH and AFTER rules)."""
    pats = {k: (re.compile(m.MATCH), [re.compile(w) for w in m.WITH],
                m.AFTER) for k, m in files.items()}
    owners: Dict[str, List[str]] = {}
    tails: Dict[str, Dict[str, bool]] = {}
    stats = {k: [0.0, 0] for k in files}
    glue = 0.0
    last = None
    for i in np.argsort(starts, kind="stable").tolist():
        name = names[i]
        dur = (ends[i] - starts[i]) * 1e-9
        if name not in owners:
            owners[name] = [k for k, (m, _, _) in pats.items()
                            if m.search(name)]
            tails[name] = {k: any(w.search(name) for w in ws)
                           for k, (_, ws, _) in pats.items()}
        hit = None
        for k in owners[name]:
            after = pats[k][2]
            if after is None or last in after:
                hit = k
                break
        if hit is not None:
            stats[hit][0] += dur
            stats[hit][1] += 1
            if pats[hit][2] is None:
                last = hit
        elif last is not None and tails[name][last]:
            stats[last][0] += dur
        else:
            glue += dur
    return {k: (s, c) for k, (s, c) in stats.items() if c}, glue


def host_activity(gap: Tuple[int, int], host) -> str:
    """What the host was doing over an idle gap: the shortest host record
    that covers at least half of it, else the one that overlaps it
    most; "host code outside any operation" where none does."""
    names, a, b = host
    if not len(a):
        return "host code outside any operation"
    lo, hi = gap
    over = np.minimum(b, hi) - np.maximum(a, lo)
    if over.max() <= 0:
        return "host code outside any operation"
    half = np.nonzero(over >= 0.5 * (hi - lo))[0]
    if len(half):
        i = int(half[np.argmin((b - a)[half])])
    else:
        i = int(np.argmax(over))
    return names[i] if isinstance(names[i], str) else names[i].name()


def reduce(recorder: Recorder, window_s: float, steps: int,
           top: int = 10) -> Trace:
    """The Trace of a recorded window. Raises NoDeviceRecords when the
    profiler kept none."""
    (dn, da, db), host = recorder.raw()
    if not dn:
        raise NoDeviceRecords(
            "torch.profiler kept no device records over the window: no "
            "per-layer metric can be read")
    spans = union(da, db)
    busy = sum(e - s for s, e in spans) * 1e-9
    kernels, glue = attribute(dn, da, db, kernel_files())
    raw_ns: Dict[str, int] = {}
    for n, s, e in zip(dn, da.tolist(), db.tolist()):
        raw_ns[n] = raw_ns.get(n, 0) + (e - s)
    by_name: Dict[str, float] = {}
    for n, ns in raw_ns.items():
        k = short_name(n)
        by_name[k] = by_name.get(k, 0.0) + ns * 1e-9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(((spans[i][1], spans[i + 1][0])
                   for i in range(len(spans) - 1)),
                  key=lambda g: g[0] - g[1])[:top]
    idle = [(host_activity(g, host), (g[1] - g[0]) * 1e-9) for g in gaps]
    return Trace(window_s=window_s, steps=steps, busy_s=busy,
                 records=len(dn), kernels=kernels, glue_s=glue,
                 device_ops=ops, idle_gaps=idle)
