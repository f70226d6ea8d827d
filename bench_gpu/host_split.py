"""Where the host holds the device: the program's own spans and its count
of waits on the device, read against the device records of a traced
window.

    python3 -m bench_gpu.host_split --workload <cell> --seed <n> \
        --seconds <s>

runs a cell's set-up and window through `bench_gpu.run` (`set_up`, then
`window` twice: traced for the first `trace.TRACE_SECONDS`, then
untraced to `--seconds`; no check against the reference) and prints, as
one JSON line on standard output,

- `host_syncs_per_step`: the program's waits on the device
  (`lbmdem_tpu_torch.utils.profiling.counters()`) over the untraced
  calls, per step;
- `host_enqueue_ms_per_step`: the untraced calls' wall time less the
  time they spent waiting on the device, per step: the host's own time
  to launch the work;
- `sync_idle_ms_per_step`: in the traced part, the device's idle time
  from the start of each `lbmdem.sync.*` span to the device start of the
  first hand-written kernel (`bench_gpu/work/`) after the span ends, per
  traced step: the idle that the waits expose;
- `idle_by_span`: the traced idle split by the program span over each
  gap, and `idle_gaps`, the longest gaps named span first;

and the split on standard error. A program without the counter (one
older than it) gives None for the counter numbers.

This module stands in until `bench_gpu/run.py` reads the counter over
the window and `bench_gpu/trace.py` keeps the host records for the
readers; then these numbers become per-layer metrics and it goes.
"""

from __future__ import annotations

import json
import sys
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import re  # noqa: E402
from typing import Dict, List, Optional, Tuple  # noqa: E402

import numpy as np  # noqa: E402

from bench_gpu import trace as tracing  # noqa: E402

SPAN = "lbmdem."
SYNC = "lbmdem.sync."
OUTSIDE = "outside any lbmdem span"


def split_host(host):
    """The host records of Recorder.raw() split into the program's spans
    and the rest, each as (names, start_ns, end_ns) with names as str."""
    names, a, b = host
    names = [x if isinstance(x, str) else x.name() for x in names]
    mine = np.fromiter((n.startswith(SPAN) for n in names), bool,
                       len(names))
    pick = np.nonzero(mine)[0].tolist()
    rest = np.nonzero(~mine)[0].tolist()
    return (([names[i] for i in pick], a[mine], b[mine]),
            ([names[i] for i in rest], a[~mine], b[~mine]))


def gap_spans(gaps: List[Tuple[int, int]], spans) -> List[Optional[str]]:
    """For each gap (start_ns, end_ns), in time order, the program span
    over it: trace.host_activity on the spans that overlap the gap, None
    where none does."""
    names, a, b = spans
    order = np.argsort(a, kind="stable").tolist()
    out: List[Optional[str]] = []
    active: List[int] = []
    j = 0
    for lo, hi in gaps:
        while j < len(order) and a[order[j]] < hi:
            active.append(order[j])
            j += 1
        # spans that end before this gap end before every later one
        active = [s for s in active if b[s] > lo]
        out.append(tracing.host_activity(
            (lo, hi), ([names[s] for s in active], a[active], b[active]))
            if active else None)
    return out


def gap_name(span: Optional[str], op: str) -> str:
    """A gap's name: its program span, then the host's operation."""
    return op if span is None else f"{span} {op}"


def busy_before(busy: List[List[int]]):
    """t -> device-busy nanoseconds before t, over merged intervals."""
    s = np.asarray([x[0] for x in busy], np.int64)
    e = np.asarray([x[1] for x in busy], np.int64)
    cum = np.concatenate([[0], np.cumsum(e - s)])

    def at(t):
        t = np.asarray(t, np.int64)
        i = np.searchsorted(s, t, side="right") - 1
        inside = np.where(i >= 0, np.minimum(t, e[np.maximum(i, 0)])
                          - s[np.maximum(i, 0)], 0)
        return np.where(i >= 0, cum[np.maximum(i, 0)] + inside, 0)

    return at


def sync_idle_s(spans, dev, files) -> float:
    """Device-idle seconds from the start of each lbmdem.sync.* span to
    the device start of the first hand-written kernel record (a pattern
    of bench_gpu/work/) that starts after the span ends; the stretches'
    union is counted once. Without such a kernel a stretch ends at the
    last device record."""
    names, a, b = spans
    dn, da, db = dev
    if not len(da):
        return 0.0
    pats = [re.compile(m.MATCH) for m in files.values()]
    kernel = {n: any(p.search(n) for p in pats) for n in set(dn)}
    ks = np.sort(da[np.fromiter((kernel[n] for n in dn), bool, len(dn))])
    last = int(db.max())
    stretch = []
    for n, s, e in zip(names, a.tolist(), b.tolist()):
        if not n.startswith(SYNC):
            continue
        i = np.searchsorted(ks, e, side="left")
        end = int(ks[i]) if i < len(ks) else last
        if end > s:
            stretch.append((s, end))
    if not stretch:
        return 0.0
    merged = tracing.union(np.asarray([x[0] for x in stretch], np.int64),
                           np.asarray([x[1] for x in stretch], np.int64))
    lo = np.asarray([x[0] for x in merged], np.int64)
    hi = np.asarray([x[1] for x in merged], np.int64)
    busy = busy_before(tracing.union(da, db))
    return float(((hi - lo) - (busy(hi) - busy(lo))).sum()) * 1e-9


def idle_split(dev, spans, host, top: int = 10):
    """The device's idle gaps between its records: (seconds by program
    span, the `top` longest gaps as [name, seconds], their seconds in
    all)."""
    dn, da, db = dev
    busy = tracing.union(da, db)
    gaps = [(busy[i][1], busy[i + 1][0]) for i in range(len(busy) - 1)]
    owner = gap_spans(gaps, spans)
    by: Dict[str, float] = {}
    for (lo, hi), sp in zip(gaps, owner):
        key = OUTSIDE if sp is None else sp
        by[key] = by.get(key, 0.0) + (hi - lo) * 1e-9
    longest = sorted(range(len(gaps)), key=lambda i: gaps[i][0]
                     - gaps[i][1])[:top]
    named = [[gap_name(owner[i], tracing.host_activity(gaps[i], host)),
              (gaps[i][1] - gaps[i][0]) * 1e-9] for i in longest]
    return by, named, sum(hi - lo for lo, hi in gaps) * 1e-9


def counter_numbers(c0, c1, steps: int, wall_s: float) -> dict:
    """The counter numbers over calls of `steps` steps and `wall_s`
    wall seconds, between two readings of profiling.counters() (None
    without the counter, or without steps)."""
    if c0 is None or c1 is None or steps <= 0:
        return {"host_syncs_per_step": None, "host_enqueue_ms_per_step": None}
    wait = c1["sync_wait_s"] - c0["sync_wait_s"]
    return {"host_syncs_per_step": (c1["syncs"] - c0["syncs"]) / steps,
            "host_enqueue_ms_per_step": 1e3 * (wall_s - wait) / steps}


def _counters():
    try:
        from lbmdem_tpu_torch.utils import profiling
        return profiling.counters()
    except (ImportError, AttributeError):
        return None


def reduce(raw, traced: Tuple[int, float], untraced) -> dict:
    """The numbers of one window: the recorder's raw records of the
    traced part (steps, seconds), and the untraced part as (steps, wall
    seconds, counters before, counters after)."""
    dev, host = raw
    spans, rest = split_host(host)
    steps, wall, c0, c1 = untraced
    out = counter_numbers(c0, c1, steps, wall)
    out["sync_idle_ms_per_step"] = (
        1e3 * sync_idle_s(spans, dev, tracing.kernel_files()) / traced[0]
        if spans[0] else None)
    by, named, gap_s = idle_split(dev, spans, rest)
    out["gap_s"] = gap_s
    out["idle_by_span"] = dict(sorted(by.items(), key=lambda kv: -kv[1]))
    out["idle_gaps"] = named
    out["traced"] = {"steps": traced[0], "seconds": traced[1]}
    out["untraced"] = {"steps": steps, "seconds": wall, "waits": (
        None if c0 is None or c1 is None else
        {k: c1[k] - c0[k] for k in ("syncs", "sync_wait_s")})}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    import torch

    from bench_gpu import run, scenes, spec

    cell = spec.cell(spec.load_benchmark(), args.workload)
    if not torch.cuda.is_available():
        print("bench_gpu.host_split: no CUDA device", file=sys.stderr)
        return 2
    w = cell.workload
    chunk = int(w["chunk"])
    sim_kw = dict(cell.config["sim"], coupling_k=int(w.get("coupling_k", 1)))
    scene = scenes.build(cell.config, w, args.seed)
    sim, _, setup_s, _ = run.set_up(cell, sim_kw, scene, "cuda", T0)
    trace_s = float(w.get("trace_seconds", tracing.TRACE_SECONDS))
    rec = tracing.Recorder()
    _, _, wall, traced = run.window(sim, chunk, trace_s, rec, trace_s, True)
    c0 = _counters()
    steps, _, wall_u, _ = run.window(sim, chunk, args.seconds - wall, None,
                                     trace_s, True)
    t = time.perf_counter()
    out = reduce(rec.raw(), traced, (steps, wall_u, c0, _counters()))
    out["reduce_s"] = time.perf_counter() - t
    out["setup_s"] = setup_s
    out["device"] = {"kind": torch.cuda.get_device_name(0),
                     "power_limit_w": run.power_limit()}
    for name, s in out["idle_by_span"].items():
        print(f"idle {name}: {1e3 * s / traced[0]:.4f} ms/step "
              f"({100 * s / out['gap_s']:.2f} % of the gaps)", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
