"""The port's tracing on the CPU: the `lbmdem.*` spans that
`utils/profiling.span` records under torch.profiler (their tree and
counts over small coupled, static-bed and pure-fluid runs), the counts
of waits on the device and of the static hoist's stamps
(`profiling.counters`), and the benchmark's reduction of the
spans against device records (`bench_gpu/host_split.py`) on synthetic
records, beside the benchmark's existing readers on the same records."""

from __future__ import annotations

import collections
import contextlib
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bench_gpu import host_split, spec, trace
from lbmdem_tpu_torch import SimConfig, Simulation
from lbmdem_tpu_torch.models.scenarios import column_collapse
from lbmdem_tpu_torch.utils import profiling


def test_span_without_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    a = profiling.span("lbmdem.a")
    b = profiling.span("lbmdem.b")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a:
        pass


def _sim(case):
    if case == "fluid":
        return Simulation(SimConfig(nx=64, ny=32, tau=0.8, gx=1e-6),
                          device="cpu"), 8, None
    if case == "fluid_callback_health":
        cfg = SimConfig(nx=64, ny=32, tau=0.8, gx=1e-6, out_interval=4,
                        paranoia="chunk")
        return Simulation(cfg, device="cpu"), 8, lambda s: None
    cfg, disks = column_collapse(nx=64, ny=64, n_disks=4, r=3.0)
    k = {"k1": 1, "k4": 4}[case]
    return (Simulation(cfg.replace(coupling_k=k), disks, device="cpu"), 16,
            None)


# expected spans of one run: name -> (count, the span it nests in)
COUPLED = {"lbmdem.run": 1, "lbmdem.block": 2, "lbmdem.block.bin": 2,
           "lbmdem.block.closures": 2, "lbmdem.sync.run_end": 1}
TREES = {
    "k1": dict(COUPLED, **{
        "lbmdem.step": 16, "lbmdem.glue.inputs": 16, "lbmdem.glue.hydro": 16,
        "lbmdem.dem.build_slabs": 16, "lbmdem.dem.unslab": 16}),
    "k4": dict(COUPLED, **{
        "lbmdem.step": 4, "lbmdem.glue.inputs": 4, "lbmdem.glue.hydro": 16,
        "lbmdem.dem.build_slabs": 4, "lbmdem.dem.unslab": 4}),
    "fluid": {"lbmdem.run": 1, "lbmdem.step": 2, "lbmdem.sync.run_end": 1},
    "fluid_callback_health": {
        "lbmdem.run": 1, "lbmdem.step": 2, "lbmdem.sync.health": 2,
        "lbmdem.sync.callback": 2, "lbmdem.callback": 2,
        "lbmdem.sync.run_end": 1},
}
PARENT = {"lbmdem.block": "lbmdem.run", "lbmdem.block.bin": "lbmdem.block",
          "lbmdem.block.closures": "lbmdem.block",
          "lbmdem.glue.inputs": "lbmdem.step",
          "lbmdem.glue.hydro": "lbmdem.step",
          "lbmdem.dem.build_slabs": "lbmdem.step",
          "lbmdem.dem.unslab": "lbmdem.step",
          "lbmdem.sync.run_end": "lbmdem.run",
          "lbmdem.sync.health": "lbmdem.run",
          "lbmdem.sync.callback": "lbmdem.run",
          "lbmdem.callback": "lbmdem.run"}
# the coupled steps wait on nothing: the call's end alone
SYNCS = {"k1": 1, "k4": 1, "fluid": 1,
         "fluid_callback_health": 2 + 2 + 1}


@pytest.mark.parametrize("case", sorted(TREES))
def test_span_tree_and_wait_count(case):
    sim, steps, callback = _sim(case)
    c0 = profiling.counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(steps, callback=callback)
    c1 = profiling.counters()
    assert c1["syncs"] - c0["syncs"] == SYNCS[case]
    assert c1["sync_wait_s"] >= c0["sync_wait_s"]
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("lbmdem.")]
    assert dict(collections.Counter(n for n, _, _ in spans)) == TREES[case]

    def inside(name, parent):
        return [p for p in spans if p[0] == parent
                and p[1] <= name[1] and name[2] <= p[2]]

    coupled = case in ("k1", "k4")
    for s in spans:
        parent = PARENT.get(s[0])
        if s[0] == "lbmdem.step":
            parent = "lbmdem.block" if coupled else "lbmdem.run"
        if parent is not None:
            assert len(inside(s, parent)) == 1, s
    # the call's last wait closes the run, outside every block
    for s in spans:
        if s[0] == "lbmdem.sync.run_end":
            assert not inside(s, "lbmdem.block")
    # and the counter counts without a profiler too
    c2 = profiling.counters()
    sim.run(steps, callback=callback)
    assert profiling.counters()["syncs"] - c2["syncs"] == SYNCS[case]


def test_each_calls_spans_lie_inside_its_run_span():
    """The spans of one run call are grouped by time: every span of the
    call lies inside its own lbmdem.run span and in no other."""
    sim, _, _ = _sim("k1")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(8)
        sim.run(8)
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith("lbmdem.")]
    runs = sorted((a, b) for n, a, b in spans if n == "lbmdem.run")
    assert len(runs) == 2 and runs[0][1] <= runs[1][0]
    per_call = [collections.Counter(
        n for n, a, b in spans if n != "lbmdem.run" and lo <= a and b <= hi)
        for lo, hi in runs]
    # run(8) is one cadence block
    one = {n: 8 for n in TREES["k1"] if TREES["k1"][n] == 16}
    one.update({"lbmdem.block": 1, "lbmdem.block.bin": 1,
                "lbmdem.block.closures": 1, "lbmdem.sync.run_end": 1})
    assert [dict(c) for c in per_call] == [one, one]


# --- the static hoist's spans and its stamp counter -------------------------

def _static_sim(mesh=None):
    """A 256 x 128 channel, periodic in x, through two fixed disks at
    rest: the static hoist (K1 once, then K7 passes of 4)."""
    from lbmdem_tpu_torch import DiskSpec
    from lbmdem_tpu_torch.parallel import make_mesh

    cfg = SimConfig(nx=256, ny=128, tau=0.8, gx=1e-6, bc_west="periodic",
                    bc_east="periodic", max_disks=2)
    disks = [DiskSpec(60.0, 60.0, 8.0, fixed=True),
             DiskSpec(180.0, 70.0, 8.0, fixed=True)]
    sim = Simulation(cfg, disks, device="cpu", mesh=None if mesh is None
                     else make_mesh(["cpu"] * 4, mesh))
    assert sim.static_solid
    return sim


def _spans(prof):
    return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
            for e in prof.profiler.kineto_results.events()
            if e.name().startswith("lbmdem.")]


def _inside(s, spans, parent):
    return [p for p in spans if p[0] == parent and p[1] <= s[1]
            and s[2] <= p[2]]


def test_static_spans():
    """Two run(8) calls: one stamp in the first call, outside its chunk,
    with the binning's wait inside it; one chunk per call, each holding
    its two K7 passes' lbmdem.step spans."""
    sim = _static_sim()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(8)
        sim.run(8)
    spans = _spans(prof)
    assert dict(collections.Counter(n for n, _, _ in spans)) == {
        "lbmdem.run": 2, "lbmdem.static.stamp": 1, "lbmdem.static.chunk": 2,
        "lbmdem.step": 4, "lbmdem.sync.static_binning": 1,
        "lbmdem.sync.run_end": 2}
    runs = sorted(s for s in spans if s[0] == "lbmdem.run")
    for s in spans:
        if s[0] == "lbmdem.step":
            assert len(_inside(s, spans, "lbmdem.static.chunk")) == 1
        if s[0] in ("lbmdem.static.chunk", "lbmdem.static.stamp"):
            assert len(_inside(s, spans, "lbmdem.run")) == 1
        if s[0] == "lbmdem.static.stamp":
            assert _inside(s, [runs[0]], "lbmdem.run")
            assert not _inside(s, spans, "lbmdem.static.chunk")
        if s[0] == "lbmdem.sync.static_binning":
            assert len(_inside(s, spans, "lbmdem.static.stamp")) == 1
    for run_span in runs:
        chunks = [c for c in spans if c[0] == "lbmdem.static.chunk"
                  and run_span[1] <= c[1] and c[2] <= run_span[2]]
        assert len(chunks) == 1
        assert sum(1 for s in spans if s[0] == "lbmdem.step"
                   and _inside(s, chunks, "lbmdem.static.chunk")) == 2


def test_static_stamps_count_each_stamp():
    """The solid stack is stamped once per Simulation, whatever the
    calls, and once more after load_state; without a profiler too."""
    from lbmdem_tpu_torch.interop import state_to_numpy

    sim = _static_sim()
    c0 = profiling.counters()["static_stamps"]
    sim.run(8)
    sim.run(6)
    assert profiling.counters()["static_stamps"] - c0 == 1
    sim.load_state(state_to_numpy(sim.state))
    sim.run(4)
    sim.run(4)
    assert profiling.counters()["static_stamps"] - c0 == 2


def test_static_spans_on_a_mesh():
    """On a 2 x 2 mesh: the shards' solid windows stamped once under
    lbmdem.static.stamp, one lbmdem.static.chunk per call."""
    sim = _static_sim(mesh=(2, 2))
    c0 = profiling.counters()["static_stamps"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(4)
        sim.run(4)
    names = collections.Counter(n for n, _, _ in _spans(prof))
    assert names["lbmdem.static.stamp"] == 1
    assert names["lbmdem.static.chunk"] == 2
    assert names["lbmdem.sync.static_binning"] == 1
    assert profiling.counters()["static_stamps"] - c0 == 1


@pytest.mark.parametrize("case", ["k1", "k4", "fluid"])
def test_other_runs_stamp_nothing(case):
    """A coupled or fluid-only run records no static span and leaves the
    stamp counter where it was."""
    sim, steps, callback = _sim(case)
    c0 = profiling.counters()["static_stamps"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        sim.run(steps, callback=callback)
    assert not [s for s in _spans(prof) if s[0].startswith("lbmdem.static.")]
    assert profiling.counters()["static_stamps"] == c0


# --- bench_gpu/host_split.py on synthetic records ---------------------------

STAMP = "void (anonymous namespace)::stamp_kernel<1>(float const*, int)"
DEM = "void (anonymous namespace)::subcycle_kernel<false, false>(float*)"


def recs(rows):
    return ([r[0] for r in rows], np.array([r[1] for r in rows], np.int64),
            np.array([r[2] for r in rows], np.int64))


DEV = [("void at::native::glue_a(int)", 0, 100), (DEM, 100, 300),
       ("void at::native::gather(long)", 500, 550), (STAMP, 700, 900),
       ("void at::native::glue_b(int)", 1000, 1010)]
SPANS = [("lbmdem.step", 0, 950), ("lbmdem.sync.slab_fallback", 250, 310),
         ("lbmdem.glue.inputs", 320, 690)]
OPS = [("aten::item", 255, 305), ("aten::where", 400, 520),
       ("aten::index", 560, 690), ("aten::zeros", 905, 1000)]


class FakeRecorder:
    def __init__(self, dev, host):
        self.dev, self.host = recs(dev), recs(host)

    def raw(self):
        return self.dev, self.host


def test_sync_idle_and_span_first_gap_names():
    spans, rest = host_split.split_host(recs(SPANS + OPS))
    assert spans[0] == [n for n, _, _ in SPANS]
    assert rest[0] == [n for n, _, _ in OPS]
    # the wait's stretch runs from 250 to K1's start at 700; the device
    # is busy over [250, 300] and [500, 550] of it
    got = host_split.sync_idle_s(spans, recs(DEV), trace.kernel_files())
    assert got == pytest.approx(350e-9)
    by, named, gap_s = host_split.idle_split(recs(DEV), spans, rest)
    # gaps (300, 500) and (550, 700) lie in glue.inputs, (900, 1000) half
    # in lbmdem.step
    assert by == {"lbmdem.glue.inputs": pytest.approx(350e-9),
                  "lbmdem.step": pytest.approx(100e-9)}
    assert gap_s == pytest.approx(450e-9)
    assert named == [["lbmdem.glue.inputs aten::where", pytest.approx(2e-7)],
                     ["lbmdem.glue.inputs aten::index", pytest.approx(1.5e-7)],
                     ["lbmdem.step aten::zeros", pytest.approx(1e-7)]]


def test_gap_outside_every_span():
    spans = recs([("lbmdem.step", 0, 100)])
    assert host_split.gap_spans([(50, 150), (200, 300)], spans) == [
        "lbmdem.step", None]
    assert host_split.gap_name(None, "aten::item") == "aten::item"


def test_existing_readers_unchanged_by_the_spans():
    plain = trace.reduce(FakeRecorder(DEV, OPS), window_s=2e-6, steps=1)
    spanned = trace.reduce(FakeRecorder(DEV, SPANS + OPS), window_s=2e-6,
                           steps=1)
    # here an operation is the shortest cover of every gap, so the gaps'
    # names stay too
    for f in ("busy_s", "records", "kernels", "glue_s", "device_ops",
              "idle_gaps"):
        assert getattr(plain, f) == getattr(spanned, f), f
    for name in ("device_idle_pct", "launches_per_step", "glue_ms_per_step"):
        read = spec.reader(name)
        assert (read(types.SimpleNamespace(trace=plain))
                == read(types.SimpleNamespace(trace=spanned))), name


def test_idle_gap_named_by_a_span_where_it_is_the_shortest_cover():
    """The spans are host records, so trace.host_activity names a gap by a
    bare span where no operation covers half of it but a span does (the
    ledger's gap names change so); host_split names it span first."""
    dev = [("void at::native::glue_a(int)", 0, 100), (DEM, 500, 600)]
    ops = [("aten::item", 100, 150)]
    span = [("lbmdem.dem.build_slabs", 120, 480)]
    plain = trace.reduce(FakeRecorder(dev, ops), window_s=1e-6, steps=1)
    spanned = trace.reduce(FakeRecorder(dev, span + ops), window_s=1e-6,
                           steps=1)
    assert plain.idle_gaps == [("aten::item", pytest.approx(4e-7))]
    assert spanned.idle_gaps == [("lbmdem.dem.build_slabs",
                                  pytest.approx(4e-7))]
    spans, rest = host_split.split_host(recs(span + ops))
    _, named, _ = host_split.idle_split(recs(dev), spans, rest)
    assert named == [["lbmdem.dem.build_slabs aten::item",
                      pytest.approx(4e-7)]]


def test_counter_numbers():
    c0 = {"syncs": 10, "sync_wait_s": 1.0}
    c1 = {"syncs": 91, "sync_wait_s": 1.3}
    got = host_split.counter_numbers(c0, c1, 80, 0.5)
    assert got["host_syncs_per_step"] == 81 / 80
    assert got["host_enqueue_ms_per_step"] == pytest.approx(1e3 * 0.2 / 80)
    assert host_split.counter_numbers(None, c1, 80, 0.5) == {
        "host_syncs_per_step": None, "host_enqueue_ms_per_step": None}
