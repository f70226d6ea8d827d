"""The work counts against hand-computed numbers, and the reduction of a
trace to the per-layer metrics on synthetic records."""

from __future__ import annotations

import types

import numpy as np
import pytest

from bench_gpu import roofline, spec, trace

G = {"nx": 64, "ny": 32, "cells": 2048, "f_bytes": 4, "n_disks": 2,
     "window": 13, "eps_samples": 4, "n_sub": 10, "walls": 4,
     "solid_cells": 300, "pairs": 2}
COV = 2 * 13 * 13 * (6 * 16 + 12)  # 36 504
COLLIDE = 350 * 300 + 180 * (2048 - 300)  # 419 640
DEM = 11 * (2 + 2 * 4) * 60 + 10 * 2 * 20  # 7 000


@pytest.mark.parametrize("kernel, k, moved, flops", [
    ("K1", 1, 3 * 2048 * 4 + 2 * 6 * 4, COV),
    ("K2", 1, 2 * 9 * 2048 * 4 + 3 * 2048 * 4 + 2 * 12 + 2 * 12,
     COLLIDE + COV),
    ("K6", 4, 2 * 9 * 2048 * 4 + 3 * 2048 * 4 + 2 * 12 + 4 * 2 * 12,
     4 * (COLLIDE + COV)),
    ("K3", 1, 2 * 18 * 4, DEM),
    ("K3w", 1, 2 * 18 * 4, DEM),
    ("K5", 4, 2 * 9 * 2048 * 4, 4 * 130 * 2048),
])
def test_work_counts(kernel, k, moved, flops):
    assert trace.kernel_files()[kernel].per_call(G, k) == (moved, flops)


def test_bf16_halves_f_bytes():
    g = dict(G, f_bytes=2)
    assert trace.kernel_files()["K5"].per_call(g, 4)[0] == 9 * 2048 * 4


def rec(name, a, b):
    return name, a, b


def records(recs):
    names = [r[0] for r in recs]
    return (names, np.array([r[1] for r in recs], np.int64),
            np.array([r[2] for r in recs], np.int64))


STEP_K1 = [
    "void (anonymous namespace)::stamp_kernel<1>(float const*, int)",
    "void (anonymous namespace)::coupled_step_kernel<float, false, false, "
    "false, (anonymous namespace)::WSink>(float const*)",
    "void (anonymous namespace)::slot_offsets_kernel(int const*)",
    "void (anonymous namespace)::reduce_kernel<1, (anonymous namespace)::"
    "WPlanes, false>(float)",
    "void at::native::vectorized_elementwise_kernel<4>(int)",
    "void (anonymous namespace)::subcycle_kernel<false, false>(float*)",
]
WINDOW_K4 = [
    "void (anonymous namespace)::stamp_kernel<1>(float const*, int)",
    "void (anonymous namespace)::temporal_block_kernel<float, float, false, "
    "1, 2, (anonymous namespace)::NTCell<false, false, false, (anonymous "
    "namespace)::WSteps> >(float const*)",
    "void (anonymous namespace)::slot_offsets_kernel(int const*)",
    "void (anonymous namespace)::reduce_kernel<1, (anonymous namespace)::"
    "WPlanes, false>(float)",
] + ["void (anonymous namespace)::subcycle_kernel<false, false>(float*)"] * 4


def timeline(names, t0=0, dur=100, gap=10):
    out, t = [], t0
    for n in names:
        out.append(rec(n, t, t + dur))
        t += dur + gap
    return out


def test_attribution_coupled_and_window():
    files = trace.kernel_files()
    k1 = timeline(STEP_K1 * 3)
    got, glue = trace.attribute(*records(k1), files)
    assert {k: c for k, (s, c) in got.items()} == {"K1": 3, "K2": 3, "K3": 3}
    assert got["K2"][0] == pytest.approx(3 * 300e-9)
    assert glue == pytest.approx(3 * 100e-9)
    k4 = timeline(WINDOW_K4 * 2)
    got, glue = trace.attribute(*records(k4), files)
    assert {k: c for k, (s, c) in got.items()} == {"K1": 2, "K6": 2,
                                                  "K3w": 8}
    assert got["K6"][0] == pytest.approx(2 * 300e-9) and glue == 0.0


class FakeRecorder:
    def __init__(self, dev, host):
        self.dev, self.host = dev, host

    def raw(self):
        return records(self.dev), records(self.host)


def test_reduce_union_gaps_and_readers():
    dev = timeline(STEP_K1) + timeline(STEP_K1, t0=6 * 110 + 1000)
    host = [rec("aten::item", 0, 5000), rec("cudaLaunchKernel", 300, 330),
            rec("aten::nonzero", 700, 1400)]
    tr = trace.reduce(FakeRecorder(dev, host), window_s=3e-6, steps=2)
    assert tr.records == 12
    assert tr.busy_s == pytest.approx(12 * 100e-9, rel=1e-6)
    assert tr.idle_gaps[0][1] == pytest.approx(1010e-9)
    # the longest gap lies in aten::nonzero's span
    assert tr.idle_gaps[0][0] == "aten::nonzero"
    assert ["coupled_step_kernel<float, false, false, false, WSink>",
            pytest.approx(200e-9)] in [list(x) for x in tr.device_ops]
    assert len(tr.device_ops) <= 10 and len(tr.idle_gaps) <= 10
    ctx = types.SimpleNamespace(trace=tr, work=trace.kernel_files(),
                                geometry=dict(G, cells=8192 * 8192))
    idle = spec.reader("device_idle_pct")(ctx)
    assert idle == pytest.approx(100 * (1 - tr.busy_s / 3e-6))
    assert spec.reader("launches_per_step")(ctx) == 6
    assert spec.reader("glue_ms_per_step")(ctx) == pytest.approx(
        1e3 * 100e-9)
    assert spec.reader("K6_roofline")(ctx) is None
    k2 = spec.reader("K2_roofline")(ctx)
    b, f = trace.kernel_files()["K2"].per_call(ctx.geometry, 1)
    assert k2 == pytest.approx(100 * roofline.bound_s(b, f)
                               / tr.kernels["K2"][0] * 2)


def test_no_device_records_fails():
    with pytest.raises(trace.NoDeviceRecords):
        trace.reduce(FakeRecorder([], [rec("aten::add", 0, 10)]), 1.0, 1)


def test_short_name():
    assert trace.short_name(STEP_K1[1]) == (
        "coupled_step_kernel<float, false, false, false, WSink>")
