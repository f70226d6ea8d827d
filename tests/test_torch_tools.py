"""The port's validation and study tools (lbmdem_tpu_torch/tools/)
against the JAX package's (tools/, examples/generate.py).

Pure functions (the Strouhal estimator, the column builder, the deposit
metrics and the power-law fit, the DKT deck) agree to 1e-12 or exactly;
the gates raise on the same inputs; cut float64 plain-path runs of the
DKT and collapse studies agree with the JAX studies' plain-path runs to
1e-9; three validation legs run whole on the CPU with their own gates;
the deck generator writes the repo's example files byte for byte; and
each tool's entry raises RuntimeError without a card."""

import ast
import dataclasses
import os

import numpy as np
import pytest
import torch

from tools import benchmark_cylinder as jcyl
from tools import collapse_study as jcol
from tools import dkt_study as jdkt

from lbmdem_tpu_torch.tools import (ab_bf16, ab_coupling, ab_eps,
                                    benchmark_cylinder, collapse_study,
                                    dkt_study, generate_examples, validate)
from lbmdem_tpu_torch.tools.common import GateFailed

import torch_parity_util  # noqa: F401  (keeps each worker's thread pool small)

ROOT = os.path.join(os.path.dirname(__file__), "..")
TOL = 1e-9


# --- benchmark_cylinder.measure_strouhal ---------------------------------

def _lift_history(period, phase, n=50_000, every=125):
    steps = np.arange(0, n, every)
    cl = 1.0 + (1.0 + 1e-5 * steps) * np.sin(2 * np.pi * steps / period
                                               + phase)
    cd = 3.0 + 0.1 * np.sin(4 * np.pi * steps / period)
    return np.stack([steps, cd, cl], axis=1)


@pytest.mark.parametrize("period,phase", [(1333.0, 0.0), (1333.0, 1.1),
                                          (2400.0, 0.3)])
def test_measure_strouhal_matches_jax(period, phase):
    hist = _lift_history(period, phase)
    got = benchmark_cylinder.measure_strouhal(hist, 20.0, 0.05)
    want = jcyl.measure_strouhal(hist, 20.0, 0.05)
    assert got is not None and want is not None
    assert got[1] == want[1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    st = 20.0 / (period * 0.05)
    assert abs(got[0] - st) / st < 0.01


def test_measure_strouhal_not_periodic():
    hist = _lift_history(1333.0, 0.0)[:8]
    assert benchmark_cylinder.measure_strouhal(hist, 20.0, 0.05) is None
    assert jcyl.measure_strouhal(hist, 20.0, 0.05) is None


# --- collapse_study: the column, the metrics, the fit ---------------------

@pytest.mark.parametrize("aspect,r,L0", [(0.5, 4.0, 112.0), (4.0, 4.0, 112.0),
                                         (0.75, 3.0, 40.0), (2.5, 3.0, 40.0)])
def test_build_column_matches_jax(aspect, r, L0):
    disks, a, h = collapse_study.build_column(1024, 576, L0, aspect, r)
    jdisks, ja, jh = jcol.build_column(1024, 576, L0, aspect, r)
    assert [dataclasses.astuple(d) for d in disks] == \
        [dataclasses.astuple(d) for d in jdisks]
    assert (a, h) == (ja, jh)


def test_build_column_refuses_an_empty_column():
    with pytest.raises(ValueError):
        collapse_study.build_column(64, 64, 2.0, 0.5, 3.0)
    with pytest.raises(ValueError):
        jcol.build_column(64, 64, 2.0, 0.5, 3.0)


def test_deposit_metrics_and_fit_match_jax():
    rng = np.random.default_rng(3)
    x = rng.uniform(0.0, 300.0, (200, 2))
    r = rng.uniform(2.0, 4.0, 200)
    act = rng.uniform(size=200) > 0.1
    got = collapse_study.deposit_metrics(x, r, act, 40.0)
    want = jcol.deposit_metrics(x, r, act, 40.0)
    assert got.keys() == want.keys()
    for k in got:
        assert abs(got[k] - want[k]) <= 1e-12, k
    a = [0.46, 0.98, 1.96, 3.97]
    run = [0.200, 0.630, 1.531, 3.459]
    np.testing.assert_allclose(collapse_study.fit_power_law(a, run),
                               jcol.fit_power_law(a, run), rtol=0,
                               atol=1e-12)


def _collapse_results(**change):
    """A 4-aspect result table that passes every gate and the recorded
    pin (0.60, 1.32), with `change` applied to its rows (key
    "r<row>__<field>")."""
    rows = []
    for a, run in zip((0.46, 0.98, 1.96, 3.97), (0.200, 0.630, 1.531, 3.459)):
        rows.append(dict(aspect=a, runout=run, settled=True, H0=a * 112.0,
                         height=0.5 * a * 112.0))
    for key, v in change.items():
        i, field = key.split("__")
        rows[int(i[1:])][field] = v
    return rows


_SCALING_CASES = [  # (name, change, kwargs, passes)
    ("pinned", {}, {}, True),
    ("unpinned", {}, dict(pin=None), True),
    ("not monotone", {"r2__runout": 0.62}, {}, False),
    ("unsettled", {"r1__settled": False}, {}, False),
    ("unsettled allowed", {"r1__settled": False},
     dict(require_settled=False), True),
    ("pin lambda", {}, dict(pin=(0.75, 1.32)), False),
    ("pin alpha", {}, dict(pin=(0.60, 1.15)), False),
    ("exponent band", {"r3__runout": 12.0}, dict(pin=None), False),
    ("tall column standing", {"r3__height": 0.9 * 3.97 * 112.0}, {}, False),
    ("two aspects", {}, dict(pin=None, rows=2), True),
]


@pytest.mark.parametrize("name,change,kw,passes", _SCALING_CASES,
                         ids=[c[0] for c in _SCALING_CASES])
def test_check_scaling_agrees_with_jax(name, change, kw, passes):
    kw = {"pin": (0.60, 1.32), **kw}
    res = _collapse_results(**change)[:kw.pop("rows", 4)]
    outcomes = []
    for fn in (collapse_study.check_scaling, jcol.check_scaling):
        try:
            outcomes.append(fn(res, **kw))
        except AssertionError:
            outcomes.append("raised")
    assert (outcomes[0] == "raised") == (outcomes[1] == "raised"), outcomes
    assert (outcomes[0] != "raised") == passes, outcomes
    if passes and outcomes[0][0] is not None:
        np.testing.assert_allclose(outcomes[0], outcomes[1], rtol=0,
                                   atol=1e-12)


# --- dkt_study: the deck, the pin, the gates -----------------------------

@pytest.mark.parametrize("nx,dtype", [(40, "float64"), (80, "float64"),
                                      (120, "float64"), (128, "float32")])
def test_dkt_build_matches_jax(nx, dtype):
    cfg, disks, dt, dx = dkt_study.build(nx=nx, dtype=dtype)
    jcfg, jdisks, jdt, jdx = jdkt.build(nx=nx, dtype=dtype)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert [dataclasses.astuple(d) for d in disks] == \
        [dataclasses.astuple(d) for d in jdisks]
    assert (dt, dx) == (jdt, jdx)


def test_dkt_pin_and_constants_match_jax():
    assert dkt_study.PIN_NX128 == jdkt.PIN_NX128
    for k in ("WIDTH_CM", "HEIGHT_CM", "D_CM", "RHO_RATIO", "NU_CM2S",
              "G_CMS2", "Y0_TRAIL", "Y0_LEAD", "X_OFF"):
        assert getattr(dkt_study, k) == getattr(jdkt, k), k


def _dkt_metrics(**change):
    m = dict(t_kiss_s=1.52, draft_ratio=1.14, gap0_cm=0.2,
             rebound_events=0.0, max_dx_post_kiss_cm=0.31)
    m.update(change)
    return m


_LIT_CASES = [
    ("passes", {}, None),
    ("passes pinned", {}, (1.505, 1.139)),
    ("no kiss", dict(t_kiss_s=None), None),
    ("kiss late", dict(t_kiss_s=3.6), None),
    ("kiss early", dict(t_kiss_s=0.7), None),
    ("no drafting", dict(draft_ratio=1.02), None),
    ("release geometry", dict(gap0_cm=0.25), None),
    ("rebound", dict(rebound_events=1.0), None),
    ("no tumbling", dict(max_dx_post_kiss_cm=0.05), None),
    ("pin t_kiss", dict(t_kiss_s=1.9), (1.505, 1.139)),
    ("pin ratio", dict(draft_ratio=1.30), (1.505, 1.139)),
]


@pytest.mark.parametrize("name,change,pin", _LIT_CASES,
                         ids=[c[0] for c in _LIT_CASES])
def test_check_literature_agrees_with_jax(name, change, pin):
    m = _dkt_metrics(**change)
    raised = []
    for fn in (dkt_study.check_literature, jdkt.check_literature):
        try:
            fn(m, pin=pin)
            raised.append(False)
        except AssertionError:
            raised.append(True)
    assert raised[0] == raised[1]
    assert raised[0] == (not name.startswith("passes"))


def test_gates_raise_gate_failed():
    """A failed gate is a GateFailed (an AssertionError that python -O
    keeps)."""
    with pytest.raises(GateFailed):
        dkt_study.check_literature(_dkt_metrics(t_kiss_s=None))
    with pytest.raises(GateFailed):
        collapse_study.check_scaling(_collapse_results(r2__runout=0.62))


# --- cut float64 runs of the studies against the JAX studies -------------

def test_dkt_study_cut_run_matches_jax():
    """nx = 40, 225 steps (t_max 0.84 s), float64 on both plain paths:
    the sampled rows and every metric within 1e-9."""
    kw = dict(nx=40, dtype="float64", t_max_s=0.84, sample_every=25,
              verbose=False)
    m = dkt_study.run_study(use_kernels=False, device="cpu", **kw)
    jm = jdkt.run_study(use_pallas=False, **kw)
    assert m["rows"].shape == jm["rows"].shape == (9, 6)
    np.testing.assert_allclose(m["rows"], jm["rows"], rtol=0, atol=TOL)
    assert m["t_kiss_s"] is None and jm["t_kiss_s"] is None
    for k in ("vy_trail_cms", "vy_lead_cms", "draft_ratio", "gap0_cm",
              "rebound_events", "max_dx_post_kiss_cm", "t_end_s", "dt_s",
              "dx_cm"):
        assert abs(m[k] - jm[k]) <= TOL, (k, m[k], jm[k])
    assert m["vy_trail_cms"] < 0.0 and m["path"].startswith("plain")


def test_collapse_study_cut_run_matches_jax():
    """256 x 160, one aspect (0.75, r = 3, kt = 25 springs), 2 chunks of
    20 steps, float64 on both plain paths: every metric within 1e-9."""
    kw = dict(nx=256, ny=160, r=3.0, L0=40.0, aspects=(0.75,), g=2e-4,
              chunk=20, max_steps=40, dtype="float64", n_sub=5,
              verbose=False)
    res = collapse_study.run_study(use_kernels=False, device="cpu", **kw)
    jres = jcol.run_study(use_pallas=False, **kw)
    assert len(res) == len(jres) == 1
    got, want = res[0], jres[0]
    assert got.keys() == want.keys()
    assert (got["steps"], got["settled"], got["n_disks"]) == \
        (want["steps"], want["settled"], want["n_disks"]) == (40, False, 28)
    for k in ("front_max", "front_q", "height", "runout", "aspect", "H0",
              "L0", "v_ff"):
        assert abs(got[k] - want[k]) <= TOL, (k, got[k], want[k])


# --- validation legs on the CPU ------------------------------------------

@pytest.mark.parametrize("leg", ["friction", "static", "periodic"])
def test_validation_leg_on_cpu(leg, capsys):
    out = validate.run_legs([leg], device="cpu")
    res, secs = out[leg]
    assert secs > 0.0
    assert "cpu" in res["path"]
    text = capsys.readouterr().out
    assert f"leg {leg}:" in text and "OK" in text


def test_static_leg_holds_k7_plain_version():
    res = validate.static_multi("cpu")
    assert res["err"] < 2e-6


def _jax_stage_names():
    """The keys of the stage table of tools/validate_tpu.py (its
    __main__ block)."""
    with open(os.path.join(ROOT, "tools", "validate_tpu.py")) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "stages"
                        for t in node.targets)):
            return [k.value for k in node.value.keys]
    raise AssertionError("no stage table in validate_tpu.py")


def test_stage_names_match_jax():
    assert list(validate.STAGES) == _jax_stage_names()


def test_validate_refuses_unknown_leg():
    with pytest.raises(SystemExit):
        validate.cli(["nonesuch", "--device", "cpu"])


def test_bench_ks():
    assert ab_coupling.bench_ks({}) == (1, 4)
    assert ab_coupling.bench_ks({"BENCH_KS": "1,4,8"}) == (1, 4, 8)


def test_bf16_parity_probe_on_cpu():
    """The parity probe's arithmetic at 64^2 on the CPU (K4's plain
    version against the plain f32 step, both stored as bf16)."""
    assert ab_bf16.parity_probe("cpu", n=64) < 5e-4


# --- the deck generator --------------------------------------------------

_GENERATED = ["dkt", "settling_column", "column_collapse",
              "column_collapse_friction", "cavity", "cylinder", "porous_bed",
              "suspension_channel", "schafer_turek"]


@pytest.fixture(scope="module")
def generated(tmp_path_factory):
    out = tmp_path_factory.mktemp("examples")
    generate_examples.main(str(out))
    return out


@pytest.mark.parametrize("name", _GENERATED)
def test_generate_examples_byte_equal(generated, name):
    files = [f"{name}.par"]
    if os.path.exists(os.path.join(ROOT, "examples", f"{name}_disks.txt")):
        files.append(f"{name}_disks.txt")
    for fname in files:
        with open(os.path.join(ROOT, "examples", fname), "rb") as a, \
                open(generated / fname, "rb") as b:
            assert a.read() == b.read(), fname


def test_generate_examples_writes_nothing_else(generated):
    want = {f"{n}.par" for n in _GENERATED}
    want |= {f"{n}_disks.txt" for n in _GENERATED if n != "cavity"}
    assert set(os.listdir(generated)) == want


# --- no card: every entry raises -----------------------------------------

_ENTRIES = [
    ("validate", lambda: validate.cli([])),
    ("validate settling", lambda: validate.cli(["settling"])),
    ("benchmark_cylinder", lambda: benchmark_cylinder.main([])),
    ("dkt_study", lambda: dkt_study.main([])),
    ("dkt_study run_study", lambda: dkt_study.run_study(nx=40)),
    ("collapse_study", lambda: collapse_study.main([])),
    ("collapse_study run_study", lambda: collapse_study.run_study(
        nx=256, ny=160, r=3.0, L0=40.0, aspects=(0.75,))),
    ("ab_bf16", lambda: ab_bf16.main([])),
    ("ab_bf16 parity_probe", lambda: ab_bf16.parity_probe()),
    ("ab_eps", lambda: ab_eps.main([])),
    ("ab_coupling", lambda: ab_coupling.main([], env={})),
]


@pytest.mark.parametrize("name,entry", _ENTRIES, ids=[e[0] for e in _ENTRIES])
def test_entry_raises_without_a_card(name, entry):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()


def test_collapse_fit_of_saved_tables(tmp_path, capsys):
    """--json / --fit: per-aspect tables saved apart, merged in aspect
    order and held to the pinned gates (check_scaling with PIN)."""
    import json

    rows = _collapse_results()
    for i, row in enumerate(rows):
        row.update(L0=112.0, n_disks=10 * (i + 1), front_max=1.0, steps=100)
    paths = []
    for i in (3, 1, 0, 2):
        paths.append(str(tmp_path / f"a{i}.json"))
        with open(paths[-1], "w") as fh:
            json.dump([rows[i]], fh)
    results = collapse_study.main(["--fit", *paths])
    assert [r["aspect"] for r in results] == [0.46, 0.98, 1.96, 3.97]
    assert "FINAL dL/L0 = 0.60 * a^1.32" in capsys.readouterr().out
    with open(paths[0], "w") as fh:
        json.dump([dict(rows[3], settled=False)], fh)
    with pytest.raises(GateFailed):
        collapse_study.main(["--fit", *paths])


_TOOL_FILES = sorted(
    f for f in os.listdir(os.path.join(ROOT, "lbmdem_tpu_torch", "tools"))
    if f.endswith(".py"))


@pytest.mark.parametrize("fname", _TOOL_FILES + ["../../chip_smoke.py"])
def test_tool_imports_neither_jax_nor_the_jax_tools(fname):
    """A tool of the port (and chip_smoke.py) imports no jax, nothing of
    the JAX package and nothing of its tools/ directory."""
    path = os.path.join(ROOT, "lbmdem_tpu_torch", "tools", fname)
    with open(path) as fh:
        tree = ast.parse(fh.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module]
        else:
            continue
        for mod in mods:
            assert mod.split(".")[0] not in ("jax", "jaxlib", "lbmdem_tpu",
                                             "tools"), (fname, mod)
