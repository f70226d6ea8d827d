"""The 8192^2 qualification tools of the port (`tools/qualify_8192.py`,
`tools/qualify_k8.py`) on the CPU against the JAX package's tools.

- Without a card both raise RuntimeError before building anything (no
  fallback to the CPU).
- Their argument defaults and the configuration they run equal the JAX
  tools' (n_disks 40 000; k 8, bfloat16, ramp; chunks 50 and 48;
  out_interval past the run), read from the JAX tools' own mains with
  the Simulation they build intercepted.
- The 8192^2 / 40 000-disk deck's DEM axis and slab plane equal
  `pallas_dem.choose_axis` and `pallas_dem.slab_dims` of the JAX package
  (axis x, 504 x 512, 61 bands), and the port takes the slab DEM there
  on the card.
- run_stage on a 256^2 column (f32 sample k = 1, bf16 ramp k = 8) on the
  CPU: the slab DEM, overflow 0, no zero population, mass within its
  bar; check_state raises on a zeroed f32 population (the partial-writes
  guard) and on a non-finite one.
"""

import sys

import pytest
import torch

from lbmdem_tpu_torch.tools import qualify_8192, qualify_k8
from lbmdem_tpu_torch.tools.common import GateFailed

from torch_parity_util import to_torch_cfg


class _Built(Exception):
    """Raised by the stand-in Simulation with the config it was given."""


def _jax_cfg(monkeypatch, tool, argv):
    """The SimConfig the JAX tool's main builds its Simulation with."""
    import lbmdem_tpu.simulation as jsim

    def fake(cfg, disks, **kw):
        raise _Built(cfg, len(disks), kw)

    monkeypatch.setattr(jsim, "Simulation", fake)
    monkeypatch.setattr(sys, "argv", [tool.__file__] + argv)
    with pytest.raises(_Built) as e:
        tool.main()
    return e.value.args


def _port_cfg(monkeypatch, tool, argv):
    """The scene the port's tool builds and the chunk it runs."""
    seen = {}

    def make_sim(**kw):
        seen["scene"] = qualify_8192.scene(**{
            k: v for k, v in kw.items() if k != "device"})
        raise _Built()

    monkeypatch.setattr(tool, "make_sim", make_sim)
    with pytest.raises(_Built):
        tool.main(argv)
    return seen["scene"]


def test_tools_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qualify_8192.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        qualify_k8.main([])


@pytest.mark.parametrize("argv", [[], ["4", "float32", "sample"]],
                         ids=["defaults", "f32-k4"])
def test_k8_defaults_match_jax(monkeypatch, argv):
    from tools import qualify_k8 as jtool

    jcfg, n, kw = _jax_cfg(monkeypatch, jtool, argv)
    cfg, disks = _port_cfg(monkeypatch, qualify_k8, argv)
    assert kw == {"use_pallas": True} and len(disks) == n == 40000
    assert cfg == to_torch_cfg(jcfg)
    assert qualify_k8.CHUNK == 48


def test_8192_defaults_match_jax(monkeypatch):
    from tools import qualify_8192 as jtool

    jcfg, n, _ = _jax_cfg(monkeypatch, jtool, [])
    cfg, disks = _port_cfg(monkeypatch, qualify_8192, [])
    assert len(disks) == n == qualify_8192.N_DISKS == 40000
    assert cfg == to_torch_cfg(jcfg)
    assert (cfg.nx, cfg.ny, cfg.coupling_k, cfg.f_storage) == (
        8192, 8192, 1, "float32")


def test_deck_slab_plane_matches_jax():
    from lbmdem_tpu.models import column_collapse as jcollapse
    from lbmdem_tpu.ops import pallas_dem
    from lbmdem_tpu.ops.dem import DemGrid as JGrid
    from lbmdem_tpu_torch.ops import slab_dem
    from lbmdem_tpu_torch.simulation import derive_config

    cfg, disks = qualify_8192.scene()
    cfg, grid = derive_config(cfg, disks, True)
    axis = slab_dem.choose_axis(disks, cfg)
    jcfg, jdisks = jcollapse(nx=8192, ny=8192, n_disks=40000)
    jgrid = JGrid.build(jcfg, max(d.r for d in jdisks))
    jaxis = pallas_dem.choose_axis(jdisks, jcfg)
    assert axis == jaxis == "x"
    dims = slab_dem.slab_dims(grid, axis)
    assert dims == pallas_dem.slab_dims(jgrid, jaxis)
    assert dims[2:] == (504, 512, 61)
    assert slab_dem.slab_supported(grid, axis, device="cuda")


@pytest.mark.parametrize("k,storage,eps", [(1, "float32", "sample"),
                                           (8, "bfloat16", "ramp")])
def test_run_stage_small_on_cpu(k, storage, eps):
    sim = qualify_8192.make_sim(nx=256, n_disks=60, k=k, storage=storage,
                                eps=eps, device="cpu")
    lines = []
    res = qualify_8192.run_stage(sim, 16, repeats=1, log=lines.append)
    assert "slab DEM" in lines[0] and "cpu" in lines[0]
    assert res["overflow"] == 0 and res["zeros"] == 0 and res["finite"]
    assert res["mass_drift"] < (1e-4 if storage == "bfloat16" else 1e-5)
    assert res["f_min"] > 0.0 and int(sim.state.step) == 32
    st = sim.state
    f = st.f.clone()
    if storage == "float32":  # (bf16 stores the shifted populations)
        f[3, 200, 100] = 0  # a lost write
        sim.state = st._replace(f=f)
        with pytest.raises(GateFailed, match="zero populations"):
            qualify_8192.check_state(sim)
    f[3, 200, 100] = float("nan")
    sim.state = st._replace(f=f)
    with pytest.raises(GateFailed, match="non-finite"):
        qualify_8192.check_state(sim)
