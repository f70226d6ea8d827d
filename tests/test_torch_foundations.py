"""The port's JAX-free foundations (config, decks, units, lattice,
scenarios) against the JAX package, the no-JAX import rule, and the
ctypes bindings of the CUDA kernels against their C declarations."""

import ctypes
import dataclasses
import glob
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import lbmdem_tpu.config as jconfig
import lbmdem_tpu.lattice as jlattice
import lbmdem_tpu.models as jmodels
import lbmdem_tpu.units as junits
import lbmdem_tpu_torch.config as tconfig
import lbmdem_tpu_torch.kernels as tkernels
import lbmdem_tpu_torch.lattice as tlattice
import lbmdem_tpu_torch.models as tmodels
import lbmdem_tpu_torch.units as tunits

import torch_parity_util  # noqa: F401  (caps torch's threads per worker)

ROOT = os.path.join(os.path.dirname(__file__), "..")
DECKS = sorted(glob.glob(os.path.join(ROOT, "examples", "*.par")))
PKG = os.path.join(ROOT, "lbmdem_tpu_torch")


@pytest.mark.parametrize("deck", DECKS, ids=os.path.basename)
def test_deck_parses_field_equal(deck):
    """Every example deck and its particle file parse to equal fields in
    both packages (exact: the parsers are the same code)."""
    jcfg, jpf = jconfig.load_param_file(deck)
    tcfg, tpf = tconfig.load_param_file(deck)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert jpf == tpf
    if jpf:
        jd = jconfig.load_particle_file(jpf, units=jcfg.units)
        td = tconfig.load_particle_file(tpf, units=tcfg.units)
        assert [dataclasses.asdict(d) for d in jd] == \
            [dataclasses.asdict(d) for d in td]


def test_package_imports_without_jax():
    """Importing the port and every one of its modules pulls in no JAX
    (a fresh interpreter, so this test's own imports do not count)."""
    code = (
        "import sys, lbmdem_tpu_torch, lbmdem_tpu_torch.interop, "
        "lbmdem_tpu_torch.kernels, lbmdem_tpu_torch.models, "
        "lbmdem_tpu_torch.units, lbmdem_tpu_torch.ops.slab_dem, "
        "lbmdem_tpu_torch.ops.fused_lbm; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('lbmdem_tpu.') or m == 'lbmdem_tpu']; "
        "assert not bad, bad"
    )
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_no_jax_import_in_package_source():
    for path in glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True):
        with open(path) as fh:
            for line in fh:
                s = line.strip()
                assert not (s.startswith("import jax")
                            or s.startswith("from jax")
                            or s.startswith("import lbmdem_tpu ")
                            or s.startswith("from lbmdem_tpu ")
                            or s.startswith("from lbmdem_tpu.")), (path, s)


def test_lattice_constants_equal():
    for name in ("E", "EX", "EY", "W", "OPP", "IN_E", "IN_W", "IN_N", "IN_S"):
        np.testing.assert_array_equal(getattr(jlattice, name),
                                      getattr(tlattice, name))
    for i in range(9):
        assert jlattice.wall_corr(i, 0.1, -0.03, 1.2) == \
            tlattice.wall_corr(i, 0.1, -0.03, 1.2)
    assert tlattice.tau_from_nu(tlattice.nu_from_tau(0.7)) == pytest.approx(0.7)


def test_units_equal():
    j = junits.UnitSystem(dx=1e-4, dt=1e-6, rho0=1000.0)
    t = tunits.UnitSystem(dx=1e-4, dt=1e-6, rho0=1000.0)
    for name in ("velocity_scale", "accel_scale", "nu_scale", "mass_scale",
                 "force_scale", "torque_scale", "pressure_scale",
                 "stiffness_scale", "damping_scale"):
        assert getattr(j, name) == getattr(t, name)
    assert j.nu_to_lattice(1e-6) == t.nu_to_lattice(1e-6)
    assert j.force_from_lattice(3.0) == t.force_from_lattice(3.0)


def test_config_crosses_over_and_validates_alike():
    """A JAX SimConfig crosses over as SimConfig(**asdict(cfg)); bad
    values raise the same ValueError text in both packages."""
    jcfg = jconfig.SimConfig(nx=64, ny=32, tau=0.7, bc_west="wall",
                             bc_east="wall", uw_north=0.05, kt=0.3)
    tcfg = tconfig.SimConfig(**dataclasses.asdict(jcfg))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.wrap_lx == jcfg.wrap_lx and tcfg.nu == jcfg.nu
    for bad in (dict(tau=0.5), dict(bc_west="periodic", bc_east="wall"),
                dict(coupling_k=3), dict(eps_method="nope")):
        with pytest.raises(ValueError) as ej:
            jconfig.SimConfig(nx=8, ny=8, **bad)
        with pytest.raises(ValueError) as et:
            tconfig.SimConfig(nx=8, ny=8, **bad)
        assert str(ej.value) == str(et.value)
    assert jconfig.window_for_radius(8.0) == tconfig.window_for_radius(8.0)


@pytest.mark.parametrize("name", sorted(jmodels.SCENARIOS))
def test_scenario_equal(name):
    """Each scenario constructor builds the same config and disks."""
    jcfg, jd = jmodels.make_scenario(name)
    tcfg, td = tmodels.make_scenario(name)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    assert [dataclasses.asdict(d) for d in jd] == \
        [dataclasses.asdict(d) for d in td]


def test_particle_file_roundtrip(tmp_path):
    disks = [tconfig.DiskSpec(1.5, 2.5, 3.0, 0.1, -0.2, 0.01, fixed=True),
             tconfig.DiskSpec(4.0, 5.0, 2.0, rho_s=1.7)]
    p = tmp_path / "d.txt"
    tconfig.save_particle_file(str(p), disks)
    assert tconfig.load_particle_file(str(p)) == disks
    assert [dataclasses.asdict(d) for d in jconfig.load_particle_file(str(p))] \
        == [dataclasses.asdict(d) for d in disks]


_C_TYPES = {"float*": ctypes.c_void_p, "int*": ctypes.c_void_p,
            "void*": ctypes.c_void_p,
            "cudaStream_t": ctypes.c_void_p, "int": ctypes.c_int,
            "float": ctypes.c_float,
            "DemParams": tkernels.DemParams,
            "FluidParams": tkernels.FluidParams}


def _c_type(param: str):
    base = param.replace("const ", "").replace("*", " ").split()[0]
    return _C_TYPES[base + ("*" if "*" in param else "")]


def test_kernel_bindings_match_c_declarations():
    """Each C entry point in csrc/ has the ctypes argtypes the wrappers
    declare, parameter by parameter (ctypes passes surplus arguments
    unchecked, so a miscount would corrupt a launch silently), and the
    parameter structs match the C structs' sizes."""
    found = {}
    for path in glob.glob(os.path.join(PKG, "csrc", "*.cu")):
        src = open(path).read()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', src):
            found[name] = [_c_type(p) for p in params.split(",")]
    assert found == tkernels._SIGNATURES
    assert ctypes.sizeof(tkernels.DemParams) == 9 * 4 + 4 * 4 + 4 * 4 + 3 * 4
    assert ctypes.sizeof(tkernels.FluidParams) == 15 * 4 + 12 * 4 + 5 * 4


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA path takes CUDA tensors only (no silent CPU fallback)."""
    with pytest.raises(ValueError, match="CUDA"):
        tkernels.require_cuda_f32("k", torch.zeros(3))
