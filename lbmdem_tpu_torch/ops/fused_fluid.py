"""The pure-fluid LBM step as one kernel (K4) and k steps per pass (K5).

Counterpart of `fused_step_fluid` and `fused_step_fluid_multi` in the
JAX package's `lbmdem_tpu/ops/pallas_lbm.py`: collide (BGK or TRT,
optional Smagorinsky LES, Guo forcing), pull streaming, half-way
bounce-back with moving walls and the Zou/He inlet/outlet, on f32 or
shifted-bf16 storage (`cfg.f_storage`).

CPU tensors take the plain versions; CUDA tensors take the kernels of
`csrc/fluid.cu` or raise. Both write into the caller's second f buffer
`out`, never into `f`. K5 keeps the k inner steps in float32 and rounds
to the storage type once per call, so its plain version is k f32 steps
between one `from_storage` and one `to_storage`.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lbmdem_tpu_torch import kernels, lattice
from lbmdem_tpu_torch.config import SimConfig, WALL
from lbmdem_tpu_torch.ops import lbm, not_ported

# largest k per pass, the TPU kernel's: f32 8, bf16 16
MAX_K = {"float32": 8, "bfloat16": 16}

# steps per row sweep (csrc/fluid.cu kSweepK): a larger k runs as
# ceil(k / SWEEP_K) sweeps through f32 scratch planes, one pass bit for
# bit
SWEEP_K = 4

# K5's strip, threads per level and output rows per block, from
# chip_smoke.py's sweep at 4096^2
STRIP = (128, 64)


def check_fluid_cfg(cfg: SimConfig, prehalo=False, edges=None) -> None:
    """Raise for options of the JAX fluid kernels that are not ported."""
    if prehalo or edges is not None:
        raise not_ported("the prehalo/edges arguments of the fluid kernels "
                         "(multi-chip halo exchange)", 12)


def storage_dtype(cfg: SimConfig) -> torch.dtype:
    """The dtype of f in storage: bfloat16, or the compute dtype."""
    if cfg.f_storage == "bfloat16":
        return torch.bfloat16
    return lbm.torch_dtype(cfg)


def check_storage(what: str, cfg: SimConfig, f, out) -> torch.dtype:
    """The storage dtype of cfg, after checking that f and out are
    contiguous CUDA tensors of it on one device (float64 is for the
    plain path)."""
    if f.dtype == torch.float64:
        raise NotImplementedError(
            f"{what}: the kernels take float32 or bfloat16 storage; float64 "
            f"runs on the plain path (Simulation(..., use_kernels=False))")
    want = storage_dtype(cfg)
    for t in (f, out):
        if t.device != f.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(f"{what}: f and out must be contiguous {want} "
                             f"tensors on one CUDA device (f_storage="
                             f"{cfg.f_storage!r})")
    return want


def fused_step_fluid_plain(f, cfg: SimConfig, out):
    """Plain version of K4: lbm.step_pure_fluid between from_storage and
    to_storage, into `out`."""
    fnew = lbm.step_pure_fluid(lbm.from_storage(f, cfg), cfg)
    return out.copy_(lbm.to_storage(fnew, cfg))


def fused_step_fluid_multi_plain(f, cfg: SimConfig, k: int, out):
    """Plain version of K5: from_storage, k x lbm.step_pure_fluid,
    to_storage, into `out`."""
    g = lbm.from_storage(f, cfg)
    for _ in range(k):
        g = lbm.step_pure_fluid(g, cfg)
    return out.copy_(lbm.to_storage(g, cfg))


@functools.lru_cache(maxsize=64)
def _params(cfg: SimConfig) -> kernels.FluidParams:
    f32 = np.float32
    tau = cfg.tau
    trt = cfg.trt_lambda
    tau_m = lbm.trt_tau_minus(tau, trt) if trt > 0.0 else tau
    walls = ((cfg.bc_south == WALL) | (cfg.bc_north == WALL) << 1
             | (cfg.bc_west == WALL) << 2 | (cfg.bc_east == WALL) << 3)
    # the half-way wall terms in the order of csrc/d2q9.cuh FluidParams.bb
    sides = ((lattice.IN_N, cfg.uw_south, 0.0),
             (lattice.IN_S, cfg.uw_north, 0.0),
             (lattice.IN_E, 0.0, cfg.uw_west),
             (lattice.IN_W, 0.0, cfg.uw_east))
    bb = [f32(lattice.wall_corr(int(i), uwx, uwy, cfg.rho0))
          for idxs, uwx, uwy in sides for i in idxs]
    return kernels.FluidParams(
        tau=f32(tau), tau_sq=f32(tau * tau), half_gx=f32(0.5 * cfg.gx),
        half_gy=f32(0.5 * cfg.gy), gx=f32(cfg.gx), gy=f32(cfg.gy),
        guo_pref=f32(1.0 - 0.5 / tau), trt_magic=f32(trt),
        trt_hp=f32(0.5 / tau), trt_hm=f32(0.5 / tau_m),
        trt_pe=f32((1.0 - 0.5 / tau) * 0.5),
        trt_po=f32((1.0 - 0.5 / tau_m) * 0.5),
        les_c=f32(18.0 * np.sqrt(2.0) * cfg.smagorinsky * cfg.smagorinsky),
        rho0=f32(cfg.rho0), rho_out=f32(cfg.rho_outlet or cfg.rho0),
        bb=(ctypes.c_float * 12)(*bb),
        forced=int(cfg.gx != 0.0 or cfg.gy != 0.0), trt=int(trt > 0.0),
        les=int(cfg.smagorinsky > 0.0), walls=int(walls),
        open=int(cfg.bc_west == "inlet"),
    )


@functools.lru_cache(maxsize=64)
def _inlet_profile(cfg: SimConfig, device: torch.device):
    """The (ny,) f32 inlet profile on the card (lbm.inlet_profile_array),
    made once per configuration: a host-to-device copy per launch would
    synchronise the stream."""
    return torch.as_tensor(lbm.inlet_profile_array(cfg), dtype=torch.float32,
                           device=device)


def _launch(f, cfg: SimConfig, k: int, out, what: str) -> None:
    want = check_storage(what, cfg, f, out)
    u_in = (_inlet_profile(cfg, f.device).data_ptr()
            if cfg.bc_west == "inlet" else None)
    bf16 = int(want == torch.bfloat16)
    lib = kernels.library()
    kernels.setting("lbm_fluid_strip", *STRIP)
    if k == 1:
        code = lib.lbm_fluid_step(f.data_ptr(), out.data_ptr(), u_in, cfg.ny,
                                  cfg.nx, bf16, _params(cfg), kernels.stream())
    else:
        n_mid = min(-(-k // SWEEP_K) - 1, 2)  # scratch planes in turn
        mid = (torch.empty((n_mid, *f.shape), dtype=torch.float32,
                           device=f.device) if n_mid else None)
        code = lib.lbm_fluid_multi(f.data_ptr(), out.data_ptr(),
                                   None if mid is None else mid.data_ptr(),
                                   u_in, cfg.ny, cfg.nx, k, bf16,
                                   _params(cfg), kernels.stream())
    kernels.check(code, what)


def _check_args(f, cfg: SimConfig, out, what: str) -> None:
    if f.shape != (9, cfg.ny, cfg.nx):
        raise ValueError(f"{what}: f must be (9, {cfg.ny}, {cfg.nx}), got "
                         f"{tuple(f.shape)}")
    if out.shape != f.shape or out.data_ptr() == f.data_ptr():
        raise ValueError(f"{what}: `out` must be a second f-shaped buffer")


def fused_step_fluid(f, cfg: SimConfig, out, prehalo=False):
    """K4: one pure-fluid step of f (9, ny, nx) in storage form, written
    into `out` (the other f buffer, same shape). Returns out.

    CPU tensors take the plain version; CUDA tensors take the kernel
    csrc/fluid.cu (lbm_fluid_step)."""
    check_fluid_cfg(cfg, prehalo)
    _check_args(f, cfg, out, "fused_step_fluid")
    if f.device.type == "cpu":
        return fused_step_fluid_plain(f, cfg, out)
    _launch(f, cfg, 1, out, "pure-fluid step kernel (K4)")
    fused_step_fluid.launches += 1
    return out


def fused_step_fluid_multi(f, cfg: SimConfig, k: int, out, prehalo=False,
                           edges=None):
    """K5: k pure-fluid steps in one pass (1 <= k <= MAX_K[f_storage]),
    written into `out`. Returns out. k == 1 is K4, as in the JAX entry.

    CPU tensors take the plain version; CUDA tensors take the kernel
    csrc/fluid.cu (lbm_fluid_multi)."""
    check_fluid_cfg(cfg, prehalo, edges)
    if not 1 <= k <= MAX_K[cfg.f_storage]:
        raise ValueError(f"temporal block k={k} outside "
                         f"1..{MAX_K[cfg.f_storage]} for f_storage="
                         f"{cfg.f_storage!r}")
    if k == 1:
        return fused_step_fluid(f, cfg, out)
    _check_args(f, cfg, out, "fused_step_fluid_multi")
    if f.device.type == "cpu":
        return fused_step_fluid_multi_plain(f, cfg, k, out)
    _launch(f, cfg, k, out, "temporal-block fluid kernel (K5)")
    fused_step_fluid_multi.launches += 1
    return out


fused_step_fluid.launches = 0
fused_step_fluid_multi.launches = 0
