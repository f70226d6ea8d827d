"""A/B of shifted-bf16 f storage (cfg.f_storage='bfloat16') on the card.

Counterpart of the JAX package's `tools/ab_bf16.py`, in one process:
  1. parity probe: K4 on bf16 storage at 1024^2 against the plain
     float32 step of the same populations, quantized (bar 5e-4);
  2. physics: single-disk settling, the bf16 against the f32 settling
     velocity trajectory (budget 1 %, the parity metric of the repo);
  3. coupled bench at 4096^2/10k: f32 against bf16 storage, MLUPS of
     the best of `repeats` timed run(chunk) calls.

    python -m lbmdem_tpu_torch.tools.ab_bf16 [--device cpu]

It runs on the card unless given --device cpu, and raises without a
card; every speed is printed with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from lbmdem_tpu_torch import lattice
from lbmdem_tpu_torch.config import DiskSpec, SimConfig
from lbmdem_tpu_torch.models import column_collapse
from lbmdem_tpu_torch.ops import fused_fluid, lbm
from lbmdem_tpu_torch.simulation import Simulation
from lbmdem_tpu_torch.tools.common import (describe_path, device_label,
                                           gate, require_device, sync)


def parity_probe(device="cuda", n: int = 1024):
    """K4 (fused_step_fluid) on bf16 storage against the plain float32
    step (lbm.step_pure_fluid) of the same stored populations, then
    stored: max |diff| < 5e-4."""
    device = require_device(device)
    cfg = SimConfig(nx=n, ny=n, tau=0.8, gy=-1e-5, uw_north=0.05,
                    dtype="float32", f_storage="bfloat16")
    rng = np.random.default_rng(0)
    base = lattice.W[:, None, None].astype(np.float32)
    f = torch.as_tensor(
        base * (1.0 + 0.05 * rng.standard_normal((9, n, n))).astype(
            np.float32), device=device)
    fs = lbm.to_storage(f, cfg)
    t0 = time.perf_counter()
    ref = lbm.to_storage(lbm.step_pure_fluid(lbm.from_storage(fs, cfg), cfg),
                         cfg)
    got = fused_fluid.fused_step_fluid(fs, cfg, torch.empty_like(fs))
    d = float((got.float() - ref.float()).abs().max())
    sync(device)
    what = "K4" if device.type == "cuda" else "K4's plain version"
    print(f"bf16 parity probe {n}^2: {what} vs the plain f32 step, "
          f"max|diff|={d:.3e} (bar 5e-4; {time.perf_counter() - t0:.1f}s)",
          flush=True)
    gate(d < 5e-4, "BF16 PARITY FAILURE")
    return d


def bench_coupled(storage, chunk=100, repeats=3, coupling_k=1,
                  eps_method=None, device="cuda"):
    """The coupled 4096^2/10k column_collapse scene with f_storage =
    storage, coupling_k and eps_method on the kernels: one warm
    run(chunk), then the best of `repeats` timed run(chunk) calls (each
    ended by a device synchronize). Returns MLUPS."""
    device = require_device(device)
    cfg, disks = column_collapse(nx=4096, ny=4096, n_disks=10000)
    cfg = cfg.replace(out_interval=10**9, f_storage=storage,
                      coupling_k=coupling_k)
    if eps_method:
        cfg = cfg.replace(eps_method=eps_method)
    label = storage + (f"/{eps_method}" if eps_method else "")
    if coupling_k > 1:
        label += f"/k={coupling_k}"
    sim = Simulation(cfg, disks, device=device)
    t0 = time.perf_counter()
    sim.run(chunk)
    print(f"  {label}: first run({chunk}) {time.perf_counter() - t0:.1f}s "
          f"({describe_path(sim)})", flush=True)
    best = 1e9
    for _ in range(repeats):
        t0 = time.perf_counter()
        sim.run(chunk)  # ends with a device synchronize
        best = min(best, time.perf_counter() - t0)
    mlups = cfg.nx * cfg.ny * chunk / best / 1e6
    print(f"  {label}: {best / chunk * 1e3:.3f} ms/step = {mlups:.0f} MLUPS "
          f"(best of {repeats} x run({chunk}), wall clock) on "
          f"{device_label(device)}", flush=True)
    return mlups


def settling_vy(device="cuda", **overrides):
    """vy of one disk settling in a closed 128x256 channel on the kernels
    (the A/Bs' scene, cfg.replace(**overrides)), read after each of 10
    run(100): a (10,) array; prints it with the path."""
    cfg = SimConfig(nx=128, ny=256, tau=0.8, dtype="float32", g_py=-5e-5,
                    buoyancy=True, rho_s=2.0, kn=1.0, gamma_n=1.0, n_sub=20,
                    bc_west="wall", bc_east="wall", out_interval=10**9)
    sim = Simulation(cfg.replace(**overrides), [DiskSpec(64.3, 200.0, 5.0)],
                     device=device)
    traj = []
    for _ in range(10):
        sim.run(100)
        traj.append(float(sim.state.disks.v[0, 1]))
    vy = np.asarray(traj)
    print(f"  {overrides} ({describe_path(sim)}): vy(t) = "
          f"{np.array2string(vy, precision=6)}", flush=True)
    return vy


def settling_parity(device="cuda"):
    """Single-disk settling on the kernels, bf16 against f32 storage:
    max |vy_bf16 - vy_f32| over 10 rows of 100 steps within 1 % of the
    f32 velocity scale. Returns the deviation."""
    v32 = settling_vy(device, f_storage="float32")
    vbf = settling_vy(device, f_storage="bfloat16")
    rel = np.max(np.abs(vbf - v32)) / np.max(np.abs(v32))
    print(f"bf16 settling-velocity deviation vs f32: {rel * 100:.3f}% "
          f"(budget 1%)", flush=True)
    gate(rel < 0.01, f"bf16 settling deviation {rel * 100:.3f}% exceeds 1%")
    return float(rel)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ab_bf16")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    print(f"device: {device_label(device)}", flush=True)
    parity_probe(device)
    print("settling parity (128x256, kernels):", flush=True)
    settling_parity(device)
    print("bench 4096^2/10k coupled:", flush=True)
    m32 = bench_coupled("float32", device=device)
    mbf = bench_coupled("bfloat16", device=device)
    print(f"bf16 speedup: {mbf / m32:.3f}x on {device_label(device)}",
          flush=True)
    return m32, mbf


if __name__ == "__main__":
    main()
