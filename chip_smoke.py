"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero, and
nothing falls back to the CPU):

1. probe: the card, its power limit, nvcc, CUDA_HOME, triton;
2. build: compile lbmdem_tpu_torch/csrc/*.cu into lbmdem_tpu_torch/_build/;
3. kernels: K1 stamp, K2 fused IMB step + reduce, K3 slab DEM, each
   against its plain PyTorch version on the card, on a small scene and
   at the slice's shapes (column_collapse: 4096^2, 10k disks), with
   CUDA-event times of kernel and plain version at the slice's shapes;
4. slice: Simulation(*column_collapse(), device="cuda"), run(100) to
   warm, run(100) timed: MLUPS, launch counts, overflow, finiteness,
   mass conservation, disk motion;
5. slice vs CPU: 16 steps of a 256^2 column collapse on the card against
   the same run on CPU tensors (the plain versions).

The second-to-last line holds the per-kernel JSON record, the line
before it the card's name and power limit; the last line is the
contract line {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def run_cmd(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {res.stderr.strip()}")
    return res.stdout.strip()


def probe() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    name = torch.cuda.get_device_name(0)
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    log("probe", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log("probe", f"device {name}; count {torch.cuda.device_count()}")
    log("probe", f"nvidia-smi: {smi}")
    from lbmdem_tpu_torch import kernels

    nv = run_cmd([kernels.nvcc(), "--version"]).splitlines()[-1]
    log("probe", f"nvcc {nv}; CUDA_HOME={os.environ.get('CUDA_HOME')}")
    try:
        import triton  # noqa: F401  (reported only)

        tri = f"importable ({triton.__version__})"
    except ImportError as e:
        tri = f"not importable ({e})"
    log("probe", f"triton {tri}")
    return smi


def build() -> None:
    from lbmdem_tpu_torch import kernels

    t0 = time.perf_counter()
    lib = kernels.library()
    log("build", f"{len(kernels.SOURCES)} sources -> {kernels.BUILD} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s)")


def cuda_ms(fn, iters: int) -> float:
    """Mean CUDA-event time of fn() over `iters` calls, after a warm call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def compressed(disks, s: float):
    """The scene's disks with positions scaled by `s` toward the origin
    (s < 1 packs them into contact, so the DEM check sees contacts)."""
    from lbmdem_tpu_torch.config import DiskSpec

    return [DiskSpec(d.x * s, d.y * s, d.r, d.vx, d.vy, d.omega)
            for d in disks]


def kernel_checks(cfg, disks, label: str, timed: bool, seed: int = 0):
    """Each kernel against its plain version on the same card inputs.
    Returns {kernel: (max_abs_err, ms, plain_ms)}."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import dem, fused_lbm, lbm, slab_dem, stamp

    sim = Simulation(cfg, disks, device="cuda")
    cfg, grid, axis = sim.cfg, sim.grid, sim.dem_axis
    rng = np.random.default_rng(seed)
    d = sim.state.disks
    n = d.x.shape[0]
    dev = d.x.device
    d = d._replace(
        v=torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)), dtype=torch.float32,
                          device=dev),
        omega=torch.as_tensor(rng.uniform(-2e-3, 2e-3, n), dtype=torch.float32,
                              device=dev))
    tile_data, counts, entry_slots, ovf = stamp.bin_disks_to_tiles(
        d.x, d.v, d.omega, d.r, d.active, cfg)
    assert int(ovf) == 0, f"binning overflow {int(ovf)}"
    out = {}

    # K1 stamp: atol 1e-6 (the JAX stamp-vs-oracle bar)
    solid = stamp.stamp_fields(tile_data, counts, cfg)
    solid_p = stamp.stamp_fields_plain(tile_data, counts, cfg)
    e1 = float((solid - solid_p).abs().max())
    assert e1 <= 1e-6, f"K1 {label}: max |kernel - plain| {e1} > 1e-6"
    t = (cuda_ms(lambda: stamp.stamp_fields(tile_data, counts, cfg), 20),
         cuda_ms(lambda: stamp.stamp_fields_plain(tile_data, counts, cfg), 2)
         ) if timed else (None, None)
    out["K1"] = (e1,) + t
    log("kernels", f"{label} K1 stamp: max err {e1:.3e} (bar 1e-6); "
        f"eps sum {float(solid[0].sum()):.6e}")

    # K2 fused IMB step: f' atol 5e-6; forces after gather_partials atol
    # 1e-6 relative to the largest |F|
    f = lbm.init_equilibrium(cfg, dev) * (1.0 + 0.02 * torch.as_tensor(
        rng.standard_normal((9, cfg.ny, cfg.nx)), dtype=torch.float32,
        device=dev))
    fa = torch.empty_like(f)
    fb = torch.empty_like(f)
    _, parts = fused_lbm.fused_step_imb_reduce(f, solid, tile_data, counts,
                                               cfg, fa)
    _, parts_p = fused_lbm.fused_step_imb_reduce_plain(
        f, solid, tile_data, counts, cfg, fb)
    e2 = float((fa - fb).abs().max())
    F, T = stamp.gather_partials(parts, entry_slots, torch.float32)
    Fp, Tp = stamp.gather_partials(parts_p, entry_slots, torch.float32)
    fmax = float(Fp.abs().max())
    e2f = float((F - Fp).abs().max())
    assert e2 <= 5e-6, f"K2 {label}: f' max err {e2} > 5e-6"
    assert e2f <= 1e-6 * max(fmax, 1e-30), (
        f"K2 {label}: force err {e2f} > 1e-6 * max|F| ({fmax})")
    t = (cuda_ms(lambda: fused_lbm.fused_step_imb_reduce(
            f, solid, tile_data, counts, cfg, fa), 20),
         cuda_ms(lambda: fused_lbm.fused_step_imb_reduce_plain(
             f, solid, tile_data, counts, cfg, fb), 2)
         ) if timed else (None, None)
    out["K2"] = (e2,) + t
    log("kernels", f"{label} K2 fused step: f' max err {e2:.3e} (bar 5e-6); "
        f"force err {e2f:.3e} vs max|F| {fmax:.3e} (bar 1e-6 relative); "
        f"torque err {float((T - Tp).abs().max()):.3e}")

    # K3 slab DEM: x/v/omega atol 2e-5 (the JAX slab-vs-XLA bar),
    # n_contacts equal
    body = dem.body_forces(d, cfg)
    slabs, slot, sovf, kmax, n_occ, band_offs = slab_dem.build_slabs(
        d, F, T, body, grid, axis)
    assert int(sovf) == 0, f"slab overflow {int(sovf)}"
    s_k, nc_k = slab_dem.subcycle_slabs(slabs.clone(), kmax, n_occ, band_offs,
                                        grid, cfg, axis)
    s_p, nc_p = slab_dem.subcycle_slabs_plain(slabs, kmax, cfg,
                                              slab_dem.slab_dims(grid, axis)[1])
    dk = slab_dem._unslab(s_k, slot, d)
    dp = slab_dem._unslab(s_p, slot, d)
    e3 = max(float((dk.x - dp.x).abs().max()), float((dk.v - dp.v).abs().max()),
             float((dk.omega - dp.omega).abs().max()))
    assert e3 <= 2e-5, f"K3 {label}: x/v/omega max err {e3} > 2e-5"
    assert int(nc_k) == int(nc_p), f"K3 {label}: contacts {int(nc_k)} != " \
        f"{int(nc_p)}"
    scratch = slabs.clone()
    t = (cuda_ms(lambda: slab_dem.subcycle_slabs(
            scratch, kmax, n_occ, band_offs, grid, cfg, axis), 20),
         cuda_ms(lambda: slab_dem.subcycle_slabs_plain(
             slabs, kmax, cfg, slab_dem.slab_dims(grid, axis)[1]), 2)
         ) if timed else (None, None)
    out["K3"] = (e3,) + t
    log("kernels", f"{label} K3 slab DEM: x/v/omega max err {e3:.3e} (bar "
        f"2e-5); contacts {int(nc_k)} == {int(nc_p)}; kmax {int(kmax)}, "
        f"occupied bands {int(n_occ)}")
    if timed:
        for k, (_, ms, pms) in out.items():
            log("kernels", f"{label} {k}: kernel {ms:.4f} ms, plain "
                f"{pms:.4f} ms (CUDA events)")
    return out


def launch_counts():
    from lbmdem_tpu_torch.ops import fused_lbm, slab_dem, stamp

    return {"K1": stamp.stamp_fields.launches,
            "K2": fused_lbm.fused_step_imb_reduce.launches,
            "K3": slab_dem.subcycle_slabs.launches}


def reset_counts() -> None:
    from lbmdem_tpu_torch.ops import fused_lbm, slab_dem, stamp

    stamp.stamp_fields.launches = 0
    fused_lbm.fused_step_imb_reduce.launches = 0
    slab_dem.subcycle_slabs.launches = 0


def slice_run(smi: str):
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import column_collapse

    cfg, disks = column_collapse()
    sim = Simulation(cfg, disks, device="cuda")
    x0 = sim.state.disks.x.clone()
    reset_counts()
    sim.run(100)
    torch.cuda.reset_peak_memory_stats()
    mlups = sim.run(100)
    counts = launch_counts()
    steps = int(sim.state.step)
    st = sim.state
    f = st.f
    finite = bool(torch.isfinite(f).all())
    mass_err = abs(float(f.double().sum()) / (cfg.nx * cfg.ny) - 1.0)
    disp = float((st.disks.x - x0).abs().max())
    log("slice", f"column_collapse {cfg.nx}x{cfg.ny}, {len(disks)} disks, "
        f"{steps} steps: {mlups:.1f} MLUPS (timed run(100), wall clock) on "
        f"{smi}; peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log("slice", f"launches {counts}; overflow {int(st.overflow)}; "
        f"n_contacts {int(st.n_contacts)}; finite {finite}; "
        f"|sum f/(nx ny) - 1| {mass_err:.3e}; max disk displacement {disp:.4e}")
    assert steps == 200, steps
    for k, c in counts.items():
        assert c == steps, f"{k} launched {c} times in {steps} steps"
    assert int(st.overflow) == 0, f"overflow {int(st.overflow)}"
    assert finite, "non-finite f"
    assert mass_err < 1e-5, f"mass drift {mass_err}"
    assert disp > 0.0, "disks did not move"
    return counts, mlups


def slice_vs_cpu() -> None:
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import column_collapse

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    g = Simulation(cfg, disks, device="cuda")
    c = Simulation(cfg, disks, device="cpu")
    g.run(16)
    c.run(16)
    ef = float((g.state.f.cpu() - c.state.f).abs().max())
    ex = float((g.state.disks.x.cpu() - c.state.disks.x).abs().max())
    log("vs-cpu", f"256x256, {len(disks)} disks, 16 steps: f max err {ef:.3e}"
        f" (bar 1e-5), disk x max err {ex:.3e} (bar 1e-4)")
    assert ef <= 1e-5 and ex <= 1e-4


def main() -> int:
    smi = probe()
    build()
    from lbmdem_tpu_torch.models import column_collapse

    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    kernel_checks(cfg, compressed(disks, 0.94),
                  f"{cfg.nx}x{cfg.ny}/{len(disks)} disks", timed=False)
    cfg, disks = column_collapse()
    res = kernel_checks(cfg, compressed(disks, 0.94),
                        f"{cfg.nx}x{cfg.ny}/{len(disks)} disks", timed=True)
    counts, _ = slice_run(smi)
    slice_vs_cpu()
    meta = {
        "K1": ("stamp", "lbmdem_tpu_torch/csrc/stamp.cu",
               "lbmdem_tpu/ops/pallas_stamp.py:270"),
        "K2": ("imb_reduce", "lbmdem_tpu_torch/csrc/imb_reduce.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:1048"),
        "K3": ("slab_dem", "lbmdem_tpu_torch/csrc/slab_dem.cu",
               "lbmdem_tpu/ops/pallas_dem.py:313"),
    }
    record = {"kernels": [
        {"name": meta[k][0], "route": "cuda", "source": meta[k][1],
         "replaces": meta[k][2], "launches": counts[k],
         "max_abs_err": res[k][0], "ms": res[k][1], "plain_ms": res[k][2]}
        for k in ("K1", "K2", "K3")]}
    print(json.dumps(record), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
