"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero, and
nothing falls back to the CPU):

1. probe: the card, its power limit, nvcc, CUDA_HOME, triton;
2. build: compile lbmdem_tpu_torch/csrc/*.cu into lbmdem_tpu_torch/_build/
   and print each kernel entry's registers and spills (ptxas);
3. kernels: K1 stamp, K2 fused IMB step + reduce, K3 slab DEM, K6
   coupled temporal block (k = 2, 4, 8) and K3w window slab DEM (4
   chained calls), each against its plain PyTorch version (K6: on CPU
   copies of the inputs) on a small scene and at the slice's shapes
   (column_collapse: 4096^2, 10k disks), with CUDA-event times of kernel
   and plain version (on the card) at the slice's shapes;
4. slice: Simulation(*column_collapse(), device="cuda"), run(100) to
   warm, run(100) timed: MLUPS, launch counts, overflow, finiteness,
   mass conservation, disk motion;
5. slice vs CPU: 16 steps of a 256^2 column collapse on the card against
   the same run on CPU tensors (the plain versions);
5w. window slice: phase 4 with coupling_k=4 (K1 + K6 once per window,
   K3w per inner step), its MLUPS beside phase 4's; the 256^2 window
   run (19 steps) against CPU tensors; the couplingk settling leg of
   tools/validate_tpu.py (128x192, f32, 3000 steps, vy within 1 % of the
   f64 golden over the second half);
6. fluid kernels: K4 (one pure-fluid step) and K5 (k steps per pass)
   against their plain versions on the card, over the lattice-option
   matrix at 256x64 (and two domains smaller than a tile), f32 and
   shifted-bf16 storage, then at 4096^2 with CUDA-event times;
7. fluid slice: Simulation(SimConfig(nx=4096, ny=4096, tau=0.8,
   gx=1e-6), device="cuda") for f32 and bf16 storage, run(400) to warm,
   run(400) timed: MLUPS, launch counts (K5 100, K4 0; then run(19): K5
   4, K4 3), finiteness, mass;
8. Poiseuille on the card (models.poiseuille, 64^2, 20 ny^2 steps)
   against the analytic parabola;
9. fluid vs CPU: a 256x64 Zou/He channel and a 128^2 lid-driven cavity,
   19 steps each, on the card against CPU tensors;
10. static kernel: K7 (k coupled steps over a constant solid stack)
   against its plain version on CPU copies of the inputs over the
   lattice-option matrix at 256x64 (k = 1, 4, 8; f32 and bf16), then at
   4096^2 on the static scene (k = 4) with CUDA-event times of the
   kernel and of the plain version on the card, beside the pass's
   memory floor;
11. static slice: Simulation(*static_bed(), device="cuda") - bench.py's
   static/4096 scene, 4096 fixed disks at rest - for f32 and bf16
   storage: run(400) to warm, run(400) timed: MLUPS, launch counts (K1
   once over the run's life, then K7 100 per run(400) and nothing
   else), mass, finiteness, overflow, and torch.profiler's device time
   per step and idle share;
12. periodic ghosts: a 256^2 porous bed offset by half a pitch (disks on
   the seams and corners, fully periodic): its ghost count, run(40) on
   the card against the CPU run, hydro_forces() against the CPU's;
13. drift: a 256^2 periodic-x channel with a fixed disk at rest and one
   moving at vx = 0.01, run(19) on the card against the CPU run, the
   moving disk at x0 + 19 vx, launches K1 + K2 per step and no K7;
14. split kernels: K8 (fused_step_imb, one coupled step emitting phi)
   against its plain version on CPU copies over the lattice-option
   matrix at 256x64; then on the packed 256^2 and 4096^2 scenes for
   eps_method sample, ramp, exact and sample with eps_r_shift: K1 against
   its plain version (the coverage of every method), K8 + K9
   (reduce_hydro_forces) against K2 on the same input (f' equal, forces
   1e-6), K9 against its plain version, K2's reduce against its plain
   version under ramp and exact; K8 and K9 timed at 4096^2 (phase 3
   holds the sample path's K1/K2/K3 as before);
15. cell-list DEM: dem.dem_subcycle on the card against the CPU on
   phase 3's packed copy (contacts equal, x/v/omega 1e-4);
16. ramp slice: phase 4 with eps_method="ramp", its MLUPS beside phase
   4's sample MLUPS, overflow and mass gates; K8 and K2 timed on the
   run's own state; the 256^2 ramp run against the CPU;
17. ablation: lbmdem_tpu_torch.tools.ablate's f32 variants at
   4096^2/10k disks (chunk 20; K1, K8, K9 and the slab DEM per step,
   "fused" with K2), then the coupling_k = 4 window set, then the bf16
   set (every variant on the K2 step), each row and the marginals;
18. lattice breadth: K2 and K6 (k = 2, 4) over the lattice-option matrix
   (TRT, LES, lambda, moving walls, Zou/He, periodic, all at once) at
   256x64 on f32 and shifted-bf16 storage against their plain versions
   on CPU copies, and on f32 K8 + K9 against K2 bit for bit; then K2 and
   K6 at 4096^2 on bf16 and under TRT + LES, timed beside the f32 BGK
   instantiation and their byte bounds;
19. DEM breadth: K3 and K3w with history springs (kt = 25, live springs
   carried in) and K3 on a periodic axis under both slab orientations
   against their plain versions, every slab channel, at 256^2 and at the
   slice's shapes (4096^2, 10k disks), timed beside kt = 0;
20. bf16 coupled slices: phase 4 and 5w's slice with
   f_storage="bfloat16" (coupling_k 1 and 4), MLUPS beside the f32
   slices', mass drift < 1e-4, overflow 0; the 256^2 bf16 and kt runs
   (per step and per window) against CPU tensors; the 4096^2 / 10k-disk
   slice packed into contact with kt = 25, per step and per window (the
   slab DEM with springs at full width);
21. open channel: a 1024x256 Zou/He channel under TRT + LES with a
   mobile disk that leaves through the outlet and is culled, the card
   against CPU tensors;
22. decks: examples/column_collapse_friction.par (2048^2, 2 500 disks,
   kt = 25) and examples/periodic_channel.par, the card against CPU
   tensors, then the friction deck through coupling_k = 4 windows.

The second-to-last line holds the per-kernel JSON record (the ten
kernels, then the bf16, TRT + LES, kt and periodic instantiations of K2,
K6, K3 and K3w as records of their own; with each kernel's bound: the
larger of its bytes over 3.35 TB/s and its f32 operations over 67
TFLOP/s), the line before it the card's name and
power limit; the last line is the contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


# the H100 SXM's published peaks: HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores (the kernels here use no tensor cores)
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# f32 operations per cell and step, counted from the plain versions'
# arithmetic (moments, 9 or 18 equilibria, relaxation, Guo forcing):
# the pure-fluid collide and the NT-blended collide
FLOPS_FLUID = 200
FLOPS_NT = 350
# coverage operations per window cell (csrc/coverage.cuh): ns^2 sample
# tests of ~6 operations, the ramp's 8, the exact form's ~40
COV_OPS = {"sample": lambda ns: 6 * ns * ns, "ramp": lambda ns: 8,
           "exact": lambda ns: 40}


T0 = time.perf_counter()


def log(phase: str, msg: str) -> None:
    """One line of a phase, with the seconds since the script started."""
    print(f"[{phase} +{time.perf_counter() - T0:.0f}s] {msg}", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def work(err, ms, pms, moved: int, flops: float) -> dict:
    """A kernel's measured numbers and the work its bound is made of."""
    return {"err": err, "ms": ms, "plain_ms": pms, "bytes": moved,
            "flops": flops}


def bound(w: dict):
    """(bound_ms, bound_by): the least time the card could take for the
    work, the larger of bytes over HBM_BPS and operations over
    F32_FLOPS."""
    tb = w["bytes"] / HBM_BPS * 1e3
    tf = w["flops"] / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


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
    for src, entry, regs, st, ld in kernels.resources():
        name = entry.replace("(anonymous namespace)::", "").removeprefix(
            "void ")
        name = name.split(">(")[0] + ">" if ">(" in name else name.split("(")[0]
        log("build", f"{src} {name}: {regs} registers, spills {st} B stored "
            f"/ {ld} B loaded")


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
    Returns {kernel: work(max_abs_err, ms, plain_ms, bytes, flops)}."""
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
    cells = cfg.nx * cfg.ny
    cov_flops = cov_flops_of(cfg, counts)

    # K1 stamp: atol 1e-6 (the JAX stamp-vs-oracle bar)
    solid = stamp.stamp_fields(tile_data, counts, cfg)
    solid_p = stamp.stamp_fields_plain(tile_data, counts, cfg)
    e1 = float((solid - solid_p).abs().max())
    assert e1 <= 1e-6, f"K1 {label}: max |kernel - plain| {e1} > 1e-6"
    t = (cuda_ms(lambda: stamp.stamp_fields(tile_data, counts, cfg), 20),
         cuda_ms(lambda: stamp.stamp_fields_plain(tile_data, counts, cfg), 2)
         ) if timed else (None, None)
    out["K1"] = work(e1, *t, nbytes(tile_data, counts, solid), cov_flops)
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
    out["K2"] = work(e2, *t, nbytes(f, solid, tile_data, counts, fa, parts),
                     FLOPS_NT * cells + cov_flops)
    log("kernels", f"{label} K2 fused step: f' max err {e2:.3e} (bar 5e-6); "
        f"force err {e2f:.3e} vs max|F| {fmax:.3e} (bar 1e-6 relative); "
        f"torque err {float((T - Tp).abs().max()):.3e}")

    # K3 slab DEM: x/v/omega atol 2e-5 (the JAX slab-vs-XLA bar),
    # n_contacts equal
    body = dem.body_forces(d, cfg)
    slabs, slot, sovf, kmax, n_occ, band_offs, _ = slab_dem.build_slabs(
        d, F, T, body, grid, axis)
    assert int(sovf) == 0, f"slab overflow {int(sovf)}"
    s_k, nc_k = slab_dem.subcycle_slabs(slabs.clone(), kmax, n_occ, band_offs,
                                        grid, cfg, axis)
    s_p, nc_p = slab_dem.subcycle_slabs_plain(slabs, kmax, cfg, grid, axis)
    dk, _ = slab_dem._unslab(s_k, slot, d, cfg, None, sovf)
    dp, _ = slab_dem._unslab(s_p, slot, d, cfg, None, sovf)
    e3 = max(float((dk.x - dp.x).abs().max()), float((dk.v - dp.v).abs().max()),
             float((dk.omega - dp.omega).abs().max()))
    assert e3 <= 2e-5, f"K3 {label}: x/v/omega max err {e3} > 2e-5"
    assert int(nc_k) == int(nc_p), f"K3 {label}: contacts {int(nc_k)} != " \
        f"{int(nc_p)}"
    scratch = slabs.clone()
    t = (cuda_ms(lambda: slab_dem.subcycle_slabs(
            scratch, kmax, n_occ, band_offs, grid, cfg, axis), 20),
         cuda_ms(lambda: slab_dem.subcycle_slabs_plain(
             slabs, kmax, cfg, grid, axis), 2)
         ) if timed else (None, None)
    # per substep each active disk tests the 9 neighbour cells' kmax
    # slots with a ~60-operation pair law
    dem_flops = (cfg.n_sub * int(d.active.sum()) * 9 * int(kmax) * 60)
    out["K3"] = work(e3, *t, 2 * nbytes(slabs), dem_flops)
    log("kernels", f"{label} K3 slab DEM: x/v/omega max err {e3:.3e} (bar "
        f"2e-5); contacts {int(nc_k)} == {int(nc_p)}; kmax {int(kmax)}, "
        f"occupied bands {int(n_occ)}")
    cell_list_vs_cpu(d, F, T, grid, cfg, label)

    # K6 coupled temporal block, k = 2, 4, 8: against the plain version
    # on CPU copies of the same inputs. The kernel divides as the CPU
    # does; the plain version on the card multiplies by 1/tau (PyTorch's
    # CUDA scalar division), a 1-ulp change of f that moves the later
    # inner steps' forces by ~1e-6 of the largest |F|. Bars: f' 5e-6,
    # each inner step's forces 1e-6 relative to the largest |F| (K2's).
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cpu_in = [a.cpu() for a in (f, solid, tile_data, counts)]
    es_cpu = entry_slots.cpu()
    for k in (2, 4, 8):
        _, pk = fused_lbm.fused_step_imb_reduce_multi(f, solid, tile_data,
                                                      counts, cfg, k, fa)
        fp_cpu, pp = fused_lbm.fused_step_imb_reduce_multi_plain(
            *cpu_in, cfg, k, torch.empty_like(cpu_in[0]))
        e6 = float((fa.cpu() - fp_cpu).abs().max())
        e6f = 0.0
        for s in range(k):
            Fk, _ = stamp.gather_partials(pk[s].cpu(), es_cpu, torch.float32)
            Fp, _ = stamp.gather_partials(pp[s], es_cpu, torch.float32)
            e6f = max(e6f, float((Fk - Fp).abs().max())
                      / max(float(Fp.abs().max()), 1e-30))
        assert e6 <= 5e-6, f"K6 k={k} {label}: f' max err {e6} > 5e-6"
        assert e6f <= 1e-6, f"K6 k={k} {label}: force err {e6f} > 1e-6 " \
            "relative"
        t = (cuda_ms(lambda: fused_lbm.fused_step_imb_reduce_multi(
                f, solid, tile_data, counts, cfg, k, fa), 10),
             cuda_ms(lambda: fused_lbm.fused_step_imb_reduce_multi_plain(
                 f, solid, tile_data, counts, cfg, k, fb), 1)
             ) if timed else (None, None)
        out[f"K6 k={k}"] = work(
            e6, *t, nbytes(f, solid, tile_data, counts, fa, pk),
            k * (FLOPS_NT * cells + cov_flops))
        log("kernels", f"{label} K6 k={k} coupled block: f' max err {e6:.3e}"
            f" (bar 5e-6); worst inner-step force err {e6f:.3e} of max|F| "
            f"(bar 1e-6 relative; plain version on CPU tensors)")
        if k == 4:
            forces4 = [stamp.gather_partials(pk[s], entry_slots, torch.float32)
                       for s in range(k)]

    # K3w: the window's 4 chained subcycles on one slim slab build, each
    # with its own inner step's forces (K6 k = 4's): x/v/omega atol 2e-5,
    # contacts equal at every inner step
    slabs_w, slot_w, sovf, kmax_w, nocc_w, bands_w, _ = slab_dem.build_slabs(
        d, None, None, body, grid, axis, bake_forces=False)
    assert int(sovf) == 0, f"slab overflow {int(sovf)}"
    f3 = slab_dem._force_planes_window(slot_w, forces4, body, slabs_w.shape)
    s_k, s_p = slabs_w.clone(), slabs_w
    for s in range(4):
        s_k, nc_k = slab_dem.subcycle_slabs_window(
            s_k, f3[s], kmax_w, nocc_w, bands_w, grid, cfg, axis)
        s_p, nc_p = slab_dem.subcycle_slabs_plain(s_p, kmax_w, cfg, grid,
                                                  axis, f3[s])
        assert int(nc_k) == int(nc_p), f"K3w {label} inner step {s}: " \
            f"contacts {int(nc_k)} != {int(nc_p)}"
    dk, _ = slab_dem._unslab(s_k, slot_w, d, cfg, None, sovf, slim=True)
    dp, _ = slab_dem._unslab(s_p, slot_w, d, cfg, None, sovf, slim=True)
    e3w = max(float((dk.x - dp.x).abs().max()),
              float((dk.v - dp.v).abs().max()),
              float((dk.omega - dp.omega).abs().max()))
    assert e3w <= 2e-5, f"K3w {label}: x/v/omega max err {e3w} > 2e-5"
    scratch = slabs_w.clone()
    t = (cuda_ms(lambda: slab_dem.subcycle_slabs_window(
            scratch, f3[0], kmax_w, nocc_w, bands_w, grid, cfg, axis), 20),
         cuda_ms(lambda: slab_dem.subcycle_slabs_plain(
             slabs_w, kmax_w, cfg, grid, axis, f3[0]), 2)
         ) if timed else (None, None)
    out["K3w"] = work(e3w, *t, 2 * nbytes(slabs_w) + nbytes(f3[0]),
                      cfg.n_sub * int(d.active.sum()) * 9 * int(kmax_w) * 60)
    log("kernels", f"{label} K3w window slab DEM, 4 chained calls: x/v/omega"
        f" max err {e3w:.3e} (bar 2e-5); contacts {int(nc_k)} == "
        f"{int(nc_p)} at the last")
    if timed:
        for k, w in out.items():
            bms, by = bound(w)
            log("kernels", f"{label} {k}: kernel {w['ms']:.4f} ms, plain "
                f"{w['plain_ms']:.4f} ms (CUDA events); bound {bms:.4f} ms "
                f"by {by} ({w['bytes'] / 1e9:.4f} GB, "
                f"{w['flops'] / 1e9:.3f} GFLOP)")
    return out


def cell_list_vs_cpu(d, F, T, grid, cfg, label: str) -> None:
    """The cell-list DEM subcycle (plain PyTorch, no kernel) on the card
    against the same call on CPU copies: contacts equal, x/v/omega within
    1e-4."""
    from lbmdem_tpu_torch.ops import dem

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    g, ovf, nc = dem.dem_subcycle(d, F, T, grid, cfg)
    dc = type(d)(*(a.cpu() for a in d))
    c, ovf_c, nc_c = dem.dem_subcycle(dc, F.cpu(), T.cpu(), grid, cfg)
    err = max(float((getattr(g, k).cpu() - getattr(c, k)).abs().max())
              for k in ("x", "v", "omega"))
    ms = cuda_ms(lambda: dem.dem_subcycle(d, F, T, grid, cfg), 3)
    log("cell-list", f"{label} cell-list DEM: card vs CPU x/v/omega max err "
        f"{err:.3e} (bar 1e-4); contacts {int(nc)} == {int(nc_c)}; overflow "
        f"{int(ovf)}; {ms:.3f} ms per subcycle on the card (CUDA events)")
    assert int(ovf) == int(ovf_c) == 0
    assert int(nc) == int(nc_c) > 0, (int(nc), int(nc_c))
    assert err <= 1e-4, f"cell-list DEM {label}: err {err}"


def _wrappers():
    from lbmdem_tpu_torch.ops import (fused_fluid, fused_lbm, fused_static,
                                      slab_dem, stamp)

    return {"K1": stamp.stamp_fields,
            "K2": fused_lbm.fused_step_imb_reduce,
            "K3": slab_dem.subcycle_slabs,
            "K4": fused_fluid.fused_step_fluid,
            "K5": fused_fluid.fused_step_fluid_multi,
            "K6": fused_lbm.fused_step_imb_reduce_multi,
            "K3w": slab_dem.subcycle_slabs_window,
            "K7": fused_static.fused_step_imb_static_multi,
            "K8": fused_lbm.fused_step_imb,
            "K9": stamp.reduce_hydro_forces}


def launch_counts():
    return {k: fn.launches for k, fn in _wrappers().items()}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


# launches of run(100) twice per coupled slice: coupling_k = 1 takes K1,
# K2 and K3 every step; coupling_k = 4 takes each cadence block of 8
# steps (and the last block of 4) as windows: K1 and K6 once per window,
# K3w once per inner step
_NONE = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K3w": 0,
         "K7": 0, "K8": 0, "K9": 0}
SLICE_COUNTS = {
    1: {**_NONE, "K1": 200, "K2": 200, "K3": 200},
    4: {**_NONE, "K1": 50, "K6": 50, "K3w": 200},
}


def slice_run(smi: str, coupling_k: int = 1, eps_method: str = "sample",
              keep: bool = False, storage: str = "float32"):
    """The coupled slice through Simulation(*column_collapse(),
    device="cuda") with cfg.coupling_k, cfg.eps_method and cfg.f_storage:
    run(100) to warm, run(100) timed; the launch counts of both runs,
    overflow, finiteness, mass (bar 1e-5; bf16 storage 1e-4), motion.
    Returns (launch counts, MLUPS), and the Simulation too when `keep`."""
    from lbmdem_tpu_torch.ops import lbm
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import column_collapse

    cfg, disks = column_collapse()
    cfg = cfg.replace(coupling_k=coupling_k, eps_method=eps_method,
                      f_storage=storage)
    tag = ("slice" if coupling_k == 1 else
           f"window-slice k={coupling_k}")
    if eps_method != "sample":
        tag = f"{eps_method}-slice"
    if storage != "float32":
        tag = f"{storage}-{tag}"
    sim = Simulation(cfg, disks, device="cuda")
    x0 = sim.state.disks.x.clone()
    reset_counts()
    sim.run(100)
    torch.cuda.reset_peak_memory_stats()
    mlups = sim.run(100)
    counts = launch_counts()
    steps = int(sim.state.step)
    st = sim.state
    assert st.f.dtype == (torch.bfloat16 if storage == "bfloat16"
                          else torch.float32)
    f = lbm.from_storage(st.f, cfg)
    finite = bool(torch.isfinite(f).all())
    mass_err = abs(float(f.double().sum()) / (cfg.nx * cfg.ny) - 1.0)
    disp = float((st.disks.x - x0).abs().max())
    log(tag, f"column_collapse {cfg.nx}x{cfg.ny}, {len(disks)} disks, "
        f"coupling_k={coupling_k}, eps_method={eps_method}, f_storage="
        f"{storage}, {steps} steps: "
        f"{mlups:.1f} MLUPS (timed "
        f"run(100), wall clock) on {smi}; peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(tag, f"launches {counts}; overflow {int(st.overflow)}; "
        f"n_contacts {int(st.n_contacts)}; finite {finite}; "
        f"|sum f/(nx ny) - 1| {mass_err:.3e}; max disk displacement {disp:.4e}")
    assert steps == 200, steps
    assert counts == SLICE_COUNTS[coupling_k], counts
    assert int(st.overflow) == 0, f"overflow {int(st.overflow)}"
    assert finite, "non-finite f"
    assert mass_err < (1e-5 if storage == "float32" else 1e-4), \
        f"mass drift {mass_err}"
    assert disp > 0.0, "disks did not move"
    return (counts, mlups, sim) if keep else (counts, mlups)


def slice_vs_cpu(coupling_k: int = 1, steps: int = 16,
                 eps_method: str = "sample", storage: str = "float32",
                 kt: float = 0.0) -> None:
    """`steps` steps of a 256^2 column collapse on the card against the
    same run on CPU tensors (the plain versions). Bars: f 1e-5 (bf16
    storage 3e-4, one flipped rounding of the shifted populations), disk
    x 1e-4. kt > 0: the column packed into contact, so springs form."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import column_collapse

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60, kt=kt)
    if kt:
        disks = compressed(disks, 0.94)
    cfg = cfg.replace(coupling_k=coupling_k, eps_method=eps_method,
                      f_storage=storage)
    g = Simulation(cfg, disks, device="cuda")
    c = Simulation(cfg, disks, device="cpu")
    g.run(steps)
    c.run(steps)
    ef = float((g.state.f.float().cpu() - c.state.f.float()).abs().max())
    ex = float((g.state.disks.x.cpu() - c.state.disks.x).abs().max())
    fbar = 1e-5 if storage == "float32" else 3e-4
    springs = int((g.state.disks.ct_j >= 0).sum())
    log("vs-cpu", f"256x256, {len(disks)} disks, coupling_k={coupling_k}, "
        f"eps_method={eps_method}, f_storage={storage}, kt={kt:g}, {steps} "
        f"steps: f max err {ef:.3e} (bar {fbar:g}), disk x max err {ex:.3e} "
        f"(bar 1e-4); contacts {int(g.state.n_contacts)} == "
        f"{int(c.state.n_contacts)}, live springs {springs}")
    assert int(g.state.overflow) == 0
    assert ef <= fbar and ex <= 1e-4
    if kt:
        assert int(g.state.n_contacts) == int(c.state.n_contacts) > 0
        assert springs > 0 and springs == int((c.state.disks.ct_j >= 0).sum())


def coupling_k_settling(ck: int = 4) -> None:
    """tools/validate_tpu.py's couplingk leg on the card: one disk
    settling in a closed 128x192 channel, f32, coupling_k=4, 3000 steps;
    over the second half of the rows (every 100 steps), max |vy -
    vy_gold| / max |vy_gold| < 1 % against the f64 per-step golden."""
    from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation

    gold = np.loadtxt(os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests", "golden", "settling_r5_nx128_f64.csv"),
        delimiter=",", skiprows=1)
    cfg = SimConfig(nx=128, ny=192, tau=0.65, dtype="float32", g_py=-2e-5,
                    rho_s=1.5, kn=0.5, gamma_n=1.0, n_sub=10, buoyancy=True,
                    bc_west="wall", bc_east="wall", coupling_k=ck,
                    out_interval=100)
    sim = Simulation(cfg, [DiskSpec(64.3, 150.0, 5.0)], device="cuda")
    vy = []
    t0 = time.perf_counter()
    sim.run(100 * gold.shape[0], callback=lambda s: vy.append(
        float(s.state.disks.v[0, 1])))
    secs = time.perf_counter() - t0
    half = len(vy) // 2
    vy_t, vy_g = np.asarray(vy[half:]), gold[half:, 4]
    err = np.abs(vy_t - vy_g).max() / np.abs(vy_g).max()
    log("couplingk", f"settling 128x192 f32 coupling_k={ck}, {len(vy) * 100} "
        f"steps in {secs:.2f} s: vy {vy_t[-1]:.6e} vs golden {vy_g[-1]:.6e};"
        f" max |dvy| / max |vy_gold| over the second half {100 * err:.4f} % "
        f"(bar 1 %); overflow {int(sim.state.overflow)}")
    assert int(sim.state.overflow) == 0
    assert err < 0.01, f"coupling_k settling off by {100 * err:.4f} %"


# the lattice-option matrix of the JAX package's fluid-kernel tests
# (tests/test_pallas.py), Zou/He channels (wall and periodic y), bf16
# storage, and two domains smaller than one 16 x 32 tile; at 256x64
# unless overridden
FLUID_MATRIX = [
    ("periodic-x", {}),
    ("walls", dict(bc_west="wall", bc_east="wall")),
    ("periodic", dict(bc_south="periodic", bc_north="periodic")),
    ("forcing", dict(gx=1e-5, gy=-2e-5)),
    ("les", dict(smagorinsky=0.16, gx=2e-5)),
    ("lid", dict(bc_west="wall", bc_east="wall", uw_north=0.08)),
    ("trt", dict(collision="trt")),
    ("trt-les", dict(collision="trt", smagorinsky=0.16, gx=1e-5)),
    ("zou-he", dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                    inlet_profile="poiseuille")),
    ("zou-he-periodic-y", dict(bc_west="inlet", bc_east="outlet",
                               u_inlet=0.06, inlet_profile="poiseuille",
                               bc_south="periodic", bc_north="periodic")),
    ("bf16-forcing", dict(f_storage="bfloat16", gx=1e-5, gy=-1e-5)),
    ("bf16-zou-he", dict(f_storage="bfloat16", bc_west="inlet",
                         bc_east="outlet", u_inlet=0.06)),
    ("bf16-trt-les-lid", dict(f_storage="bfloat16", collision="trt",
                              smagorinsky=0.16, bc_west="wall",
                              bc_east="wall", uw_north=0.08)),
    ("small-channel", dict(nx=4, ny=32, gx=1e-5)),
    ("small-cavity", dict(nx=24, ny=6, bc_west="wall", bc_east="wall",
                          uw_north=0.05)),
]


def fluid_bar(cfg, k: int):
    """(atol, rtol) of K4/K5 against the plain version, the JAX package's
    bars: K4 1e-7/1e-6, K5 5e-7/1e-5 (2e-6 with Zou/He), bf16 3e-4."""
    if cfg.f_storage == "bfloat16":
        return 3e-4, 0.0
    if k == 1:
        return 1e-7, 1e-6
    return (2e-6 if cfg.bc_west == "inlet" else 5e-7), 1e-5


def fluid_check(cfg, k: int, seed: int, label: str, timed: bool = False,
                amp: float = 0.05):
    """K4 (k == 1) or K5 (k steps) against its plain version on the same
    card input, f = w_i (1 + amp N(0, 1)). Returns work(max_abs_err, ms,
    plain_ms, bytes, flops)."""
    from lbmdem_tpu_torch import lattice
    from lbmdem_tpu_torch.ops import fused_fluid, lbm

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.as_tensor(lattice.W, dtype=torch.float32, device="cuda")
    f = lbm.to_storage(w[:, None, None] * (1.0 + amp * torch.randn(
        (9, cfg.ny, cfg.nx), generator=g, device="cuda")), cfg)
    a, b = torch.empty_like(f), torch.empty_like(f)
    if k == 1:
        wrapper = fused_fluid.fused_step_fluid
        run = lambda: wrapper(f, cfg, a)  # noqa: E731
        plain = lambda: fused_fluid.fused_step_fluid_plain(f, cfg, b)  # noqa
    else:
        wrapper = fused_fluid.fused_step_fluid_multi
        run = lambda: wrapper(f, cfg, k, a)  # noqa: E731
        plain = lambda: fused_fluid.fused_step_fluid_multi_plain(  # noqa
            f, cfg, k, b)
    n0 = wrapper.launches
    run()
    assert wrapper.launches == n0 + 1, "the kernel did not launch"
    plain()
    torch.cuda.synchronize()
    ka, pb = a.float(), b.float()
    err = float((ka - pb).abs().max())
    atol, rtol = fluid_bar(cfg, k)
    excess = float(((ka - pb).abs() - rtol * pb.abs()).max())
    moved = float((pb - f.float()).abs().max())
    name = "K4" if k == 1 else f"K5 k={k}"
    log("fluid", f"{label} {name}: max err {err:.3e} (bar atol {atol:g} + "
        f"rtol {rtol:g}); max |step| {moved:.3e}")
    assert bool(torch.isfinite(ka).all()), f"{label} {name}: non-finite"
    assert excess <= atol, f"{label} {name}: err {err} over the bar"
    assert moved > 0.0, f"{label} {name}: the step changed nothing"
    t = (cuda_ms(run, 20), cuda_ms(plain, 2)) if timed else (None, None)
    return work(err, *t, 2 * nbytes(f),
                k * FLOPS_FLUID * cfg.nx * cfg.ny)


def fluid_kernels(n: int = 4096):
    """K4/K5 against the plain versions over FLUID_MATRIX, then at n^2
    with CUDA-event times. Returns {kernel: work(...)} of the
    f32 n^2 checks. At n^2 the input amplitude is 0.02: with 0.05 some
    of the 151 M shifted bf16 values exceed |g| = 1/16, where one bf16
    ulp (4.9e-4) is over the 3e-4 bar, and a value on a rounding
    boundary flips between the shifted kernel and the unshifted plain
    version."""
    from lbmdem_tpu_torch import SimConfig

    for i, (label, kw) in enumerate(FLUID_MATRIX):
        cfg = SimConfig(**{"nx": 256, "ny": 64, "tau": 0.8,
                           "dtype": "float32", **kw})
        ks = (1, 4, 8, 16) if cfg.f_storage == "bfloat16" else (1, 4, 8)
        for k in ks:
            fluid_check(cfg, k, 100 + i, f"{label} {cfg.nx}x{cfg.ny}")
    out = {}
    for storage in ("float32", "bfloat16"):
        cfg = SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, dtype="float32",
                        f_storage=storage)
        for k, key in ((1, "K4"), (4, "K5")):
            w = fluid_check(cfg, k, 7, f"{n}x{n} {storage}", timed=True,
                            amp=0.02)
            ms = w["ms"]
            bms, by = bound(w)
            log("fluid", f"{n}x{n} {storage} {key} (k={k}): kernel "
                f"{ms:.4f} ms per call ({ms / k:.4f} ms per step), plain "
                f"{w['plain_ms']:.4f} ms (CUDA events); bound {bms:.4f} ms "
                f"by {by}")
            if storage == "float32":
                out[key] = w
    return out


def fluid_slice(smi: str, storage: str, n: int = 4096):
    """The pure-fluid path through Simulation at n^2 (bench.py's
    fluid/4096 stages): run(400) to warm, run(400) timed, run(19), the
    checks on that 819-step state, then two more timed run(400) for the
    spread, then K5's CUDA-event time on the run's own state for the
    kernel share of the runs (the f32 kernel is slower on the smooth
    state of the run than on a random one). Returns (launch counts of
    the first timed run(400) + run(19), median MLUPS)."""
    from lbmdem_tpu_torch.ops import fused_fluid
    from lbmdem_tpu_torch import SimConfig, Simulation
    from lbmdem_tpu_torch.ops import lbm

    cfg = SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, dtype="float32",
                    out_interval=10**9, f_storage=storage)
    sim = Simulation(cfg, device="cuda")
    sim.run(400)
    reset_counts()
    rates = [sim.run(400)]
    c400 = launch_counts()
    sim.run(19)
    counts = launch_counts()
    steps = int(sim.state.step)
    f = lbm.from_storage(sim.state.f, cfg)
    finite = bool(torch.isfinite(f).all())
    mass_err = abs(float(f.double().sum()) / (cfg.nx * cfg.ny) - 1.0)
    ux = float(lbm.moments(f, cfg.gx, cfg.gy)[1].double().mean())
    bar = 1e-5 if storage == "float32" else 1e-4
    for _ in range(2):
        reset_counts()
        rates.append(sim.run(400))
        assert launch_counts() == {**c400, "K5": 100}, launch_counts()
    mlups = float(np.median(rates))
    k5_ms = cuda_ms(lambda: fused_fluid.fused_step_fluid_multi(
        sim.state.f, cfg, 4, sim._f_spare), 10)
    # 100 K5 launches per run(400): their device time over the wall time
    share = [100 * 100 * k5_ms * 1e-3 / (cfg.nx * cfg.ny * 400 / (r * 1e6))
             for r in rates]
    log("fluid-slice", f"{cfg.nx}x{cfg.ny} {storage}, tau 0.8, gx 1e-6: "
        f"{mlups:.1f} MLUPS median of 3 timed run(400) "
        f"({', '.join(f'{r:.1f}' for r in rates)}; wall clock; "
        f"{1e3 * cfg.nx * cfg.ny / (mlups * 1e6):.4f} ms per step) on {smi}; "
        f"K5 on this state {k5_ms:.4f} ms per call; 100 x K5 / run time "
        f"{', '.join(f'{x:.1f}' for x in share)} %")
    log("fluid-slice", f"launches run(400) {c400}; after run(19) {counts}; "
        f"steps {steps}; finite {finite}; |sum f/(nx ny) - 1| "
        f"{mass_err:.3e} (bar {bar:g}); mean ux {ux:.4e}")
    assert (counts["K5"] - 100, counts["K4"]) == (4, 3), counts
    assert all(counts[k] == 0 for k in ("K1", "K2", "K3", "K6", "K3w",
                                        "K7")), counts
    assert steps == 819
    assert finite, "non-finite f"
    assert mass_err < bar, f"mass drift {mass_err}"
    assert ux > 0.0, "the body force drove no flow"
    return counts, mlups


def poiseuille_check() -> None:
    """models.poiseuille (64^2, tau 0.9, g 1e-6, 20 ny^2 steps, f32) on
    the card against the analytic parabola. Bar: max |u - analytic| <=
    1 % of u_max. The f64 bars of test_lbm.py (rtol 2e-3, atol 3e-7)
    hold in f64 (the same run on CPU tensors: 1.4e-7); in f32 the
    rounding of the collide leaves a steady offset of 0.48 % of u_max,
    on the card and on CPU tensors alike."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import poiseuille

    cfg, _ = poiseuille()
    sim = Simulation(cfg, device="cuda")
    t0 = time.perf_counter()
    sim.run(cfg.steps)
    secs = time.perf_counter() - t0
    _, ux, _ = sim.macroscopic()
    prof = ux.mean(axis=1).astype(np.float64)
    y = np.arange(cfg.ny) + 0.5
    analytic = cfg.gx / (2.0 * cfg.nu) * y * (cfg.ny - y)
    err = np.abs(prof - analytic)
    umax = analytic.max()
    log("poiseuille", f"{cfg.nx}x{cfg.ny}, {cfg.steps} steps in {secs:.2f} s:"
        f" max |u - analytic| {err.max():.3e} of u_max {umax:.4e} "
        f"({100 * err.max() / umax:.3f} %; bar 1 %)")
    assert err.max() <= 1e-2 * umax, "Poiseuille profile off"


def fluid_vs_cpu() -> None:
    """19 steps (4 K5 passes + 3 K4 steps) on the card against the same
    run on CPU tensors (the plain versions)."""
    from lbmdem_tpu_torch import SimConfig, Simulation
    from lbmdem_tpu_torch.models import cavity

    chan = SimConfig(nx=256, ny=64, tau=0.7, dtype="float32",
                     bc_west="inlet", bc_east="outlet", u_inlet=0.05,
                     inlet_profile="poiseuille")
    for label, cfg in (("Zou/He channel", chan), ("cavity", cavity()[0])):
        g = Simulation(cfg, device="cuda")
        c = Simulation(cfg, device="cpu")
        g.run(19)
        c.run(19)
        err = float((g.state.f.cpu() - c.state.f).abs().max())
        log("fluid-vs-cpu", f"{label} {cfg.nx}x{cfg.ny}, 19 steps: f max err "
            f"{err:.3e} (bar 1e-5)")
        assert err <= 1e-5


# the lattice-option matrix of K7 at 256x64: walls with forcing, the
# Zou/He channel with the Poiseuille inlet, TRT, LES, the lambda blend
# (with LES: the per-cell form), a moving north wall, periodic on both
# axes
STATIC_MATRIX = [
    ("walls-gx", dict(bc_west="wall", bc_east="wall", gx=1e-5)),
    ("zou-he", dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                    inlet_profile="poiseuille")),
    ("trt", dict(collision="trt", gx=1e-5)),
    ("les", dict(smagorinsky=0.16, gx=2e-5)),
    ("lambda", dict(nt_mode="lambda", gx=1e-5)),
    ("trt-les-lambda", dict(collision="trt", smagorinsky=0.16,
                            nt_mode="lambda", gx=1e-5)),
    ("lid", dict(bc_west="wall", bc_east="wall", uw_north=0.08)),
    ("periodic", dict(bc_south="periodic", bc_north="periodic", gy=-1e-5)),
]


def static_bed(n: int = 4096, n_disks: int = 4096, storage="float32"):
    """bench.py's static scene (`_run_static`): n_disks fixed disks of
    r = 4 at rest on a jittered square grid from default_rng(0), tau 0.8,
    gx 1e-6, periodic x, walls in y. The same code, without importing
    bench.py."""
    from lbmdem_tpu_torch.config import DiskSpec, SimConfig

    rng = np.random.default_rng(0)
    r = 4.0
    side = int(np.ceil(np.sqrt(n_disks)))
    pitch = (n - 40.0) / side
    disks = []
    for i in range(n_disks):
        gy, gx = divmod(i, side)
        disks.append(DiskSpec(
            20.0 + (gx + 0.5) * pitch + rng.uniform(-2, 2),
            20.0 + (gy + 0.5) * pitch + rng.uniform(-2, 2),
            r, fixed=True,
        ))
    cfg = SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, dtype="float32",
                    max_disks=n_disks, out_interval=10**9, f_storage=storage)
    return cfg, disks


def static_check(cfg, solid, k: int, seed: int, label: str,
                 timed: bool = False, amp: float = 0.05):
    """K7 against its plain version on CPU copies of the same card
    inputs (the plain version on the card multiplies by 1/tau where the
    kernel divides), f = w_i (1 + amp N(0, 1)) in storage form. Bars:
    f32 rtol 1e-5 + atol 2e-6 (tests/test_pallas.py's static-kernel
    bar), bf16 3e-4. Returns work(max_abs_err, ms, plain_ms, bytes,
    flops); timed: the plain version's time on the card."""
    from lbmdem_tpu_torch import lattice
    from lbmdem_tpu_torch.ops import fused_static, lbm

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.as_tensor(lattice.W, dtype=torch.float32, device="cuda")
    f = lbm.to_storage(w[:, None, None] * (1.0 + amp * torch.randn(
        (9, cfg.ny, cfg.nx), generator=g, device="cuda")), cfg)
    a = torch.empty_like(f)
    wrapper = fused_static.fused_step_imb_static_multi
    n0 = wrapper.launches
    wrapper(f, solid, cfg, k, a)
    assert wrapper.launches == n0 + 1, "the kernel did not launch"
    fc = f.cpu()
    b = fused_static.fused_step_imb_static_multi_plain(
        fc, solid.cpu(), cfg, k, torch.empty_like(fc))
    ka, pb = a.float().cpu(), b.float()
    err = float((ka - pb).abs().max())
    atol, rtol = (3e-4, 0.0) if cfg.f_storage == "bfloat16" else (2e-6, 1e-5)
    excess = float(((ka - pb).abs() - rtol * pb.abs()).max())
    moved = float((pb - fc.float()).abs().max())
    log("static", f"{label} K7 k={k}: max err {err:.3e} (bar atol {atol:g} "
        f"+ rtol {rtol:g}; plain version on CPU tensors); max |step| "
        f"{moved:.3e}")
    assert bool(torch.isfinite(ka).all()), f"{label} K7 k={k}: non-finite"
    assert excess <= atol, f"{label} K7 k={k}: err {err} over the bar"
    assert moved > 0.0, f"{label} K7 k={k}: the pass changed nothing"
    t = (None, None)
    if timed:
        pc = torch.empty_like(f)
        t = (cuda_ms(lambda: wrapper(f, solid, cfg, k, a), 20),
             cuda_ms(lambda: fused_static.fused_step_imb_static_multi_plain(
                 f, solid, cfg, k, pc), 2))
    return work(err, *t, 2 * nbytes(f) + nbytes(solid),
                k * FLOPS_NT * cfg.nx * cfg.ny)


def static_kernels():
    """K7 over STATIC_MATRIX at 256x64 (k = 1, 4, 8; f32 and bf16) on a
    stamped row of obstacles, some across the periodic seams; then k = 4
    at 4096^2 on the static scene's solid stack, timed. Returns the
    4096^2 f32 work record."""
    from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    obstacles = [DiskSpec(x, y, r, fixed=True) for x, y, r in (
        (1.2, 20.3, 4.0), (64.3, 32.1, 4.0), (128.0, 40.0, 3.0),
        (200.5, 60.2, 5.0), (240.0, 12.7, 3.5))]
    for i, (label, kw) in enumerate(STATIC_MATRIX):
        for storage in ("float32", "bfloat16"):
            cfg = SimConfig(**{"nx": 256, "ny": 64, "tau": 0.8,
                               "dtype": "float32", "f_storage": storage,
                               **kw})
            sim = Simulation(cfg, obstacles, device="cuda")
            solid = sim._static_solid_operands()
            for k in (1, 4, 8):
                static_check(sim.cfg, solid, k, 200 + i,
                             f"{label} {storage} 256x64")
    out = {}
    for storage in ("float32", "bfloat16"):
        sim = Simulation(*static_bed(storage=storage), device="cuda")
        solid = sim._static_solid_operands()
        cfg = sim.cfg
        w = static_check(cfg, solid, 4, 9, f"4096x4096 {storage}",
                         timed=True, amp=0.02)
        bms, by = bound(w)
        log("static", f"4096x4096 {storage} K7 (k=4): kernel {w['ms']:.4f} "
            f"ms per pass ({w['ms'] / 4:.4f} ms per step), plain version on "
            f"the card {w['plain_ms']:.4f} ms (CUDA events); memory floor "
            f"{w['bytes'] / 1e9:.4f} GB = {w['bytes'] / HBM_BPS * 1e3:.4f} "
            f"ms, bound {bms:.4f} ms by {by}: kernel at "
            f"{100 * bms / w['ms']:.1f} % of it")
        if storage == "float32":
            out["K7"] = w
        del sim, solid
    return out


def device_profile(sim, steps: int = 40):
    """torch.profiler over run(steps): (device ms per step, wall ms per
    step of the profiled run, top kernels by device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(steps)
        wall = time.perf_counter() - t0
    kern = [(a.key, a.self_device_time_total) for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA]
    dev_us = sum(t for _, t in kern)
    top = sorted(kern, key=lambda x: -x[1])[:3]
    return dev_us / 1e3 / steps, wall * 1e3 / steps, top


def static_slice(smi: str, storage: str):
    """The static hoist through Simulation(*static_bed(), device="cuda"):
    run(400) to warm (K1 once, then K7), run(400) timed, the checks,
    then the profiler over run(40). Returns (launch counts of the warm
    run, MLUPS)."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import lbm

    cfg, disks = static_bed(storage=storage)
    sim = Simulation(cfg, disks, device="cuda")
    assert sim.static_solid and sim.dem_mode == "drift"
    reset_counts()
    sim.run(400)
    first = launch_counts()
    reset_counts()
    mlups = sim.run(400)
    timed = launch_counts()
    cfg = sim.cfg
    f = lbm.from_storage(sim.state.f, cfg)
    finite = bool(torch.isfinite(f).all())
    mass_err = abs(float(f.double().sum()) / (cfg.nx * cfg.ny) - 1.0)
    ux = float(lbm.moments(f, cfg.gx, cfg.gy)[1].double().mean())
    bar = 1e-5 if storage == "float32" else 1e-4
    eps = float(sim._static_solid_operands()[0].double().sum())
    dev_ms, prof_ms, top = device_profile(sim)
    wall_ms = 1e3 * cfg.nx * cfg.ny / (mlups * 1e6)
    log("static-slice", f"{cfg.nx}x{cfg.ny} {storage}, {len(disks)} fixed "
        f"disks r=4 at rest, tau 0.8, gx 1e-6: {mlups:.1f} MLUPS (timed "
        f"run(400), wall clock; {wall_ms:.4f} ms per step) on {smi}; solid "
        f"fraction {eps / (cfg.nx * cfg.ny):.5f}")
    log("static-slice", f"launches warm run(400) {first}; timed run(400) "
        f"{timed}; steps {int(sim.state.step)}; overflow "
        f"{int(sim.state.overflow)}; finite {finite}; |sum f/(nx ny) - 1| "
        f"{mass_err:.3e} (bar {bar:g}); mean ux {ux:.4e}")
    log("static-slice", f"profiler run(40): device {dev_ms:.4f} ms per step"
        f" against {prof_ms:.4f} ms wall per step (profiled) and "
        f"{wall_ms:.4f} ms (timed run): idle share "
        f"{100 * max(0.0, 1 - dev_ms / wall_ms):.1f} % of the timed run; "
        f"top kernels {[(k[:40], round(t / 1e3, 3)) for k, t in top]} ms")
    zero = {k: 0 for k in first}
    assert first == {**zero, "K1": 1, "K7": 100}, first
    assert timed == {**zero, "K7": 100}, timed
    assert int(sim.state.step) == 840
    assert int(sim.state.overflow) == 0
    assert finite, "non-finite f"
    assert mass_err < bar, f"mass drift {mass_err}"
    assert ux > 0.0, "the body force drove no flow"
    return first, mlups


def offset_porous_bed(n: int = 256, pitch: int = 32):
    """models.porous_bed (fully periodic, r 6) shifted by half a pitch so
    that every disk sits on a seam or a corner; gx 1e-5 for a visible
    drag."""
    from lbmdem_tpu_torch.config import DiskSpec
    from lbmdem_tpu_torch.models import porous_bed

    cfg, disks = porous_bed(nx=n, ny=n, pitch=pitch)
    return cfg.replace(gx=1e-5), [
        DiskSpec(d.x - pitch / 2, d.y - pitch / 2, d.r, fixed=True)
        for d in disks]


def ghosts_vs_cpu() -> None:
    """The offset porous bed: its periodic ghost count, run(40) (10 K7
    passes after K1) on the card against the CPU run (f within 1e-5) and
    hydro_forces() on the card against the CPU's (1e-4 of max |F|)."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import imb

    cfg, disks = offset_porous_bed()
    g = Simulation(cfg, disks, device="cuda")
    c = Simulation(cfg, disks, device="cpu")
    d = g.state.disks
    _, _, parent, _, govf = imb.periodic_ghosts(d.x, d.v, d.omega, d.r,
                                                d.active, g.cfg)
    n_ghosts = int((parent >= 0).sum())
    reset_counts()
    g.run(40)
    counts = launch_counts()
    c.run(40)
    ef = float((g.state.f.cpu() - c.state.f).abs().max())
    Fg, Tg = g.hydro_forces()
    Fc, Tc = c.hydro_forces()
    scale = float(np.abs(Fc).max())
    eF = float(np.abs(Fg - Fc).max())
    log("ghosts", f"offset porous bed {cfg.nx}x{cfg.ny}, {len(disks)} fixed "
        f"disks on the seams, fully periodic: {n_ghosts} ghosts (cap "
        f"{g.cfg.ghost_cap} per block, overflow {int(govf)}); run(40) "
        f"launches {counts}; f max err {ef:.3e} (bar 1e-5); hydro_forces "
        f"max err {eF:.3e} of max |F| {scale:.3e} (bar 1e-4 relative); "
        f"torque err {float(np.abs(Tg - Tc).max()):.3e}")
    assert n_ghosts > 0 and int(govf) == 0
    assert counts["K7"] == 10 and counts["K1"] == 1, counts
    assert int(g.state.overflow) == 0
    assert ef <= 1e-5
    assert scale > 0 and eF <= 1e-4 * scale


def drift_vs_cpu() -> None:
    """Prescribed motion: a 256^2 periodic-x channel (gx 1e-5) with a
    fixed disk at rest and one moving at vx = 0.01; run(19) on the card
    (K1 + K2 per step, no K7, no DEM) against the CPU run."""
    from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation

    cfg = SimConfig(nx=256, ny=256, tau=0.8, gx=1e-5, dtype="float32",
                    out_interval=10**9)
    disks = [DiskSpec(64.0, 128.0, 6.0, fixed=True),
             DiskSpec(160.3, 120.0, 6.0, vx=0.01, fixed=True)]
    g = Simulation(cfg, disks, device="cuda")
    c = Simulation(cfg, disks, device="cpu")
    assert g.dem_mode == "drift" and not g.static_solid
    x0 = float(g.state.disks.x[1, 0])
    want = np.float32(x0)  # x0 + 19 vx, one f32 addition per step
    for _ in range(19):
        want = np.float32(want + np.float32(0.01))
    reset_counts()
    g.run(19)
    counts = launch_counts()
    c.run(19)
    ef = float((g.state.f.cpu() - c.state.f).abs().max())
    xg, xc = g.state.disks.x.cpu(), c.state.disks.x
    log("drift", f"{cfg.nx}x{cfg.ny} periodic x, one fixed disk at rest and "
        f"one at vx 0.01, 19 steps: launches {counts}; f max err {ef:.3e} "
        f"(bar 1e-5); moving disk x {float(xg[1, 0]):.6f} (x0 + 19 vx in "
        f"f32 steps {float(want):.6f}; CPU {float(xc[1, 0]):.6f})")
    zero = {k: 0 for k in counts}
    assert counts == {**zero, "K1": 19, "K2": 19}, counts
    assert int(g.state.overflow) == 0
    assert ef <= 1e-5
    assert torch.equal(xg, xc), "card and CPU positions differ"
    assert float(xg[1, 0]) == float(want), (float(xg[1, 0]), float(want))
    assert float(xg[0, 0]) == 64.0


# the lattice-option matrix of K8 at 256x64 (tests/test_pallas.py's
# coupled-kernel cases and more): BGK, TRT, LES, TRT + LES, the lambda
# blend, moving walls, the Zou/He channel with the Poiseuille inlet,
# periodic x (the default) and y
SPLIT_MATRIX = [
    ("bgk", dict(bc_west="wall", bc_east="wall", gy=-1e-5)),
    ("trt", dict(collision="trt", gy=-1e-5)),
    ("les", dict(smagorinsky=0.16, gx=2e-5, bc_west="wall", bc_east="wall")),
    ("trt-les", dict(collision="trt", smagorinsky=0.16, gx=1e-5)),
    ("lambda", dict(nt_mode="lambda", gy=-1e-5, bc_west="wall",
                    bc_east="wall")),
    ("moving-wall", dict(bc_west="wall", bc_east="wall", uw_north=0.05,
                         uw_south=-0.02)),
    ("zou-he", dict(bc_west="inlet", bc_east="outlet", u_inlet=0.05,
                    inlet_profile="poiseuille")),
    ("periodic", dict(bc_south="periodic", bc_north="periodic", gx=1e-5)),
]


def split_matrix() -> None:
    """K8 against its plain version on CPU copies of the same inputs over
    SPLIT_MATRIX at 256x64: five moving disks stamped by the oracle (Zou/He
    columns masked, as Simulation masks them), f = w_i (1 + 0.05 N(0,
    1)). Bars (tests/test_pallas.py): f' rtol 1e-6 + atol 1e-7, phi rtol
    1e-5 + atol 5e-8."""
    from lbmdem_tpu_torch import SimConfig, lattice
    from lbmdem_tpu_torch.config import window_for_radius
    from lbmdem_tpu_torch.ops import fused_lbm, imb

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    x = torch.tensor([[1.2, 20.3], [64.3, 32.1], [128.0, 40.0], [200.5, 60.2],
                      [240.0, 12.7]])
    v = torch.tensor([[0.01, -0.02], [0.0, 0.01], [-0.02, 0.0], [0.01, 0.01],
                      [0.0, -0.01]])
    om = torch.tensor([0.005, -0.003, 0.0, 0.002, 0.001])
    r = torch.tensor([4.0, 4.0, 3.0, 5.0, 3.5])
    act = torch.ones(5, dtype=torch.bool)
    rng = np.random.default_rng(31)
    f = torch.as_tensor(lattice.W[:, None, None] * (
        1.0 + 0.05 * rng.standard_normal((9, 64, 256))), dtype=torch.float32)
    wrapper = fused_lbm.fused_step_imb
    for label, kw in SPLIT_MATRIX:
        cfg = SimConfig(**{"nx": 256, "ny": 64, "tau": 0.8, "dtype": "float32",
                           "max_disks": 5, "window": window_for_radius(5.0),
                           **kw})
        fields = imb.stamp_solid_fraction(x, v, om, r, act, cfg)
        if cfg.bc_west == "inlet":
            fields = imb.mask_open_columns(*fields)
        dev_in = [t.cuda() for t in (f, *fields)]
        a = torch.empty_like(dev_in[0])
        n0 = wrapper.launches
        _, kx, ky = wrapper(*dev_in, cfg, a)
        assert wrapper.launches == n0 + 1, "the kernel did not launch"
        b, px, py = fused_lbm.fused_step_imb_plain(f, *fields, cfg,
                                                   torch.empty_like(f))
        ka = a.cpu()
        err = float((ka - b).abs().max())
        excess = float(((ka - b).abs() - 1e-6 * b.abs()).max())
        perr = max(float((k.cpu() - p).abs().max()) for k, p in ((kx, px),
                                                              (ky, py)))
        pex = max(float(((k.cpu() - p).abs() - 1e-5 * p.abs()).max())
                  for k, p in ((kx, px), (ky, py)))
        log("split", f"{label} 256x64 K8: f' max err {err:.3e} (bar atol "
            f"1e-7 + rtol 1e-6), phi max err {perr:.3e} (bar atol 5e-8 + "
            f"rtol 1e-5; plain version on CPU tensors); max |phi| "
            f"{float(px.abs().max()):.3e}")
        assert bool(torch.isfinite(ka).all()), f"K8 {label}: non-finite"
        assert excess <= 1e-7, f"K8 {label}: f' err {err} over the bar"
        assert pex <= 5e-8, f"K8 {label}: phi err {perr} over the bar"
        assert float(px.abs().max()) > 0.0


def split_checks(cfg, disks, label: str, timed: bool, seed: int = 1):
    """For eps_method sample, ramp, exact and sample with eps_r_shift on
    the packed scene: K1 against its plain version (bar 1e-6); K8 + K9
    against K2 on the same input (f' equal, forces atol 1e-6); K9 against
    its plain version on the same card inputs (F, T atol 1e-6); K2's
    reduce under ramp and exact against its plain version (forces 1e-6
    of max |F|). Timed: K8 and K9 (sample) with their plain versions on
    the card. Returns {"K8": work, "K9": work} when timed."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import fused_lbm, lbm, stamp

    sim = Simulation(cfg, disks, device="cuda")
    cfg = sim.cfg
    rng = np.random.default_rng(seed)
    d = sim.state.disks
    n = d.x.shape[0]
    dev = d.x.device
    d = d._replace(
        v=torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)), dtype=torch.float32,
                          device=dev),
        omega=torch.as_tensor(rng.uniform(-2e-3, 2e-3, n), dtype=torch.float32,
                              device=dev))
    tile_data, counts, es, ovf = stamp.bin_disks_to_tiles(
        d.x, d.v, d.omega, d.r, d.active, cfg)
    assert int(ovf) == 0, f"binning overflow {int(ovf)}"
    f = lbm.init_equilibrium(cfg, dev) * (1.0 + 0.02 * torch.as_tensor(
        rng.standard_normal((9, cfg.ny, cfg.nx)), dtype=torch.float32,
        device=dev))
    fa, fb = torch.empty_like(f), torch.empty_like(f)
    cells = cfg.nx * cfg.ny
    out = {}
    for method, shift in (("sample", 0.0), ("ramp", 0.0), ("exact", 0.0),
                          ("sample", -0.4)):
        mcfg = cfg.replace(eps_method=method, eps_r_shift=shift)
        tag = f"{label} {method}" + (f" r_shift {shift:g}" if shift else "")
        solid = stamp.stamp_fields(tile_data, counts, mcfg)
        e1 = float((solid - stamp.stamp_fields_plain(tile_data, counts,
                                                     mcfg)).abs().max())
        assert e1 <= 1e-6, f"K1 {tag}: max |kernel - plain| {e1} > 1e-6"
        eps, usx, usy = solid[0], solid[1], solid[2]
        _, phix, phiy = fused_lbm.fused_step_imb(f, eps, usx, usy, mcfg, fa)
        F9, T9 = stamp.reduce_hydro_forces(d.x, d.r, d.active, eps, phix,
                                           phiy, mcfg, tile_data, counts, es)
        _, parts = fused_lbm.fused_step_imb_reduce(f, solid, tile_data, counts,
                                                   mcfg, fb)
        F2, T2 = stamp.gather_partials(parts, es, torch.float32)
        same = torch.equal(fa, fb)
        e82 = max(float((F9 - F2).abs().max()), float((T9 - T2).abs().max()))
        Fp, Tp = stamp.gather_partials(stamp.hydro_partials_plain(
            eps, phix, phiy, tile_data, counts, mcfg), es, torch.float32)
        fmax = float(Fp.abs().max())
        tmax = float(Tp.abs().max())
        # K9 against its plain version: the JAX package's atol 1e-6 holds
        # for its |F| < 1; the f32 sums of larger forces and torques
        # differ in order by a few ulp of the largest, so the bar scales
        # with them above 1
        e9 = float((F9 - Fp).abs().max())
        e9t = float((T9 - Tp).abs().max())
        msg = (f"{tag}: K1 max err {e1:.3e} (bar 1e-6); K8 f' == K2 f' "
               f"{same}; K8 + K9 vs K2 forces/torques max err {e82:.3e} (bar "
               f"1e-6); K9 vs plain F {e9:.3e} of max |F| {fmax:.3e}, T "
               f"{e9t:.3e} of max |T| {tmax:.3e} (bars 1e-6 * max(1, max))")
        if method != "sample":
            _, pp = fused_lbm.fused_step_imb_reduce_plain(
                f, solid, tile_data, counts, mcfg, torch.empty_like(f))
            F2p, _ = stamp.gather_partials(pp, es, torch.float32)
            e2r = float((F2 - F2p).abs().max())
            msg += (f"; K2 {method} reduce vs plain {e2r:.3e} (bar 1e-6 * "
                    f"max|F|)")
            assert e2r <= 1e-6 * fmax, f"K2 {tag}: force err {e2r}"
        log("split", msg)
        assert same, f"K8 {tag}: f' differs from K2's"
        assert e82 <= 1e-6, f"K8 + K9 {tag}: forces differ from K2's by {e82}"
        assert e9 <= 1e-6 * max(1.0, fmax), f"K9 {tag}: F err {e9}"
        assert e9t <= 1e-6 * max(1.0, tmax), f"K9 {tag}: T err {e9t}"
        assert fmax > 0.0
        if timed and method != "sample":
            log("split", f"{tag} K1 kernel "
                f"{cuda_ms(lambda: stamp.stamp_fields(tile_data, counts, mcfg), 20):.4f}"
                f" ms (CUDA events)")
        if timed and method == "sample" and not shift:
            eps8 = (eps, usx, usy)
            phi8 = (phix, phiy)
            cov_cells = int(counts.sum()) * cfg.window ** 2
            w8 = work(float((fa - fused_lbm.fused_step_imb_plain(
                          f, *eps8, cfg, fb)[0]).abs().max()),
                      cuda_ms(lambda: fused_lbm.fused_step_imb(
                          f, *eps8, cfg, fa), 20),
                      cuda_ms(lambda: fused_lbm.fused_step_imb_plain(
                          f, *eps8, cfg, fb), 2),
                      nbytes(f, eps, usx, usy, fa, phix, phiy),
                      FLOPS_NT * cells)
            w9 = work(e9,
                      cuda_ms(lambda: stamp.reduce_hydro_forces(
                          d.x, d.r, d.active, eps, *phi8, cfg, tile_data,
                          counts, es), 20),
                      cuda_ms(lambda: stamp.gather_partials(
                          stamp.hydro_partials_plain(eps, *phi8, tile_data,
                                                     counts, cfg),
                          es, torch.float32), 2),
                      nbytes(tile_data, counts, parts, F9, T9)
                      + 12 * min(cells, cov_cells),
                      cov_flops_of(cfg, counts))
            out = {"K8": w8, "K9": w9}
            for k, w in out.items():
                bms, by = bound(w)
                log("split", f"{label} {k}: kernel {w['ms']:.4f} ms, plain "
                    f"{w['plain_ms']:.4f} ms (CUDA events); bound {bms:.4f} "
                    f"ms by {by} ({w['bytes'] / 1e9:.4f} GB, "
                    f"{w['flops'] / 1e9:.3f} GFLOP)")
    return out


def cov_flops_of(cfg, counts) -> float:
    """Operations of the reduce over every binned window: the coverage
    and ~12 to weight and sum a force, per window cell."""
    return (int(counts.sum()) * cfg.window ** 2
            * (COV_OPS[cfg.eps_method](cfg.eps_samples) + 12))


def split_on_run_state(sim) -> None:
    """K8 (f32 storage only) and K2 on a run's own (smooth) state, CUDA
    events: the f32 divide's slow path makes the collides slower there
    than on random input."""
    from lbmdem_tpu_torch.ops import fused_lbm, stamp

    cfg = sim.cfg
    d = sim.state.disks
    tile_data, counts, _, _ = stamp.bin_disks_to_tiles(d.x, d.v, d.omega, d.r,
                                                       d.active, cfg)
    solid = stamp.stamp_fields(tile_data, counts, cfg)
    f, out = sim.state.f, torch.empty_like(sim.state.f)
    k8 = "" if cfg.f_storage != "float32" else "K8 %.4f ms, " % cuda_ms(
        lambda: fused_lbm.fused_step_imb(f, solid[0], solid[1], solid[2], cfg,
                                         out), 20)
    k2 = cuda_ms(lambda: fused_lbm.fused_step_imb_reduce(
        f, solid, tile_data, counts, cfg, out), 20)
    log("split", f"on the {cfg.eps_method} {cfg.f_storage} slice's state "
        f"after {int(sim.state.step)} steps: {k8}K2 {k2:.4f} ms per call "
        f"(CUDA events)")


# the lattice-option matrix of K2 and K6 at 256x64: SPLIT_MATRIX and
# every option at once on an open channel
BREADTH_MATRIX = SPLIT_MATRIX + [
    ("all", dict(collision="trt", smagorinsky=0.16, nt_mode="lambda",
                 gx=1e-5, gy=-1e-5, uw_north=0.03, bc_west="inlet",
                 bc_east="outlet", u_inlet=0.05,
                 inlet_profile="poiseuille")),
]


def breadth_matrix() -> None:
    """K2 and K6 (k = 2, 4) over BREADTH_MATRIX at 256x64 on f32 and
    shifted-bf16 storage against their plain versions on CPU copies of
    the same inputs (the plain version on the card multiplies by 1/tau):
    five moving disks binned across the tiles, Zou/He columns zeroed as
    Simulation zeroes them. Bars: f' 5e-6 (bf16 3e-4), every (inner)
    step's forces 1e-6 of the largest |F| (bf16: 5e-6, the kernel's
    shifted arithmetic rounds differently from the plain version's
    physical form). On f32, K8 + K9 against K2: f' and forces bit for
    bit."""
    from lbmdem_tpu_torch import SimConfig, lattice
    from lbmdem_tpu_torch.config import window_for_radius
    from lbmdem_tpu_torch.ops import fused_lbm, lbm, stamp

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    x = torch.tensor([[1.2, 20.3], [64.3, 32.1], [128.0, 40.0], [200.5, 60.2],
                      [240.0, 12.7]])
    v = torch.tensor([[0.01, -0.02], [0.0, 0.01], [-0.02, 0.0], [0.01, 0.01],
                      [0.0, -0.01]])
    om = torch.tensor([0.005, -0.003, 0.0, 0.002, 0.001])
    r = torch.tensor([4.0, 4.0, 3.0, 5.0, 3.5])
    act = torch.ones(5, dtype=torch.bool)
    rng = np.random.default_rng(37)
    f32 = torch.as_tensor(lattice.W[:, None, None] * (
        1.0 + 0.05 * rng.standard_normal((9, 64, 256))), dtype=torch.float32)
    k2, k6 = (fused_lbm.fused_step_imb_reduce,
              fused_lbm.fused_step_imb_reduce_multi)

    def forces_err(pk, pp, es):
        Fk, _ = stamp.gather_partials(pk.cpu(), es, torch.float32)
        Fp, _ = stamp.gather_partials(pp, es, torch.float32)
        fmax = float(Fp.abs().max())
        assert fmax > 0.0
        return float((Fk - Fp).abs().max()) / fmax

    for label, kw in BREADTH_MATRIX:
        for storage in ("float32", "bfloat16"):
            cfg = SimConfig(**{"nx": 256, "ny": 64, "tau": 0.8,
                               "dtype": "float32", "max_disks": 5,
                               "window": window_for_radius(5.0),
                               "tile_cap": 8, "f_storage": storage, **kw})
            td, cnt, es, ovf = stamp.bin_disks_to_tiles(x, v, om, r, act, cfg)
            assert int(ovf) == 0
            solid = stamp.stamp_fields(td, cnt, cfg)
            if cfg.bc_west == "inlet":
                solid[:, :, 0].zero_()
                solid[:, :, -1].zero_()
            f = lbm.to_storage(f32, cfg)
            cpu_in = (f, solid, td, cnt)
            dev_in = [t.cuda() for t in cpu_in]
            a = torch.empty_like(dev_in[0])
            fbar, rbar = (5e-6, 1e-6) if storage == "float32" else (3e-4, 5e-6)
            n0 = k2.launches
            _, pk = k2(*dev_in, cfg, a)
            assert k2.launches == n0 + 1, "K2 did not launch"
            b, pp = fused_lbm.fused_step_imb_reduce_plain(
                *cpu_in, cfg, torch.empty_like(f))
            errs = [float((a.float().cpu() - b.float()).abs().max())]
            rels = [forces_err(pk, pp, es)]
            for k in (2, 4):
                n0 = k6.launches
                _, pk = k6(*dev_in, cfg, k, a)
                assert k6.launches == n0 + 1, "K6 did not launch"
                b, pp = fused_lbm.fused_step_imb_reduce_multi_plain(
                    *cpu_in, cfg, k, torch.empty_like(f))
                errs.append(float((a.float().cpu() - b.float()).abs().max()))
                rels.append(max(forces_err(pk[t], pp[t], es)
                                for t in range(k)))
            msg = (f"{label} {storage} 256x64: f' max err K2 {errs[0]:.3e}, "
                   f"K6 k=2 {errs[1]:.3e}, k=4 {errs[2]:.3e} (bar {fbar:g}); "
                   f"forces of max |F| K2 {rels[0]:.3e}, K6 {rels[1]:.3e}, "
                   f"{rels[2]:.3e} (bar {rbar:g}; plain versions on CPU "
                   f"tensors)")
            assert bool(torch.isfinite(a.float()).all())
            assert max(errs) <= fbar, f"{label} {storage}: f' {errs}"
            assert max(rels) <= rbar, f"{label} {storage}: forces {rels}"
            if storage == "float32":
                # K8 + K9 against K2, bit for bit
                fa, fb = torch.empty_like(a), torch.empty_like(a)
                fd, sd, tdd, cd = dev_in
                _, p2 = k2(fd, sd, tdd, cd, cfg, fa)
                _, phx, phy = fused_lbm.fused_step_imb(fd, sd[0], sd[1],
                                                       sd[2], cfg, fb)
                esd = es.cuda()
                F9, T9 = stamp.reduce_hydro_forces(
                    x.cuda(), r.cuda(), act.cuda(), sd[0], phx, phy, cfg, tdd,
                    cd, esd)
                F2, T2 = stamp.gather_partials(p2, esd, torch.float32)
                same = (torch.equal(fa, fb), torch.equal(F2, F9),
                        torch.equal(T2, T9))
                msg += f"; K8 + K9 == K2 bitwise (f', F, T) {same}"
                assert all(same), f"{label}: K8 + K9 differ from K2 {same}"
            log("breadth", msg)


def breadth_timed(cfg, disks, label: str, seed: int = 5):
    """K2 and K6 (k = 4) at the slice's shapes on the packed scene for
    the new instantiations - shifted-bf16 storage, and TRT + LES on f32
    - against their plain versions on the same card inputs (f' 3e-4 for
    bf16; TRT + LES 5e-6, K6 2e-5: the plain version on the card
    multiplies by 1/tau), with CUDA-event times beside the f32 BGK
    instantiation's in this call and each one's bound. Returns {name:
    work}."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import fused_lbm, lbm, stamp

    sim = Simulation(cfg, disks, device="cuda")
    base = sim.cfg
    rng = np.random.default_rng(seed)
    d = sim.state.disks
    n = d.x.shape[0]
    dev = d.x.device
    vel = torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)), dtype=torch.float32,
                          device=dev)
    td, cnt, es, ovf = stamp.bin_disks_to_tiles(d.x, vel, d.omega, d.r,
                                                d.active, base)
    assert int(ovf) == 0
    solid = stamp.stamp_fields(td, cnt, base)
    f32 = lbm.init_equilibrium(base, dev) * (1.0 + 0.02 * torch.as_tensor(
        rng.standard_normal((9, base.ny, base.nx)), dtype=torch.float32,
        device=dev))
    cells = base.nx * base.ny
    cov = cov_flops_of(base, cnt)
    out = {}
    variants = (("f32 bgk", {}, 5e-6, 5e-6),
                ("bf16", dict(f_storage="bfloat16"), 3e-4, 3e-4),
                ("f32 trt+les", dict(collision="trt", smagorinsky=0.16),
                 5e-6, 2e-5))
    for name, kw, bar2, bar6 in variants:
        c = base.replace(**kw)
        f = lbm.to_storage(f32, c)
        a, b = torch.empty_like(f), torch.empty_like(f)
        for key, k, bar in (("K2", None, bar2), ("K6", 4, bar6)):
            if k is None:
                run = lambda: fused_lbm.fused_step_imb_reduce(  # noqa: E731
                    f, solid, td, cnt, c, a)
                plain = lambda: fused_lbm.fused_step_imb_reduce_plain(  # noqa
                    f, solid, td, cnt, c, b)
            else:
                run = lambda: fused_lbm.fused_step_imb_reduce_multi(  # noqa
                    f, solid, td, cnt, c, k, a)
                plain = lambda: fused_lbm.fused_step_imb_reduce_multi_plain(
                    f, solid, td, cnt, c, k, b)  # noqa: E731
            _, parts = run()
            plain()
            err = float((a.float() - b.float()).abs().max())
            assert err <= bar, f"{key} {name} {label}: f' err {err} > {bar}"
            nk = k or 1
            w = work(err, cuda_ms(run, 10), cuda_ms(plain, 1),
                     nbytes(f, solid, td, cnt, a, parts),
                     nk * (FLOPS_NT * cells + cov))
            out[f"{key} {name}"] = w
            bms, by = bound(w)
            log("breadth", f"{label} {key} {name}: f' max err {err:.3e} (bar "
                f"{bar:g}); kernel {w['ms']:.4f} ms, plain {w['plain_ms']:.4f}"
                f" ms (CUDA events); bound {bms:.4f} ms by {by} "
                f"({w['bytes'] / 1e9:.4f} GB)")
    return out


def open_channel_vs_cpu(nx: int = 1024, ny: int = 256, steps: int = 48):
    """A coupled Zou/He channel under TRT + LES (the coupled scene of the
    JAX package's open-boundary tests, at 1024x256): a mobile disk next
    to the outlet that leaves and is culled, a fixed obstacle and a
    mobile disk mid-channel; the card against CPU tensors. Bars: f 1e-5,
    disk x 1e-4, the culled disk inactive on both."""
    from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cfg = SimConfig(nx=nx, ny=ny, tau=0.7, dtype="float32", bc_west="inlet",
                    bc_east="outlet", u_inlet=0.1, inlet_profile="uniform",
                    rho_s=1.0, n_sub=2, u0x=0.1, collision="trt",
                    smagorinsky=0.1, out_interval=10**9)
    disks = [DiskSpec(nx - 3.0, 0.5 * ny, 3.0, vx=0.2),
             DiskSpec(0.25 * nx, 0.4 * ny, 12.0, fixed=True),
             DiskSpec(0.6 * nx, 0.55 * ny, 6.0, vx=0.1)]
    g = Simulation(cfg, disks, device="cuda")
    c = Simulation(cfg, disks, device="cpu")
    reset_counts()
    g.run(steps)
    counts = launch_counts()
    c.run(steps)
    ef = float((g.state.f.cpu() - c.state.f).abs().max())
    ex = float((g.state.disks.x.cpu() - c.state.disks.x).abs().max())
    act_g = g.state.disks.active.cpu().tolist()
    act_c = c.state.disks.active.tolist()
    _, ux, _ = g.macroscopic()
    log("open-channel", f"{nx}x{ny} Zou/He channel, TRT + LES, {steps} steps:"
        f" launches K1 {counts['K1']}, K2 {counts['K2']}, K3 {counts['K3']}; "
        f"f max err {ef:.3e} (bar 1e-5), disk x max err {ex:.3e} (bar 1e-4); "
        f"active card {act_g} CPU {act_c}; inlet ux "
        f"{float(ux[:, 0].min()):.6f}..{float(ux[:, 0].max()):.6f}; overflow "
        f"{int(g.state.overflow)}")
    assert counts["K2"] == steps and counts["K3"] == steps, counts
    assert act_g == act_c == [False, True, True], (act_g, act_c)
    assert float(g.state.disks.x[0, 0]) == -1.0e6
    assert int(g.state.overflow) == 0
    assert ef <= 1e-5 and ex <= 1e-4
    assert abs(float(ux[:, 0].mean()) - 0.1) < 1e-6
    return counts


def dem_breadth_checks(cfg, disks, label: str, timed: bool, seed: int = 3):
    """K3 and K3w with history springs on the packed scene (two
    subcycles first, so the carry holds live springs to re-match), and
    K3 on the same scene made periodic in x and shifted across the seam,
    under both slab orientations, each against its plain version on the
    same card inputs. Bars: every slab channel 3e-5 with kt (springs
    included), 2e-5 on periodic axes, contacts equal. Returns {name:
    work} when timed."""
    from lbmdem_tpu_torch import DiskSpec, Simulation
    from lbmdem_tpu_torch.ops import dem, slab_dem

    out = {}
    sim = Simulation(cfg.replace(kt=25.0), disks, device="cuda")
    c, grid, axis = sim.cfg, sim.grid, sim.dem_axis
    assert slab_dem.slab_supported(grid, axis, kt=True, device="cuda"), \
        "the slab gate rejects this scene"
    rng = np.random.default_rng(seed)
    d = sim.state.disks
    n = d.x.shape[0]
    dev = d.x.device

    def rnd(shape, amp):
        return torch.as_tensor(rng.uniform(-amp, amp, shape),
                               dtype=torch.float32, device=dev)

    d = d._replace(v=rnd((n, 2), 0.02), omega=rnd((n,), 2e-3))
    F, T = rnd((n, 2), 1e-3), rnd((n,), 1e-4)
    for _ in range(2):
        d, ovf, nc0 = slab_dem.dem_subcycle(d, F, T, grid, c, axis)
    live = int((d.ct_j >= 0).sum())
    assert int(ovf) == 0 and int(nc0) > 0 and live > 0
    body = dem.body_forces(d, c)
    act = int(d.active.sum())

    # K3 with springs
    slabs, slot, sovf, kmax, n_occ, bands, j36 = slab_dem.build_slabs(
        d, F, T, body, grid, axis, kt=True)
    s_k, nc_k = slab_dem.subcycle_slabs(slabs.clone(), kmax, n_occ, bands,
                                        grid, c, axis)
    s_p, nc_p = slab_dem.subcycle_slabs_plain(slabs, kmax, c, grid, axis)
    e3 = float((s_k - s_p).abs().max())
    exi = float((s_k[11:] - s_p[11:]).abs().max())
    new, ovf2 = slab_dem._unslab(s_k, slot, d, c, j36, sovf)
    log("dem-breadth", f"{label} K3 kt={c.kt:g}: all 51 channels max err "
        f"{e3:.3e} (springs {exi:.3e}, max |xi| "
        f"{float(s_p[11:47].abs().max()):.3e}; bar 3e-5); contacts "
        f"{int(nc_k)} == {int(nc_p)}; carried springs {live} -> "
        f"{int((new.ct_j >= 0).sum())}; overflow {int(ovf2)}")
    assert e3 <= 3e-5, f"K3 kt {label}: {e3}"
    assert int(nc_k) == int(nc_p) > 0 and int(ovf2) == 0
    assert float(s_p[11:47].abs().max()) > 0 and int((new.ct_j >= 0).sum()) > 0
    dem_flops = c.n_sub * act * 9 * int(kmax) * 75
    if timed:
        scratch = slabs.clone()
        out["K3 kt"] = work(
            e3, cuda_ms(lambda: slab_dem.subcycle_slabs(
                scratch, kmax, n_occ, bands, grid, c, axis), 20),
            cuda_ms(lambda: slab_dem.subcycle_slabs_plain(
                slabs, kmax, c, grid, axis), 2), 2 * nbytes(slabs), dem_flops)

    # K3w with springs: 3 chained calls on the slim layout
    slabs_w, slot_w, sovf, kmax_w, nocc_w, bands_w, j36 = slab_dem.build_slabs(
        d, None, None, body, grid, axis, kt=True, bake_forces=False)
    forces = [(rnd((n, 2), 1e-3), rnd((n,), 1e-4)) for _ in range(3)]
    f3 = slab_dem._force_planes_window(slot_w, forces, body, slabs_w.shape)
    s_k, s_p = slabs_w.clone(), slabs_w
    for t in range(3):
        s_k, nc_k = slab_dem.subcycle_slabs_window(
            s_k, f3[t], kmax_w, nocc_w, bands_w, grid, c, axis)
        s_p, nc_p = slab_dem.subcycle_slabs_plain(s_p, kmax_w, c, grid, axis,
                                                  f3[t])
        assert int(nc_k) == int(nc_p) > 0, (t, int(nc_k), int(nc_p))
    e3w = float((s_k - s_p).abs().max())
    log("dem-breadth", f"{label} K3w kt={c.kt:g}, 3 chained calls: all 48 "
        f"channels max err {e3w:.3e} (bar 3e-5); contacts {int(nc_k)} == "
        f"{int(nc_p)} at the last")
    assert e3w <= 3e-5, f"K3w kt {label}: {e3w}"
    if timed:
        scratch = slabs_w.clone()
        out["K3w kt"] = work(
            e3w, cuda_ms(lambda: slab_dem.subcycle_slabs_window(
                scratch, f3[0], kmax_w, nocc_w, bands_w, grid, c, axis), 20),
            cuda_ms(lambda: slab_dem.subcycle_slabs_plain(
                slabs_w, kmax_w, c, grid, axis, f3[0]), 2),
            2 * nbytes(slabs_w) + nbytes(f3[0]), dem_flops)

    # K3 on a periodic x axis: the packed column shifted across the seam
    pcfg = cfg.replace(bc_west="periodic", bc_east="periodic")
    shift = 0.04 * cfg.nx
    pdisks = [DiskSpec((s.x - shift) % cfg.nx, s.y, s.r) for s in disks]
    psim = Simulation(pcfg, pdisks, device="cuda")
    pc, pgrid = psim.cfg, psim.grid
    pd = psim.state.disks._replace(v=rnd((n, 2), 0.02), omega=rnd((n,), 2e-3))
    seam = int(((pd.x[:, 0] > cfg.nx - 20.0) & pd.active).sum())
    assert seam > 0, "no disk beyond the seam"
    pbody = dem.body_forces(pd, pc)
    for ax in ("x", "y"):
        if not slab_dem.slab_supported(pgrid, ax, device="cuda"):
            log("dem-breadth", f"{label} periodic-x axis={ax}: past the slab "
                f"gate, not run")
            continue
        slabs, slot, sovf, kmax, n_occ, bands, _ = slab_dem.build_slabs(
            pd, F, T, pbody, pgrid, ax)
        assert int(sovf) == 0
        s_k, nc_k = slab_dem.subcycle_slabs(slabs.clone(), kmax, n_occ, bands,
                                            pgrid, pc, ax)
        s_p, nc_p = slab_dem.subcycle_slabs_plain(slabs, kmax, pc, pgrid, ax)
        ep = float((s_k - s_p).abs().max())
        log("dem-breadth", f"{label} K3 periodic x, slab axis {ax} ("
            f"{'rows' if ax == 'x' else 'lanes'} wrap), {seam} disks beyond "
            f"the seam: all channels max err {ep:.3e} (bar 2e-5); contacts "
            f"{int(nc_k)} == {int(nc_p)}")
        assert ep <= 2e-5, f"K3 periodic {label} axis {ax}: {ep}"
        assert int(nc_k) == int(nc_p) > 0
        if timed and ax == psim.dem_axis:
            scratch = slabs.clone()
            out["K3 periodic"] = work(
                ep, cuda_ms(lambda: slab_dem.subcycle_slabs(
                    scratch, kmax, n_occ, bands, pgrid, pc, ax), 20),
                cuda_ms(lambda: slab_dem.subcycle_slabs_plain(
                    slabs, kmax, pc, pgrid, ax), 2), 2 * nbytes(slabs),
                pc.n_sub * act * 9 * int(kmax) * 65)
    # the contacts through the seam: the slab step against the cell-list
    # DEM on the CPU
    a, _, nca = slab_dem.dem_subcycle(pd, F, T, pgrid, pc, psim.dem_axis)
    pdc = type(pd)(*(t.cpu() for t in pd))
    b, _, ncb = dem.dem_subcycle(pdc, F.cpu(), T.cpu(), pgrid, pc)
    on = pdc.active  # unused slots keep the seeded v in the slab step
    err = torch.stack([(getattr(a, k).cpu() - getattr(b, k)).abs().reshape(
        n, -1).max(1).values for k in ("x", "v", "omega")]).max(0).values
    ecl = float(err[on].max())
    over = int((err[on] > 1e-4).sum())
    flips = abs(int(nca) - int(ncb))
    log("dem-breadth", f"{label} periodic x: slab step on the card vs the "
        f"cell-list DEM on the CPU x/v/omega max err {ecl:.3e} (bar 1e-4; "
        f"{over} disks over it); contacts {int(nca)} vs {int(ncb)}")
    # the two DEMs sum in other orders: among tens of thousands of
    # contacts a grazing pair may touch in one and not in the other, and
    # only the disks around it may then miss the bar
    assert flips <= 1e-4 * int(ncb) and over <= 8 * flips, (ecl, over, flips)
    for k, w in out.items():
        bms, by = bound(w)
        log("dem-breadth", f"{label} {k}: kernel {w['ms']:.4f} ms, plain "
            f"{w['plain_ms']:.4f} ms (CUDA events); bound {bms:.4f} ms by {by}"
            f" ({w['bytes'] / 1e9:.4f} GB, {w['flops'] / 1e9:.3f} GFLOP)")
    return out


def kt_slice(smi: str):
    """The coupled slice at full width with history springs: the packed
    4096^2 / 10k-disk column with kt = 25, per step (K2 + K3) and through
    coupling_k = 4 windows (K6 + K3w). The CPU's plane budget would send
    this DEM grid to the cell-list DEM; on the card the slab DEM takes
    it. run(8) to warm, run(16) timed; contacts and live springs form,
    overflow 0, finite f, mass 1e-5. Returns {coupling_k: launch
    counts}."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import column_collapse
    from lbmdem_tpu_torch.ops import slab_dem

    cfg, disks = column_collapse(kt=25.0)
    packed = compressed(disks, 0.94)
    out = {}
    for ck in (1, 4):
        sim = Simulation(cfg.replace(coupling_k=ck, out_interval=10**9),
                         packed, device="cuda")
        assert not slab_dem.slab_supported(sim.grid, sim.dem_axis, kt=True)
        assert slab_dem.slab_supported(sim.grid, sim.dem_axis, kt=True,
                                       device="cuda")
        reset_counts()
        sim.run(8)
        mlups = sim.run(16)
        counts = out[ck] = launch_counts()
        st = sim.state
        springs = int((st.disks.ct_j >= 0).sum())
        mass_err = abs(float(st.f.double().sum()) / (cfg.nx * cfg.ny) - 1.0)
        log("kt-slice", f"column_collapse {cfg.nx}x{cfg.ny}, {len(disks)} "
            f"disks packed, kt {cfg.kt:g}, coupling_k={ck}, 24 steps: "
            f"{mlups:.1f} MLUPS (timed run(16), wall clock) on {smi}; "
            f"launches K2 {counts['K2']}, K3 {counts['K3']}, K6 "
            f"{counts['K6']}, K3w {counts['K3w']}; contacts "
            f"{int(st.n_contacts)}; live springs {springs}; overflow "
            f"{int(st.overflow)}; |sum f/(nx ny) - 1| {mass_err:.3e}")
        want = (24, 24, 0, 0) if ck == 1 else (0, 0, 6, 24)
        assert tuple(counts[k] for k in ("K2", "K3", "K6", "K3w")) == want, \
            counts
        assert int(st.overflow) == 0 and int(st.n_contacts) > 0
        assert springs > 0 and bool(torch.isfinite(st.f).all())
        assert mass_err < 1e-5, mass_err
    return out


def _deck(name: str):
    """(cfg, disks) of examples/<name>.par, read beside this script."""
    from lbmdem_tpu_torch import load_param_file, load_particle_file

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
    cfg, pf = load_param_file(os.path.join(root, name + ".par"))
    return cfg.replace(out_interval=10**9), load_particle_file(pf)


def decks_vs_cpu(smi: str):
    """examples/column_collapse_friction.par at its deck's size (2048^2,
    2 500 disks, kt = 25; the column packed into contact so springs
    form) and examples/periodic_channel.par (128x256, a disk straddling
    the seam), the card against CPU tensors at the slice's bars (f 1e-5,
    disk x 1e-4), overflow 0; then the friction deck through coupling_k
    = 4 windows on the card (K6 + K3w with springs). Returns the launch
    counts of the friction run, of its window run and of the periodic
    channel's."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import slab_dem

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cfg, disks = _deck("column_collapse_friction")
    assert (cfg.nx, cfg.ny, len(disks), cfg.kt) == (2048, 2048, 2500, 25.0)
    packed = compressed(disks, 0.94)
    g = Simulation(cfg, packed, device="cuda")
    c = Simulation(cfg, packed, device="cpu")
    # inside the CPU's gate too: both runs take the slab DEM
    assert slab_dem.slab_supported(g.grid, g.dem_axis, kt=True)
    reset_counts()
    g.run(4)
    t0 = time.perf_counter()
    mlups = g.run(8)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    c.run(12)
    ef = float((g.state.f.cpu() - c.state.f).abs().max())
    ex = float((g.state.disks.x.cpu() - c.state.disks.x).abs().max())
    springs = int((g.state.disks.ct_j >= 0).sum())
    log("decks", f"column_collapse_friction {cfg.nx}x{cfg.ny}, {len(disks)} "
        f"disks packed, kt {cfg.kt:g}, 12 steps: f max err {ef:.3e} (bar "
        f"1e-5), disk x max err {ex:.3e} (bar 1e-4); contacts "
        f"{int(g.state.n_contacts)} == {int(c.state.n_contacts)}; live "
        f"springs {springs}; overflow {int(g.state.overflow)}; launches "
        f"K2 {counts['K2']}, K3 {counts['K3']}; {mlups:.1f} MLUPS over "
        f"run(8) ({secs:.3f} s, wall) on {smi}")
    assert counts["K2"] == counts["K3"] == 12, counts
    assert int(g.state.overflow) == int(c.state.overflow) == 0
    assert ef <= 1e-5 and ex <= 1e-4
    assert int(g.state.n_contacts) == int(c.state.n_contacts) > 0
    assert springs > 0
    w = Simulation(cfg.replace(coupling_k=4), packed, device="cuda")
    reset_counts()
    w.run(16)
    wcounts = launch_counts()
    wf = w.state.f
    log("decks", f"column_collapse_friction coupling_k=4, 16 steps on the "
        f"card: launches K6 {wcounts['K6']}, K3w {wcounts['K3w']}; contacts "
        f"{int(w.state.n_contacts)}; live springs "
        f"{int((w.state.disks.ct_j >= 0).sum())}; overflow "
        f"{int(w.state.overflow)}; |sum f/(nx ny) - 1| "
        f"{abs(float(wf.double().sum()) / (cfg.nx * cfg.ny) - 1.0):.3e}")
    assert (wcounts["K6"], wcounts["K3w"]) == (4, 16), wcounts
    assert int(w.state.overflow) == 0 and int(w.state.n_contacts) > 0
    assert bool(torch.isfinite(wf).all())
    assert int((w.state.disks.ct_j >= 0).sum()) > 0
    del g, c, w

    cfg, disks = _deck("periodic_channel")
    g = Simulation(cfg, disks, device="cuda")
    c = Simulation(cfg, disks, device="cpu")
    assert slab_dem.slab_supported(g.grid, g.dem_axis)
    reset_counts()
    g.run(200)
    pcounts = launch_counts()
    c.run(200)
    ef = float((g.state.f.cpu() - c.state.f).abs().max())
    ex = float((g.state.disks.x.cpu() - c.state.disks.x).abs().max())
    xs = g.state.disks.x[:, 0]
    log("decks", f"periodic_channel {cfg.nx}x{cfg.ny}, {len(disks)} mobile "
        f"disks on a periodic x axis, 200 steps: f max err {ef:.3e} (bar "
        f"1e-5), disk x max err {ex:.3e} (bar 1e-4); launches K1 "
        f"{pcounts['K1']}, K2 {pcounts['K2']}, K3 {pcounts['K3']}; seam disk "
        f"x {float(xs[0]):.4f}; overflow {int(g.state.overflow)}")
    assert pcounts["K2"] == pcounts["K3"] == 200, pcounts
    assert int(g.state.overflow) == int(c.state.overflow) == 0
    assert ef <= 1e-5 and ex <= 1e-4
    assert -0.5 <= float(xs[0]) < cfg.nx - 0.5
    return counts, wcounts, pcounts


def ablation(coupling_k: int, chunk: int = 20, storage: str = "float32"):
    """lbmdem_tpu_torch.tools.ablate at 4096^2/10k disks: each variant's
    row and the marginals (bf16 storage: every variant on the K2 step).
    Returns the launch counts of the whole run."""
    from lbmdem_tpu_torch.tools import ablate

    sim = ablate.make_sim(4096, 10000, device="cuda",
                          env={"ABLATE_COUPLING_K": str(coupling_k),
                               "ABLATE_F_STORAGE": storage})
    reset_counts()
    tag = f"ablate k={coupling_k}" + ("" if storage == "float32"
                                      else f" {storage}")
    res = ablate.run_variants(sim, chunk, log=lambda s: log(tag, s))
    counts = launch_counts()
    assert all(r["ms"] > 0 for r in res.values())
    if storage != "float32":
        assert res["full"]["launches"].get("K2") == 1.0, res["full"]
        assert counts["K8"] == counts["K9"] == 0, counts
    elif coupling_k == 1:
        per = res["full"]["launches"]
        assert per.get("K8") == per.get("K9") == per.get("K1") == 1.0, per
        assert res["fused"]["launches"].get("K2") == 1.0
        assert counts["K8"] > 0 and counts["K9"] > 0, counts
    return counts


def main() -> int:
    smi = probe()
    build()
    from lbmdem_tpu_torch.models import column_collapse

    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    kernel_checks(cfg, compressed(disks, 0.94),
                  f"{cfg.nx}x{cfg.ny}/{len(disks)} disks", timed=False)
    split_matrix()
    split_checks(cfg, compressed(disks, 0.94),
                 f"{cfg.nx}x{cfg.ny}/{len(disks)} disks", timed=False)
    cfg, disks = column_collapse()
    res = kernel_checks(cfg, compressed(disks, 0.94),
                        f"{cfg.nx}x{cfg.ny}/{len(disks)} disks", timed=True)
    res.update(split_checks(cfg, compressed(disks, 0.94),
                            f"{cfg.nx}x{cfg.ny}/{len(disks)} disks",
                            timed=True))
    counts, mlups1 = slice_run(smi)
    _, mlups_r, rsim = slice_run(smi, eps_method="ramp", keep=True)
    log("ramp-slice", f"eps_method=ramp {mlups_r:.1f} MLUPS vs sample "
        f"{mlups1:.1f} MLUPS in this call ({mlups_r / mlups1:.3f}x)")
    split_on_run_state(rsim)
    del rsim
    slice_vs_cpu()
    slice_vs_cpu(eps_method="ramp")
    wcounts, mlups4 = slice_run(smi, coupling_k=4)
    log("window-slice", f"coupling_k=4 {mlups4:.1f} MLUPS vs coupling_k=1 "
        f"{mlups1:.1f} MLUPS in this call ({mlups4 / mlups1:.3f}x)")
    slice_vs_cpu(coupling_k=4, steps=19)
    coupling_k_settling()
    res.update(fluid_kernels())
    fcounts, _ = fluid_slice(smi, "float32")
    fluid_slice(smi, "bfloat16")
    poiseuille_check()
    fluid_vs_cpu()
    res.update(static_kernels())
    scounts, _ = static_slice(smi, "float32")
    static_slice(smi, "bfloat16")
    ghosts_vs_cpu()
    drift_vs_cpu()
    breadth_matrix()
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    dem_breadth_checks(cfg, compressed(disks, 0.94),
                       f"{cfg.nx}x{cfg.ny}/{len(disks)} disks", timed=False)
    cfg, disks = column_collapse()
    label = f"{cfg.nx}x{cfg.ny}/{len(disks)} disks"
    new = breadth_timed(cfg, compressed(disks, 0.94), label)
    new.update(dem_breadth_checks(cfg, compressed(disks, 0.94), label,
                                  timed=True))
    bcounts, mlups_b, bsim = slice_run(smi, storage="bfloat16", keep=True)
    split_on_run_state(bsim)
    del bsim
    bwcounts, mlups_bw = slice_run(smi, coupling_k=4, storage="bfloat16")
    log("bfloat16-slice", f"f_storage=bfloat16 {mlups_b:.1f} MLUPS (k=1), "
        f"{mlups_bw:.1f} MLUPS (k=4) vs float32 {mlups1:.1f} and "
        f"{mlups4:.1f} MLUPS in this call ({mlups_b / mlups1:.3f}x, "
        f"{mlups_bw / mlups4:.3f}x)")
    slice_vs_cpu(storage="bfloat16")
    slice_vs_cpu(coupling_k=4, steps=19, storage="bfloat16")
    slice_vs_cpu(kt=25.0)
    slice_vs_cpu(coupling_k=4, steps=19, kt=25.0)
    kt_slice(smi)
    open_counts = open_channel_vs_cpu()
    dcounts, dwcounts, pcounts = decks_vs_cpu(smi)
    acounts = ablation(1)
    ablation(4)
    ablation(1, chunk=10, storage="bfloat16")
    counts.update({k: acounts[k] for k in ("K8", "K9")})
    counts.update({k: fcounts[k] for k in ("K4", "K5")})
    counts.update({k: wcounts[k] for k in ("K6", "K3w")})
    counts["K7"] = scounts["K7"]
    res["K6"] = res["K6 k=4"]
    meta = {
        "K1": ("stamp", "lbmdem_tpu_torch/csrc/stamp.cu",
               "lbmdem_tpu/ops/pallas_stamp.py:270"),
        "K2": ("imb_reduce", "lbmdem_tpu_torch/csrc/imb_reduce.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:1048"),
        "K3": ("slab_dem", "lbmdem_tpu_torch/csrc/slab_dem.cu",
               "lbmdem_tpu/ops/pallas_dem.py:313"),
        "K4": ("fluid_step", "lbmdem_tpu_torch/csrc/fluid.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:585"),
        "K5": ("fluid_multi", "lbmdem_tpu_torch/csrc/fluid.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:780"),
        "K6": ("imb_reduce_multi", "lbmdem_tpu_torch/csrc/imb_multi.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:1257"),
        "K3w": ("slab_dem_window", "lbmdem_tpu_torch/csrc/slab_dem.cu",
                "lbmdem_tpu/ops/pallas_dem.py:313"),
        "K7": ("imb_static_multi", "lbmdem_tpu_torch/csrc/imb_static.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:911"),
        "K8": ("imb_split_step", "lbmdem_tpu_torch/csrc/imb_split.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:1469"),
        "K9": ("reduce_hydro", "lbmdem_tpu_torch/csrc/imb_split.cu",
               "lbmdem_tpu/ops/pallas_stamp.py:474"),
    }
    # the new instantiations: (base kernel, tag, work, launches of the
    # path that ran it)
    extra = [("K2", "bf16", new["K2 bf16"], bcounts["K2"]),
             ("K6", "bf16", new["K6 bf16"], bwcounts["K6"]),
             ("K2", "trt+les", new["K2 f32 trt+les"], open_counts["K2"]),
             ("K3", "kt", new["K3 kt"], dcounts["K3"]),
             ("K3w", "kt", new["K3w kt"], dwcounts["K3w"]),
             ("K3", "periodic", new["K3 periodic"], pcounts["K3"])]
    kernels = []
    rows = [(k, "", res[k], counts[k]) for k in (
        "K1", "K2", "K3", "K4", "K5", "K6", "K3w", "K7", "K8", "K9")] + extra
    for k, tag, w, launches in rows:
        bms, by = bound(w)
        # no single PyTorch call computes any of these functions
        kernels.append({
            "name": meta[k][0] + (f"[{tag}]" if tag else ""), "route": "cuda",
            "source": meta[k][1], "replaces": meta[k][2],
            "launches": launches,
            "max_abs_err": w["err"], "ms": w["ms"], "plain_ms": w["plain_ms"],
            "bound_ms": bms, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
