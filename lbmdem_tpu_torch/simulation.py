"""Simulation state + driver: the coupled main path.

Counterpart of the JAX package's `lbmdem_tpu/simulation.py` for the
configuration it was benchmarked on (`Simulation(cfg, disks,
use_pallas=True).run(n)`): f32 storage, BGK, eps_method="sample",
coupling_k=1, walls, one device. Each step (`make_step_fn`) runs

    coupling inputs (binning + travel check) -> gather_tile_data ->
    K1 stamp -> K2 fused IMB collide/stream/BB + reduce ->
    gather_partials -> body forces -> build_slabs -> K3 slab DEM ->
    _unslab -> leftover fallback

and `run` drives it in Verlet-cadence chunks: the stamp tile lists are
rebuilt every BIN_CADENCE steps with BIN_MARGIN cells of slack, and
travel beyond the margin is counted into `state.overflow`.

On CUDA tensors the three kernels run as hand-written CUDA; on CPU
tensors every kernel takes its plain PyTorch version (float32 or
float64). Everything outside this slice raises NotImplementedError
naming the ROADMAP.md item that will port it.

    sim = Simulation(cfg, disks, device="cuda")
    mlups = sim.run(100)
    rho, ux, uy = sim.macroscopic()
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from lbmdem_tpu_torch.config import DiskSpec, SimConfig, window_for_radius
from lbmdem_tpu_torch.ops import fused_lbm, imb, lbm, not_ported, slab_dem
from lbmdem_tpu_torch.ops import stamp
from lbmdem_tpu_torch.ops.dem import DemGrid, DiskState, make_disk_state

# Verlet-style cadence for the stamp tile lists (as the JAX driver)
BIN_CADENCE = 8
BIN_MARGIN = 2


class SimState(NamedTuple):
    """Full simulation state (the JAX `SimState` fields); the counters
    are 0-dim int32 tensors on the state's device."""

    f: torch.Tensor  # (9, ny, nx) distributions
    disks: DiskState
    step: torch.Tensor
    overflow: torch.Tensor  # max binning/slab overflow seen
    n_contacts: torch.Tensor  # contacts at the last step
    fail_step: torch.Tensor  # -1 (paranoid mode is not ported)


def check_slice(cfg: SimConfig, disks: Sequence[DiskSpec], device,
                mesh=None) -> None:
    """Raise NotImplementedError for every configuration outside the
    ported main path, naming the ROADMAP.md item that will port it."""
    if mesh is not None:
        raise not_ported("a device mesh (multi-GPU)", 12)
    if cfg.max_disks == 0 and not disks:
        raise not_ported("pure-fluid scenes (max_disks == 0; kernels K4/K5)",
                         9)
    if not disks:
        raise not_ported("coupled scenes without disks", 9)
    if cfg.coupling_k > 1:
        raise not_ported("coupling_k > 1 (kernels K3w/K6)", 10)
    if all(d.fixed for d in disks):
        raise not_ported("all-fixed scenes (drift mode; static hoist K7)", 10)
    if cfg.paranoia:
        raise not_ported("paranoid mode", 11)
    if cfg.dtype == "float64" and torch.device(device).type == "cuda":
        raise not_ported("dtype='float64' on the card", 9)
    fused_lbm.check_step_cfg(cfg)
    slab_dem.check_dem_cfg(cfg)


def _zero_i32(device, value: int = 0) -> torch.Tensor:
    return torch.full((), value, dtype=torch.int32, device=device)


def make_step_fn(cfg: SimConfig, grid: DemGrid, tile_lists=None,
                 dem_axis: str = "y") -> Callable:
    """The coupled coupling_k=1 step: step(state, f_out) -> SimState.

    `f_out` is the second, dead f buffer: K2 writes the new populations
    into it (never into state.f), and the caller swaps the two buffers.

    `tile_lists` = (lists, counts, entry_slots, x_bin) reuses a binning
    built at x_bin with BIN_MARGIN slack (Verlet cadence); per-step
    travel beyond the margin is counted into state.overflow. Without it
    every step bins afresh (margin 0)."""

    def coupling_inputs(d: DiskState):
        if tile_lists is not None:
            lists, counts, entry_slots, x_bin = tile_lists
            travel2 = torch.where(d.active, torch.sum((d.x - x_bin) ** 2, -1),
                                  torch.zeros_like(d.r))
            bovf = torch.sum(travel2 > float(BIN_MARGIN) ** 2).to(torch.int32)
        else:
            lists, counts, entry_slots, bovf = stamp.build_tile_lists(
                d.x, d.active, cfg)
        tile_data = stamp.gather_tile_data(lists, d.x, d.v, d.omega, d.r,
                                           d.active)
        return tile_data, counts, entry_slots, bovf

    def step(state: SimState, f_out: torch.Tensor) -> SimState:
        d = state.disks
        tile_data, counts, entry_slots, bovf = coupling_inputs(d)
        solid = stamp.stamp_fields(tile_data, counts, cfg)
        fnew, partials = fused_lbm.fused_step_imb_reduce(
            state.f, solid, tile_data, counts, cfg, f_out)
        fh, th = stamp.gather_partials(partials, entry_slots, d.x.dtype)
        disks, ovf, nc = slab_dem.dem_subcycle(d, fh, th, grid, cfg,
                                               dem_axis)
        return SimState(
            f=fnew, disks=disks, step=state.step + 1,
            overflow=torch.maximum(state.overflow, torch.maximum(ovf, bovf)),
            n_contacts=nc, fail_step=state.fail_step,
        )

    return step


class Simulation:
    """User-facing driver: owns the config, the state and two f buffers."""

    def __init__(self, cfg: SimConfig, disks: Sequence[DiskSpec] = (),
                 device="cpu", mesh=None):
        disks = list(disks)
        self.device = torch.device(device)
        check_slice(cfg, disks, self.device, mesh)
        r_max = max(d.r for d in disks)
        if cfg.window <= 0:
            cfg = cfg.replace(window=window_for_radius(r_max))
        if cfg.max_disks < len(disks):
            cfg = cfg.replace(max_disks=len(disks))
        self.grid = DemGrid.build(cfg, r_max)
        if cfg.tile_cap <= 0:
            th, tw = stamp.tile_dims(cfg)
            r_min = min(d.r for d in disks)
            cfg = cfg.replace(tile_cap=stamp.default_tile_cap(
                th, tw, r_min, cfg.window + 2 * BIN_MARGIN))
        self.cfg = cfg
        self.dem_axis = slab_dem.choose_axis(disks, cfg)
        if not slab_dem.slab_supported(self.grid, self.dem_axis):
            raise not_ported("DEM grids beyond the slab gate (the cell-list "
                             "dem_subcycle)", 9)
        f = lbm.to_storage(lbm.init_equilibrium(cfg, self.device), cfg)
        self.state = SimState(
            f=f, disks=make_disk_state(disks, cfg, device=self.device),
            step=_zero_i32(self.device), overflow=_zero_i32(self.device),
            n_contacts=_zero_i32(self.device),
            fail_step=_zero_i32(self.device, -1),
        )
        # the second f buffer: each step writes into it and the two swap
        self._f_spare = torch.empty_like(f)
        self._step = make_step_fn(cfg, self.grid, dem_axis=self.dem_axis)
        self.mlups_last = 0.0

    # --- stepping ---
    def _advance(self, stepfn: Callable) -> None:
        old_f = self.state.f
        self.state = stepfn(self.state, self._f_spare)
        self._f_spare = old_f

    def step(self) -> None:
        """One step with a fresh binning (no cadence)."""
        self._advance(self._step)

    def _run_chunk(self, n: int) -> None:
        """n steps as Verlet-cadence blocks of BIN_CADENCE steps (the JAX
        single-device coupled chunk): each block rebuilds the tile lists
        with BIN_MARGIN slack and counts their overflow."""
        cfg = self.cfg
        done = 0
        while done < n:
            k = min(BIN_CADENCE, n - done)
            d = self.state.disks
            lists, counts, entry_slots, bovf = stamp.build_tile_lists(
                d.x, d.active, cfg, margin=BIN_MARGIN)
            self.state = self.state._replace(
                overflow=torch.maximum(self.state.overflow, bovf))
            stepfn = make_step_fn(cfg, self.grid,
                                  (lists, counts, entry_slots, d.x),
                                  self.dem_axis)
            for _ in range(k):
                self._advance(stepfn)
            done += k

    def run(self, steps: Optional[int] = None,
            callback: Optional[Callable[["Simulation"], None]] = None) -> float:
        """Run `steps` LBM steps (default cfg.steps), calling `callback`
        every cfg.out_interval steps. Returns MLUPS (wall clock, ended by
        a device synchronize)."""
        steps = int(steps if steps is not None else self.cfg.steps)
        interval = self.cfg.out_interval or steps
        done = 0
        t0 = time.perf_counter()
        while done < steps:
            n = min(interval, steps - done)
            self._run_chunk(n)
            done += n
            if callback is not None:
                self._sync()
                callback(self)
        self._sync()
        dt_s = time.perf_counter() - t0
        self.mlups_last = self.cfg.nx * self.cfg.ny * steps / dt_s / 1e6
        return self.mlups_last

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def load_state(self, d: dict) -> None:
        """Replace the state by one in the numpy form of
        `interop.state_to_numpy` (e.g. converted from the JAX package)."""
        from lbmdem_tpu_torch.interop import state_from_numpy

        self.state = state_from_numpy(d, self.device)
        self._f_spare = torch.empty_like(self.state.f)

    # --- observation ---
    def macroscopic(self):
        """(rho, ux, uy) as numpy arrays."""
        rho, ux, uy = lbm.moments(lbm.from_storage(self.state.f, self.cfg),
                                  self.cfg.gx, self.cfg.gy)
        return rho.cpu().numpy(), ux.cpu().numpy(), uy.cpu().numpy()

    def disk_arrays(self):
        return {k: v.cpu().numpy()
                for k, v in self.state.disks._asdict().items()}

    def hydro_forces(self):
        """(F (N, 2), T (N,)) per disk from one evaluation of the plain
        IMB functions on the CURRENT state (observation only; the steps
        compute theirs in the kernels)."""
        cfg = self.cfg
        d = self.state.disks
        eps, usx, usy = imb.stamp_solid_fraction(d.x, d.v, d.omega, d.r,
                                                 d.active, cfg)
        f_phys = lbm.from_storage(self.state.f, cfg)
        _, phix, phiy = imb.collide_imb(f_phys, eps, usx, usy, cfg)
        fh, th = imb.reduce_hydro_forces(d.x, d.r, d.active, eps, phix, phiy,
                                         cfg)
        return fh.cpu().numpy(), th.cpu().numpy()
