"""Simulation state + driver: the coupled main path, its coupling_k
windows, and pure fluid.

Counterpart of the JAX package's `lbmdem_tpu/simulation.py` on its
kernel path (`Simulation(cfg, disks, use_pallas=True).run(n)`) on one
device: f32 or shifted-bf16 storage, BGK or TRT, Smagorinsky LES,
nt_mode "nt" or "lambda", any eps_method (sample, ramp, exact), walls,
moving walls, periodic axes and the Zou/He inlet/outlet, dashpot or
history-spring friction (cfg.kt). Each coupled step (`make_step_fn`)
runs

    coupling inputs (binning + travel check) -> gather_tile_data ->
    K1 stamp -> K2 fused IMB collide/stream/BB + reduce ->
    gather_partials -> body forces -> build_slabs -> K3 slab DEM ->
    _unslab -> leftover fallback

and `run` drives it in Verlet-cadence chunks: the stamp tile lists are
rebuilt every BIN_CADENCE steps with BIN_MARGIN cells of slack, and
travel beyond the margin is counted into `state.overflow`. Where the
DEM grid is beyond the slab DEM's gate (`slab_dem.slab_supported`: on
the card only what K3 needs; on the CPU also the JAX package's plane
budget, narrower with the spring channels of cfg.kt > 0, so both
packages take the same DEM there), the cell-list `dem.dem_subcycle`
takes the slab DEM's place. In
a Zou/He channel the solid stack's first and last columns are zeroed
(the closures assume fluid there) and mobile disks that have left
through an open end are deactivated after the DEM
(`dem.cull_open_boundaries`).

With cfg.coupling_k = k > 1, `run` splits each cadence block of b steps
into b // k windows and then b % k such per-step steps. A window
(`make_step_fn(..., coupling_k=k)`) stamps once from the window-start
positions, runs k coupled steps in one K6 pass over that frozen solid
stack and binning (a force reduce after every inner collide), then
k chained K3w DEM subcycles on one slim slab build, each with its own
inner step's forces, and counts disks that travelled past the slab
skin into `overflow`. `step()` stays exact per-step coupling (K2, K3).

Without disks (`max_disks == 0`) the step is pure fluid: `step()` is one
K4 launch, and `run` drives each chunk of n steps as n // TEMPORAL_K
K5 passes of TEMPORAL_K steps each, then n % TEMPORAL_K K4 steps, on
any lattice option and on f32 or shifted-bf16 storage.

When every disk is `DiskSpec.fixed` there is no contact mechanics
(`dem_mode == "drift"`): fixed disks move at their prescribed v and
omega. If they are also at rest (`static_solid`), the binning and the
stamp are constants: `run` stamps once (K1, `_static_solid_operands`)
and takes each chunk of n steps as n // TEMPORAL_K K7 passes of
TEMPORAL_K steps and n % TEMPORAL_K K7 passes of one step, with no
reduce. Otherwise `run` keeps the Verlet-cadence chunk (K1 + K2 per
step, or K1 + K6 per coupling_k window) with the drift in place of the
slab DEM, and `step()` on any all-fixed scene is that per-step step.

On a periodic axis, disks whose stamp window crosses the seam get
min-image ghost copies for the binning, the stamp and the force reduce
(`imb.periodic_ghosts`); the ghosts' forces fold back into their
parents, and the DEM takes minimum-image contacts across the seam.

`Simulation` runs on the card unless it is given device="cpu". On CUDA
tensors the kernels run as hand-written CUDA; on CPU tensors every
kernel takes its plain PyTorch version (float32 or float64). What is
not ported (float64 on the card, coupled scenes without disks, paranoid
mode, a device mesh) raises NotImplementedError naming the ROADMAP.md
item that will port it.

    sim = Simulation(cfg, disks, device="cuda")
    mlups = sim.run(100)
    rho, ux, uy = sim.macroscopic()
"""

from __future__ import annotations

import time
from typing import Callable, NamedTuple, Optional, Sequence

import torch

from lbmdem_tpu_torch.config import DiskSpec, SimConfig, window_for_radius
from lbmdem_tpu_torch.ops import (dem, fused_fluid, fused_lbm, fused_static,
                                  imb, lbm, not_ported, slab_dem)
from lbmdem_tpu_torch.ops import stamp
from lbmdem_tpu_torch.ops.dem import DemGrid, DiskState, make_disk_state

# Verlet-style cadence for the stamp tile lists (as the JAX driver)
BIN_CADENCE = 8
BIN_MARGIN = 2

# Pure-fluid temporal blocking: steps per K5 pass (the JAX driver's
# choice, kept so both packages split a run alike)
TEMPORAL_K = 4


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
    """Raise NotImplementedError for the configurations that are not
    ported, naming the ROADMAP.md item that will port each."""
    if mesh is not None:
        raise not_ported("a device mesh (multi-GPU)", 12)
    if cfg.paranoia:
        raise not_ported("paranoid mode", 11)
    if cfg.dtype == "float64" and torch.device(device).type == "cuda":
        raise not_ported("dtype='float64' on the card", 9)
    if cfg.max_disks == 0 and not disks:
        fused_fluid.check_fluid_cfg(cfg)
        return
    if not disks:
        raise not_ported("coupled scenes without disks", 9)


def _at_rest(disks: Sequence[DiskSpec]) -> bool:
    return all(d.vx == 0.0 and d.vy == 0.0 and d.omega == 0.0 for d in disks)


def _zero_i32(device, value: int = 0) -> torch.Tensor:
    return torch.full((), value, dtype=torch.int32, device=device)


def make_step_fn(cfg: SimConfig, grid: Optional[DemGrid], tile_lists=None,
                 dem_axis: str = "y", temporal_k: int = 1,
                 coupling_k: int = 1, dem_mode: str = "subcycle") -> Callable:
    """The step: step(state, f_out) -> SimState.

    grid None (no disks): the pure-fluid step, temporal_k steps in one
    kernel pass (K4 when 1, K5 above). Otherwise the coupled step: one
    step (K1, K2, DEM) when coupling_k is 1, else a window of coupling_k
    steps (K1 once, K6, then coupling_k DEM updates). The DEM is the
    slab subcycle (K3, or K3w chained over the window), the cell-list
    subcycle where the grid is beyond the slab gate, or under dem_mode
    "drift" the prescribed motion of fixed disks.

    `f_out` is the second, dead f buffer: the kernel writes the new
    populations into it (never into state.f), and the caller swaps the
    two buffers.

    `tile_lists` = (lists, counts, entry_slots, x_bin, gparent, gaxes)
    reuses a binning built at x_bin with BIN_MARGIN slack (Verlet
    cadence) and the periodic ghost selection made with it (gparent,
    gaxes None without periodic axes); per-step travel beyond the margin
    is counted into state.overflow. Without it every step wraps, selects
    ghosts and bins afresh (margin 0)."""
    if grid is None:

        def fluid_step(state: SimState, f_out: torch.Tensor) -> SimState:
            fnew = fused_fluid.fused_step_fluid_multi(state.f, cfg, temporal_k,
                                                      f_out)
            return state._replace(f=fnew, step=state.step + temporal_k)

        return fluid_step

    periodic = bool(cfg.wrap_lx or cfg.wrap_ly)
    # Zou/He channels: the boundary columns stay pure fluid, and mobile
    # disks that leave through an open end are deactivated
    open_cull = cfg.bc_west == "inlet"

    def use_slab_dem(d: DiskState) -> bool:
        return (dem_mode == "subcycle" and slab_dem.slab_supported(
            grid, dem_axis, kt=cfg.kt > 0.0, device=d.x.device))

    def stamp_solid(tile_data, counts):
        solid = stamp.stamp_fields(tile_data, counts, cfg)
        if open_cull:
            solid[:, :, 0].zero_()
            solid[:, :, -1].zero_()
        return solid

    def coupling_inputs(d: DiskState):
        """The step's (or window's) coupling inputs: (d, tile_data,
        counts, entry_slots, bovf, gparent). `d` has wrapped positions
        when this call selected ghosts afresh; with tile_lists the
        positions wrapped at the last rebuild and must not wrap again
        before the next (the lists would see the +-L jump). The binning
        is of the ghost-augmented disks (N + G rows)."""
        gparent = aug = None
        if tile_lists is not None:
            lists, counts, entry_slots, x_bin, gparent, gaxes = tile_lists
            travel2 = torch.where(d.active, torch.sum((d.x - x_bin) ** 2, -1),
                                  torch.zeros_like(d.r))
            bovf = torch.sum(travel2 > float(BIN_MARGIN) ** 2).to(torch.int32)
        elif periodic:
            xw, aug, gparent, gaxes, govf = imb.periodic_ghosts(
                d.x, d.v, d.omega, d.r, d.active, cfg)
            d = d._replace(x=xw)
        if not periodic:
            aug = (d.x, d.v, d.omega, d.r, d.active)
        elif aug is None:  # Verlet cadence: stored selection, current x
            aug = imb.apply_ghosts(gparent, gaxes, d.x, d.v, d.omega, d.r,
                                   d.active, cfg)
        xa, va, oma, ra, acta = aug
        if tile_lists is None:
            lists, counts, entry_slots, bovf = stamp.build_tile_lists(
                xa, acta, cfg)
            if periodic:
                bovf = torch.maximum(bovf, govf)
        tile_data = stamp.gather_tile_data(lists, xa, va, oma, ra, acta)
        return d, tile_data, counts, entry_slots, bovf, gparent

    def hydro(partials, entry_slots, gparent, n_real: int, dtype):
        """Per-disk (F, T) of one step's partials, ghosts folded in."""
        fh, th = stamp.gather_partials(partials, entry_slots, dtype)
        if periodic:
            fh, th = imb.fold_ghost_forces(fh, th, gparent, n_real)
        return fh, th

    def advance_disks(d: DiskState, fh, th):
        """One step of disk motion: the slab DEM subcycle (the cell-list
        subcycle beyond the slab gate), or under dem_mode "drift" (every
        disk fixed) the prescribed translation and rotation over dt = 1,
        with no contact machinery."""
        if dem_mode == "drift":
            act = d.active.to(d.x.dtype)
            z = _zero_i32(d.x.device)
            return d._replace(x=d.x + d.v * act[:, None],
                              theta=d.theta + d.omega * act), z, z
        if use_slab_dem(d):
            return slab_dem.dem_subcycle(d, fh, th, grid, cfg, dem_axis)
        return dem.dem_subcycle(d, fh, th, grid, cfg)

    if coupling_k > 1:

        def window_step(state: SimState, f_out: torch.Tensor) -> SimState:
            n_real = state.disks.x.shape[0]
            # window-start coupling inputs, frozen for the k inner steps
            d, tile_data, counts, entry_slots, bovf, gparent = (
                coupling_inputs(state.disks))
            solid = stamp_solid(tile_data, counts)
            fnew, parts = fused_lbm.fused_step_imb_reduce_multi(
                state.f, solid, tile_data, counts, cfg, coupling_k, f_out)
            forces = [hydro(parts[t], entry_slots, gparent, n_real, d.x.dtype)
                      for t in range(coupling_k)]
            if use_slab_dem(d):
                disks, ovf, nc = slab_dem.dem_subcycle_window(
                    d, forces, grid, cfg, dem_axis)
            else:  # the drift or the cell-list DEM, per inner step
                disks, ovf, nc = d, bovf, state.n_contacts
                for fh, th in forces:
                    disks, ovf_t, nc = advance_disks(disks, fh, th)
                    ovf = torch.maximum(ovf, ovf_t)
            if open_cull:
                disks = dem.cull_open_boundaries(disks, cfg)
            return SimState(
                f=fnew, disks=disks, step=state.step + coupling_k,
                overflow=torch.maximum(state.overflow,
                                       torch.maximum(ovf, bovf)),
                n_contacts=nc, fail_step=state.fail_step,
            )

        return window_step

    def step(state: SimState, f_out: torch.Tensor) -> SimState:
        n_real = state.disks.x.shape[0]
        d, tile_data, counts, entry_slots, bovf, gparent = coupling_inputs(
            state.disks)
        solid = stamp_solid(tile_data, counts)
        fnew, partials = fused_lbm.fused_step_imb_reduce(
            state.f, solid, tile_data, counts, cfg, f_out)
        fh, th = hydro(partials, entry_slots, gparent, n_real, d.x.dtype)
        disks, ovf, nc = advance_disks(d, fh, th)
        if open_cull:
            disks = dem.cull_open_boundaries(disks, cfg)
        return SimState(
            f=fnew, disks=disks, step=state.step + 1,
            overflow=torch.maximum(state.overflow, torch.maximum(ovf, bovf)),
            n_contacts=nc, fail_step=state.fail_step,
        )

    return step


def make_static_step_fn(cfg: SimConfig, solid: torch.Tensor,
                        k: int) -> Callable:
    """The static-solid hoist's step: k coupled steps over the constant
    solid stack in one K7 pass (no binning, reduce or DEM; the fixed
    disks at rest never move)."""

    def static_step(state: SimState, f_out: torch.Tensor) -> SimState:
        fnew = fused_static.fused_step_imb_static_multi(state.f, solid, cfg,
                                                        k, f_out)
        return state._replace(f=fnew, step=state.step + k)

    return static_step


class Simulation:
    """User-facing driver: owns the config, the state and two f buffers.

    It runs on the card (device="cuda", the default) unless it is given
    device="cpu", where every kernel takes its plain version; it raises
    RuntimeError when asked for the card and none is present."""

    def __init__(self, cfg: SimConfig, disks: Sequence[DiskSpec] = (),
                 device="cuda", mesh=None):
        disks = list(disks)
        check_slice(cfg, disks, device, mesh)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Simulation: no CUDA device is available "
                "(torch.cuda.is_available() is False); pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
        # every disk fixed: no contact mechanics, positions drift at the
        # prescribed v/omega; also at rest: binning and stamp are constant
        self.dem_mode = ("drift" if disks and all(d.fixed for d in disks)
                         else "subcycle")
        self.static_solid = self.dem_mode == "drift" and _at_rest(disks)
        self._solid_stack = None  # _static_solid_operands' cache
        if disks:
            cfg = self._derive_coupled(cfg, disks)
        else:
            self.grid = None
            self.dem_axis = "y"
            self._kstep = make_step_fn(cfg, None, temporal_k=TEMPORAL_K)
        self.cfg = cfg
        f = lbm.to_storage(lbm.init_equilibrium(cfg, self.device), cfg)
        self.state = SimState(
            f=f, disks=make_disk_state(disks, cfg, device=self.device),
            step=_zero_i32(self.device), overflow=_zero_i32(self.device),
            n_contacts=_zero_i32(self.device),
            fail_step=_zero_i32(self.device, -1),
        )
        # the second f buffer: each step writes into it and the two swap
        self._f_spare = torch.empty_like(f)
        self._step = make_step_fn(cfg, self.grid, dem_axis=self.dem_axis,
                                  dem_mode=self.dem_mode)
        self.mlups_last = 0.0

    def _derive_coupled(self, cfg: SimConfig, disks) -> SimConfig:
        """The coupled path's derived config (window, capacity, tile cap,
        ghost cap), its DEM grid and slab axis (make_step_fn takes the
        cell-list DEM where the slab gate rejects the grid)."""
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
        cfg.validate_periodic_dem()
        if (cfg.wrap_lx or cfg.wrap_ly) and cfg.ghost_cap <= 0:
            cfg = cfg.replace(ghost_cap=imb.default_ghost_cap(
                cfg.max_disks, cfg, BIN_MARGIN))
        self.dem_axis = slab_dem.choose_axis(disks, cfg)
        return cfg

    # --- stepping ---
    def _advance(self, stepfn: Callable) -> None:
        old_f = self.state.f
        self.state = stepfn(self.state, self._f_spare)
        self._f_spare = old_f

    def step(self) -> None:
        """One step (coupled: with a fresh binning, no cadence; all-fixed
        scenes: the per-step drift step, static or not)."""
        self._advance(self._step)

    def _run_chunk(self, n: int) -> None:
        """n steps as Verlet-cadence blocks of BIN_CADENCE steps (the JAX
        single-device coupled chunk): each block wraps the positions and
        selects the periodic ghosts with BIN_MARGIN slack, rebuilds the
        tile lists with the same slack and counts both overflows, then
        takes its b steps as b // coupling_k windows and b % coupling_k
        single steps. The static hoist (all disks fixed at rest) instead
        takes n // TEMPORAL_K K7 passes of TEMPORAL_K steps and
        n % TEMPORAL_K of one step over the solid stack stamped once.
        Pure fluid: n // TEMPORAL_K K5 passes, then n % TEMPORAL_K K4
        steps (the JAX pure-fluid chunk)."""
        if self.grid is None:
            passes, singles = divmod(n, TEMPORAL_K)
            for _ in range(passes):
                self._advance(self._kstep)
            for _ in range(singles):
                self._advance(self._step)
            return
        cfg = self.cfg
        if self.static_solid:
            solid = self._static_solid_operands()
            passes, singles = divmod(n, TEMPORAL_K)
            for k, m in ((TEMPORAL_K, passes), (1, singles)):
                sstep = make_static_step_fn(cfg, solid, k)
                for _ in range(m):
                    self._advance(sstep)
            return
        periodic = bool(cfg.wrap_lx or cfg.wrap_ly)
        done = 0
        while done < n:
            k = min(BIN_CADENCE, n - done)
            d = self.state.disks
            gparent = gaxes = None
            xb, actb = d.x, d.active
            if periodic:
                # wrap and select ghosts only here, at the rebuild: the
                # selection carries the lists' BIN_MARGIN slack
                xw, aug, gparent, gaxes, govf = imb.periodic_ghosts(
                    d.x, d.v, d.omega, d.r, d.active, cfg, margin=BIN_MARGIN)
                d = d._replace(x=xw)
                xb, actb = aug[0], aug[4]
                self.state = self.state._replace(
                    disks=d, overflow=torch.maximum(self.state.overflow, govf))
            lists, counts, entry_slots, bovf = stamp.build_tile_lists(
                xb, actb, cfg, margin=BIN_MARGIN)
            self.state = self.state._replace(
                overflow=torch.maximum(self.state.overflow, bovf))
            tl = (lists, counts, entry_slots, d.x, gparent, gaxes)
            ck = cfg.coupling_k
            nwin, rem = divmod(k, ck)
            if nwin:
                wstep = make_step_fn(cfg, self.grid, tl, self.dem_axis,
                                     coupling_k=ck, dem_mode=self.dem_mode)
                for _ in range(nwin):
                    self._advance(wstep)
            if rem:
                stepfn = make_step_fn(cfg, self.grid, tl, self.dem_axis,
                                      dem_mode=self.dem_mode)
                for _ in range(rem):
                    self._advance(stepfn)
            done += k

    def _static_solid_operands(self) -> torch.Tensor:
        """The static hoist's (3, ny, nx) solid stack, stamped once (K1)
        from the fixed disks at rest with their periodic ghosts and
        cached: columns 0 and nx - 1 zeroed under Zou/He (the closures
        assume fluid there). The binning and ghost overflow is checked
        here, once, instead of per step."""
        if self._solid_stack is None:
            cfg = self.cfg
            d = self.state.disks
            x, v, om, r, act = d.x, d.v, d.omega, d.r, d.active
            ovf = _zero_i32(self.device)
            if cfg.wrap_lx or cfg.wrap_ly:
                _, (x, v, om, r, act), _, _, ovf = imb.periodic_ghosts(
                    x, v, om, r, act, cfg)
            tile_data, counts, _, bovf = stamp.bin_disks_to_tiles(
                x, v, om, r, act, cfg)
            solid = stamp.stamp_fields(tile_data, counts, cfg)
            if cfg.bc_west == "inlet":
                solid[:, :, 0].zero_()
                solid[:, :, -1].zero_()
            if int(torch.maximum(ovf, bovf)) != 0:
                raise ValueError(
                    "static-solid binning overflow: raise cfg.tile_cap "
                    "(or cfg.ghost_cap for periodic obstacle arrays)")
            self._solid_stack = solid
        return self._solid_stack

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

        state = state_from_numpy(d, self.device)
        want = fused_fluid.storage_dtype(self.cfg)
        if state.f.dtype != want:
            raise ValueError(f"load_state: f is {state.f.dtype}, but "
                             f"f_storage={self.cfg.f_storage!r} and dtype="
                             f"{self.cfg.dtype!r} store it as {want}")
        self.state = state
        self._f_spare = torch.empty_like(self.state.f)
        self._solid_stack = None  # the loaded disks may sit elsewhere

    # --- observation ---
    def macroscopic(self):
        """(rho, ux, uy) as numpy arrays."""
        rho, ux, uy = lbm.moments(lbm.from_storage(self.state.f, self.cfg),
                                  self.cfg.gx, self.cfg.gy)
        return rho.cpu().numpy(), ux.cpu().numpy(), uy.cpu().numpy()

    def disk_arrays(self):
        return {k: v.cpu().numpy()
                for k, v in self.state.disks._asdict().items()}

    def _coupling_view(self):
        """(x, v, omega, r, active) of the disks with their periodic
        ghosts appended (fresh selection, margin 0), and the ghosts'
        parents (None without periodic axes)."""
        cfg = self.cfg
        d = self.state.disks
        view = (d.x, d.v, d.omega, d.r, d.active)
        if cfg.max_disks > 0 and (cfg.wrap_lx or cfg.wrap_ly):
            _, view, gparent, _, _ = imb.periodic_ghosts(*view, cfg)
            return view, gparent
        return view, None

    def solid_fraction(self):
        """The clipped solid fraction eps (ny, nx) of the current disks,
        ghosts included, as a numpy array."""
        (x, v, om, r, act), _ = self._coupling_view()
        eps, _, _ = imb.stamp_solid_fraction(x, v, om, r, act, self.cfg)
        return torch.clamp(eps, 0.0, 1.0).cpu().numpy()

    def hydro_forces(self):
        """(F (N, 2), T (N,)) per disk from one evaluation of the plain
        IMB functions on the CURRENT state (observation only; the steps
        compute theirs in the kernels, and the static hoist computes
        none): the drag on fixed obstacles. Ghost forces fold into their
        parents; Zou/He columns are masked as the steps mask them. Zeros
        for a pure-fluid scene."""
        cfg = self.cfg
        d = self.state.disks
        if self.grid is None:
            return (torch.zeros_like(d.x).cpu().numpy(),
                    torch.zeros_like(d.r).cpu().numpy())
        (x, v, om, r, act), gparent = self._coupling_view()
        eps, usx, usy = imb.stamp_solid_fraction(x, v, om, r, act, cfg)
        if cfg.bc_west == "inlet":
            eps, usx, usy = imb.mask_open_columns(eps, usx, usy)
        f_phys = lbm.from_storage(self.state.f, cfg)
        _, phix, phiy = imb.collide_imb(f_phys, eps, usx, usy, cfg)
        fh, th = imb.reduce_hydro_forces(x, r, act, eps, phix, phiy, cfg)
        if gparent is not None:
            fh, th = imb.fold_ghost_forces(fh, th, gparent, d.x.shape[0])
        return fh.cpu().numpy(), th.cpu().numpy()
