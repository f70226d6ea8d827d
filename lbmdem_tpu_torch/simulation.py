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
kernel takes its plain PyTorch version (float32 or float64).
`kernels_supported` states the kernels' limits; `use_kernels=True` (the
default) on a config past them raises ValueError before any launch.

With use_kernels=False every step is the JAX package's plain step
(`make_step_fn(use_pallas=False)`) on tensors of any device and dtype:
the coupled step stamps, collides, streams, bounces back and reduces
with `ops/imb.py` and `ops/lbm.py` and moves the disks with the
cell-list `dem.dem_subcycle` (or the drift), one step at a time with
no Verlet cadence; pure fluid is `lbm.step_pure_fluid`. That path runs
float64 on the card, lattices the stamp tiles cannot take, and coupled
scenes without disks (max_disks > 0), as the JAX package's default
path does.

Paranoid mode (cfg.paranoia) validates the state on the device
(`state_ok`) and freezes it at the first failing step
(`paranoid_commit`): "step" after every step, "chunk" at the kernel
chunks' boundaries (a cadence block, a K7 pass); pure fluid on the
kernels validates once per K5 pass in either mode, and the plain path
after every step. `run` raises SimulationDiverged after the chunk.

With `mesh` (parallel.make_mesh) the lattice is sharded over the mesh's
devices and the disks replicated per device, as the JAX Simulation(mesh=
...) does: coupled scenes run the sharded Verlet-cadence chunk (K1 on
each shard's canvas, K2 pre-haloed, K3 per replica; with coupling_k > 1
its windows, K1 and K6 pre-haloed per shard and K3w per replica), the
static hoist K7 pre-haloed per shard over solid windows stamped once,
pure fluid K5 on pre-haloed shards in blocks of TEMPORAL_K steps and
then K4 singles, and use_kernels=False the plain sharded step. Paranoid
mode validates every shard and takes the minimum over the shards: per
step (paranoia="step", on the per-step sharded step), or per cadence
block and per K7 pass ("chunk"). `state` then gathers the global state
(and setting it shards one); the observation methods work on the
gathered state. bf16 storage on a mesh takes 16-row halos and the
kernel path. A mesh may span the processes of a torch.distributed group
(`parallel.init_distributed`, then `make_mesh`): each rank runs the same
program on its own shards and a replica of the disks, `state` is then a
collective gather (every rank calls it) and `device` is the rank's first
device.

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
                                  imb, lbm, slab_dem)
from lbmdem_tpu_torch.ops import stamp
from lbmdem_tpu_torch.ops.dem import DemGrid, DiskState, make_disk_state
from lbmdem_tpu_torch.utils import profiling

# Verlet-style cadence for the stamp tile lists (as the JAX driver)
BIN_CADENCE = 8
BIN_MARGIN = 2

# Pure-fluid temporal blocking: steps per K5 pass (the JAX driver's
# choice, kept so both packages split a run alike)
TEMPORAL_K = 4


class SimulationDiverged(RuntimeError):
    """Raised by paranoid mode; .step is the first failing step."""

    def __init__(self, msg: str, step: int):
        super().__init__(msg)
        self.step = step


class FluidState(NamedTuple):
    """Pure-fluid state: the distributions alone (the JAX FluidState)."""

    f: torch.Tensor  # (9, ny, nx)


class SimState(NamedTuple):
    """Full simulation state (the JAX `SimState` fields); the counters
    are 0-dim int32 tensors on the state's device."""

    f: torch.Tensor  # (9, ny, nx) distributions
    disks: DiskState
    step: torch.Tensor
    overflow: torch.Tensor  # max binning/slab overflow seen
    n_contacts: torch.Tensor  # contacts at the last step
    # first step whose state failed paranoid validation (-1 = healthy);
    # once set, every later commit keeps the state frozen there
    fail_step: torch.Tensor


def state_ok(cfg: SimConfig, new: SimState) -> torch.Tensor:
    """() bool on the state's device: all f finite, rho > 0 everywhere
    (summed in float32, as the JAX check does), disk state finite, no
    capacity overflow."""
    ok = torch.isfinite(new.f).all()
    # bf16 storage holds g = f - w*rho0: rho = sum(g) + rho0
    rho = torch.sum(new.f.to(torch.float32), dim=0)
    if cfg.f_storage == "bfloat16":
        rho = rho + cfg.rho0
    ok = ok & (rho > 0.0).all()
    if cfg.max_disks > 0:
        d = new.disks
        ok = (ok & torch.isfinite(d.x).all() & torch.isfinite(d.v).all()
              & torch.isfinite(d.omega).all())
    return ok & (new.overflow == 0)


def paranoid_commit(old: SimState, new: SimState, ok) -> SimState:
    """Freeze-on-failure commit, on the device: once old.fail_step is
    set every commit returns `old`; an ok=False commit records new.step
    as the failing step. f is selected into new.f's buffer (the step's
    output), so the two f buffers keep trading places."""
    frozen = old.fail_step >= 0

    def sel(o, n):
        return torch.where(frozen, o, n)

    f = torch.where(frozen, old.f, new.f, out=new.f)
    disks = DiskState(*(sel(o, n) for o, n in zip(old.disks, new.disks)))
    fail = torch.where(frozen, old.fail_step,
                       torch.where(ok, -1, new.step).to(torch.int32))
    return SimState(f=f, disks=disks, step=sel(old.step, new.step),
                    overflow=sel(old.overflow, new.overflow),
                    n_contacts=sel(old.n_contacts, new.n_contacts),
                    fail_step=fail)


def paranoid_wrap(step: Callable, cfg: SimConfig) -> Callable:
    """The step followed by state_ok and paranoid_commit: the step runs
    unconditionally, and after the first failure the state stays frozen
    at the failing step for inspection."""

    def wrapped(state: SimState, f_out: torch.Tensor) -> SimState:
        new = step(state, f_out)
        return paranoid_commit(state, new, state_ok(cfg, new))

    return wrapped


def kernels_supported(cfg: SimConfig, device="cuda",
                      mesh=None) -> Optional[str]:
    """None if the kernel path takes the derived config `cfg` (window
    and tile_cap set, as `derive_config` leaves them) on `device`, else
    the reason. On the card the kernels take f32 or shifted-bf16 storage
    of a float32 config; on any device a coupled scene needs the stamp
    window plus the 2 BIN_MARGIN cells of the Verlet cadence to fit one
    stamp tile, and disks to size the tiles' capacity from. Unlike the
    JAX package's pallas_supported there is no 8 x 128 lattice
    alignment on one device.

    With `mesh` (as pallas_supported with one): the lattice must tile
    the mesh, each shard be a multiple of 8 rows (16 on bf16 storage,
    whose frames carry 16 halo rows) and 128 columns (the pre-haloed
    kernels' halos), and the stamp window plus the margin fit the stamp
    tile of the shard's canvas (parallel/_kernel_step). K6 and K7 read
    K2's frame and solid window, whose 8 solid halo rows hold the
    dependency cone of every coupling_k the config takes (1..8) and of
    the static hoist's TEMPORAL_K, so they need nothing more. One device
    keeps its looser rule (no row granule)."""
    if mesh is not None:
        device = mesh.replicas[0]
    if torch.device(device).type == "cuda" and cfg.dtype != "float32":
        return (f"the kernels take float32 or bfloat16 storage "
                f"(dtype={cfg.dtype})")
    ny, nx = cfg.ny, cfg.nx
    if mesh is not None:
        from lbmdem_tpu_torch.parallel._kernel_step import canvas_pads

        ny_sh, nx_sh = mesh.shape["y"], mesh.shape["x"]
        if cfg.ny % ny_sh or cfg.nx % nx_sh:
            return (f"lattice {cfg.ny}x{cfg.nx} does not tile the "
                    f"{ny_sh}x{nx_sh} mesh")
        h, w = cfg.ny // ny_sh, cfg.nx // nx_sh
        if h % 8 or w % 128:
            return (f"the pre-haloed kernels need per-shard ny%8==0 and "
                    f"nx%128==0 (shard {h}x{w})")
        if cfg.f_storage == "bfloat16" and h % 16:
            return (f"f_storage='bfloat16' needs per-shard ny%16==0 (the "
                    f"16-row bf16 halo; got {h})")
        if cfg.max_disks > 0:
            pady, padx = canvas_pads(h, nx_sh > 1)
            ny, nx = h + 2 * pady, w + 2 * padx
    if cfg.max_disks == 0:
        return None
    th, tw = stamp.tile_shape(cfg.replace(ny=ny, nx=nx))
    margin = 2 * BIN_MARGIN
    if cfg.window + margin > min(th, tw):
        canvas = " stamp-canvas" if mesh is not None else ""
        return (f"stamp window {cfg.window} (+{margin} Verlet margin) "
                f"exceeds the {th}x{tw}{canvas} stamp tile; disks too large "
                f"for this lattice")
    if cfg.tile_cap <= 0:
        return ("a coupled scene without disks (max_disks > 0, no "
                "particles): the stamp tiles' capacity is sized from them")
    return None


def derive_config(cfg: SimConfig, disks: Sequence[DiskSpec],
                  use_kernels: bool = True):
    """(derived cfg, DEM grid or None): the stamp window and disk
    capacity from the disks, the DEM grid (at r = 1 for a coupled scene
    without disks), on the kernel path the stamp tiles' capacity, and
    on periodic axes the ghost capacity - the JAX Simulation's
    derivation."""
    grid = None
    if disks:
        r_max = max(d.r for d in disks)
        if cfg.window <= 0:
            cfg = cfg.replace(window=window_for_radius(r_max))
        if cfg.max_disks < len(disks):
            cfg = cfg.replace(max_disks=len(disks))
        grid = DemGrid.build(cfg, r_max)
    elif cfg.max_disks > 0:
        grid = DemGrid.build(cfg, 1.0)
        if cfg.window <= 0:
            cfg = cfg.replace(window=window_for_radius(1.0))
    if use_kernels and disks and cfg.tile_cap <= 0:
        th, tw = stamp.tile_shape(cfg)
        cfg = cfg.replace(tile_cap=stamp.default_tile_cap(
            th, tw, min(d.r for d in disks), cfg.window + 2 * BIN_MARGIN))
    cfg.validate_periodic_dem()
    if (cfg.max_disks > 0 and (cfg.wrap_lx or cfg.wrap_ly)
            and cfg.ghost_cap <= 0):
        cfg = cfg.replace(ghost_cap=imb.default_ghost_cap(
            cfg.max_disks, cfg, BIN_MARGIN))
    return cfg, grid


def _at_rest(disks: Sequence[DiskSpec]) -> bool:
    return all(d.vx == 0.0 and d.vy == 0.0 and d.omega == 0.0 for d in disks)


def _zero_i32(device, value: int = 0) -> torch.Tensor:
    return torch.full((), value, dtype=torch.int32, device=device)


def make_step_fn(cfg: SimConfig, grid: Optional[DemGrid], tile_lists=None,
                 dem_axis: str = "y", temporal_k: int = 1,
                 coupling_k: int = 1, dem_mode: str = "subcycle",
                 use_kernels: bool = True) -> Callable:
    """The step: step(state, f_out) -> SimState, wrapped in
    paranoid_wrap when cfg.paranoia is set.

    use_kernels=False: the plain step (`make_plain_step_fn`), one step
    per call; the other arguments but grid and dem_mode are unused.

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
    if not use_kernels:
        step = make_plain_step_fn(cfg, grid, dem_mode)
    else:
        step = _kernel_step_fn(cfg, grid, tile_lists, dem_axis, temporal_k,
                               coupling_k, dem_mode)
    return paranoid_wrap(step, cfg) if cfg.paranoia else step


def _advance_disks(d: DiskState, fh, th, grid: DemGrid, cfg: SimConfig,
                   dem_mode: str):
    """One step of disk motion on the cell list: the DEM subcycle, or
    under dem_mode "drift" (every disk fixed) the prescribed translation
    and rotation over dt = 1, with no contact machinery."""
    if dem_mode == "drift":
        act = d.active.to(d.x.dtype)
        z = _zero_i32(d.x.device)
        return d._replace(x=d.x + d.v * act[:, None],
                          theta=d.theta + d.omega * act), z, z
    return dem.dem_subcycle(d, fh, th, grid, cfg)


def window_disks(d: DiskState, forces, grid: DemGrid, cfg: SimConfig,
                 dem_axis: str, dem_mode: str, n_contacts):
    """A coupling_k window's disk motion from its inner steps' (F, T):
    K3w chained over the forces on one slab build, or past the slab gate
    (and under the drift) one cell-list advance per inner step; then the
    Zou/He cull. Returns (d, overflow, n_contacts). The one-device and
    the mesh window steps share it."""
    if dem_mode == "subcycle" and slab_dem.slab_supported(
            grid, dem_axis, kt=cfg.kt > 0.0, device=d.x.device):
        d, ovf, nc = slab_dem.dem_subcycle_window(d, forces, grid, cfg,
                                                  dem_axis)
    else:
        ovf, nc = _zero_i32(d.x.device), n_contacts
        for fh, th in forces:
            d, ovf_t, nc = _advance_disks(d, fh, th, grid, cfg, dem_mode)
            ovf = torch.maximum(ovf, ovf_t)
    if cfg.bc_west == "inlet":
        d = dem.cull_open_boundaries(d, cfg)
    return d, ovf, nc


def make_plain_step_fn(cfg: SimConfig, grid: Optional[DemGrid],
                       dem_mode: str = "subcycle") -> Callable:
    """The JAX package's plain step (its make_step_fn with use_pallas
    False) on tensors of any device and dtype: pure fluid
    (`lbm.step_pure_fluid`, grid None), or the coupled step - periodic
    ghosts, `imb.stamp_solid_fraction`, `mask_open_columns` under
    Zou/He, `imb.collide_imb`, `lbm.stream`, `apply_bounce_back`,
    `apply_open_boundaries`, `imb.reduce_hydro_forces`, the ghost fold,
    the cell-list DEM subcycle or the drift, `cull_open_boundaries`.
    Storage converts at the step's ends (bf16 round trip). It returns
    new tensors; `f_out` is unused."""
    if grid is None:

        def fluid_step(state: SimState, f_out=None) -> SimState:
            f = lbm.step_pure_fluid(lbm.from_storage(state.f, cfg), cfg)
            return state._replace(f=lbm.to_storage(f, cfg),
                                  step=state.step + 1)

        return fluid_step

    periodic = bool(cfg.wrap_lx or cfg.wrap_ly)
    open_cull = cfg.bc_west == "inlet"

    def step(state: SimState, f_out=None) -> SimState:
        d = state.disks
        n_real = d.x.shape[0]
        gparent = None
        if periodic:
            xw, aug, gparent, _, bovf = imb.periodic_ghosts(
                d.x, d.v, d.omega, d.r, d.active, cfg)
            d = d._replace(x=xw)
        else:
            aug = (d.x, d.v, d.omega, d.r, d.active)
            bovf = _zero_i32(d.x.device)
        xa, va, oma, ra, acta = aug
        eps, usx, usy = imb.stamp_solid_fraction(xa, va, oma, ra, acta, cfg)
        if open_cull:
            eps, usx, usy = imb.mask_open_columns(eps, usx, usy)
        f_phys = lbm.from_storage(state.f, cfg)
        fpost, phix, phiy = imb.collide_imb(f_phys, eps, usx, usy, cfg)
        fnew = lbm.to_storage(lbm.apply_open_boundaries(
            lbm.apply_bounce_back(lbm.stream(fpost), fpost, cfg), cfg), cfg)
        fh, th = imb.reduce_hydro_forces(xa, ra, acta, eps, phix, phiy, cfg)
        if periodic:
            fh, th = imb.fold_ghost_forces(fh, th, gparent, n_real)
        disks, ovf, nc = _advance_disks(d, fh, th, grid, cfg, dem_mode)
        if open_cull:
            disks = dem.cull_open_boundaries(disks, cfg)
        return SimState(
            f=fnew, disks=disks, step=state.step + 1,
            overflow=torch.maximum(state.overflow, torch.maximum(ovf, bovf)),
            n_contacts=nc, fail_step=state.fail_step,
        )

    return step


def _kernel_step_fn(cfg: SimConfig, grid: Optional[DemGrid], tile_lists,
                    dem_axis: str, temporal_k: int, coupling_k: int,
                    dem_mode: str) -> Callable:
    """make_step_fn's kernel path (its docstring)."""
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
        with profiling.span("lbmdem.glue.hydro"):
            fh, th = stamp.gather_partials(partials, entry_slots, dtype)
            if periodic:
                fh, th = imb.fold_ghost_forces(fh, th, gparent, n_real)
        return fh, th

    def advance_disks(d: DiskState, fh, th):
        """One step of disk motion: the slab DEM subcycle, past the slab
        gate the cell-list subcycle, or the drift."""
        if use_slab_dem(d):
            return slab_dem.dem_subcycle(d, fh, th, grid, cfg, dem_axis)
        return _advance_disks(d, fh, th, grid, cfg, dem_mode)

    if coupling_k > 1:

        def window_step(state: SimState, f_out: torch.Tensor) -> SimState:
            n_real = state.disks.x.shape[0]
            # window-start coupling inputs, frozen for the k inner steps
            with profiling.span("lbmdem.glue.inputs"):
                d, tile_data, counts, entry_slots, bovf, gparent = (
                    coupling_inputs(state.disks))
            solid = stamp_solid(tile_data, counts)
            fnew, parts = fused_lbm.fused_step_imb_reduce_multi(
                state.f, solid, tile_data, counts, cfg, coupling_k, f_out)
            forces = [hydro(parts[t], entry_slots, gparent, n_real, d.x.dtype)
                      for t in range(coupling_k)]
            disks, ovf, nc = window_disks(d, forces, grid, cfg, dem_axis,
                                          dem_mode, state.n_contacts)
            return SimState(
                f=fnew, disks=disks, step=state.step + coupling_k,
                overflow=torch.maximum(state.overflow,
                                       torch.maximum(ovf, bovf)),
                n_contacts=nc, fail_step=state.fail_step,
            )

        return window_step

    def step(state: SimState, f_out: torch.Tensor) -> SimState:
        n_real = state.disks.x.shape[0]
        with profiling.span("lbmdem.glue.inputs"):
            d, tile_data, counts, entry_slots, bovf, gparent = (
                coupling_inputs(state.disks))
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
    disks at rest never move). Under paranoia="chunk" (the hoist's only
    paranoid mode) each pass is validated at its end."""

    def static_step(state: SimState, f_out: torch.Tensor) -> SimState:
        fnew = fused_static.fused_step_imb_static_multi(state.f, solid, cfg,
                                                        k, f_out)
        return state._replace(f=fnew, step=state.step + k)

    return paranoid_wrap(static_step, cfg) if cfg.paranoia else static_step


def static_solid_stack(cfg: SimConfig, d: DiskState) -> torch.Tensor:
    """The static hoist's (3, ny, nx) solid stack of fixed disks at rest,
    stamped once (K1) with their periodic ghosts: columns 0 and nx - 1
    zeroed under Zou/He (the closures assume fluid there). The binning
    (margin 0) and ghost overflow is checked here, once, instead of per
    step."""
    x, v, om, r, act = d.x, d.v, d.omega, d.r, d.active
    ovf = _zero_i32(x.device)
    if cfg.wrap_lx or cfg.wrap_ly:
        _, (x, v, om, r, act), _, _, ovf = imb.periodic_ghosts(
            x, v, om, r, act, cfg)
    tile_data, counts, _, bovf = stamp.bin_disks_to_tiles(x, v, om, r, act,
                                                          cfg)
    solid = stamp.stamp_fields(tile_data, counts, cfg)
    if cfg.bc_west == "inlet":
        solid[:, :, 0].zero_()
        solid[:, :, -1].zero_()
    if profiling.device_wait("static_binning", int,
                             torch.maximum(ovf, bovf)) != 0:
        raise ValueError(
            "static-solid binning overflow: raise cfg.tile_cap "
            "(or cfg.ghost_cap for periodic obstacle arrays)")
    return solid


class Simulation:
    """User-facing driver: owns the config, the state and two f buffers.

    It runs on the card (device="cuda", the default) unless it is given
    device="cpu", where every kernel takes its plain version; it raises
    RuntimeError when asked for the card and none is present.
    use_kernels=False takes the plain path (the JAX package's
    use_pallas=False); use_kernels=True raises ValueError where
    `kernels_supported` names a reason."""

    def __init__(self, cfg: SimConfig, disks: Sequence[DiskSpec] = (),
                 device="cuda", use_kernels: bool = True, mesh=None):
        disks = list(disks)
        self.mesh = mesh
        if mesh is not None:
            self._refuse_on_mesh(cfg, mesh, use_kernels)
            device = mesh.replicas[0]  # this rank's first device
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "Simulation: no CUDA device is available "
                "(torch.cuda.is_available() is False); pass device='cpu' to "
                "run the plain PyTorch versions on the CPU")
        cfg, self.grid = derive_config(cfg, disks, use_kernels)
        if use_kernels:
            reason = kernels_supported(cfg, self.device, mesh)
            if reason is not None:
                raise ValueError(f"use_kernels=True unsupported: {reason}")
        if cfg.coupling_k > 1 and cfg.max_disks > 0:
            # a window is a kernel chunk structure; step() stays exact
            # per-step coupling
            if not use_kernels:
                raise ValueError(
                    "coupling_k > 1 needs use_kernels=True (it is a fused-"
                    "kernel chunk structure)")
            if cfg.paranoia_mode == "step":
                raise ValueError(
                    "coupling_k > 1 conflicts with paranoia='step' "
                    "(per-step validation forces per-step coupling); "
                    "use paranoia='chunk'")
        self.cfg = cfg
        self.use_kernels = use_kernels
        self.dem_axis = slab_dem.choose_axis(disks, cfg)
        # every disk fixed: no contact mechanics, positions drift at the
        # prescribed v/omega; also at rest: binning and stamp are constant
        self.dem_mode = ("drift" if disks and all(d.fixed for d in disks)
                         else "subcycle")
        self.static_solid = self.dem_mode == "drift" and _at_rest(disks)
        self._solid_stack = None  # _static_solid_operands' cache
        f = lbm.to_storage(lbm.init_equilibrium(cfg, self.device), cfg)
        self.state = SimState(
            f=f, disks=make_disk_state(disks, cfg, device=self.device),
            step=_zero_i32(self.device), overflow=_zero_i32(self.device),
            n_contacts=_zero_i32(self.device),
            fail_step=_zero_i32(self.device, -1),
        )
        self.mlups_last = 0.0
        if mesh is None:
            # the second f buffer: each kernel step writes into it and the
            # two swap (on a mesh, one per shard)
            self._f_spare = torch.empty_like(f)
        else:
            from lbmdem_tpu_torch.parallel import make_sharded_step

            self._step = make_sharded_step(
                cfg, self.grid, mesh, use_kernels, dem_axis=self.dem_axis,
                dem_mode=self.dem_mode)
            if self.grid is None and use_kernels:
                self._kstep = make_sharded_step(cfg, None, mesh, True,
                                                temporal_k=TEMPORAL_K)
            return
        self._step = make_step_fn(cfg, self.grid, dem_axis=self.dem_axis,
                                  dem_mode=self.dem_mode,
                                  use_kernels=use_kernels)
        if self.grid is None and use_kernels:
            self._kstep = make_step_fn(cfg, None, temporal_k=TEMPORAL_K)

    @staticmethod
    def _refuse_on_mesh(cfg: SimConfig, mesh, use_kernels: bool) -> None:
        """Raise for what a mesh does not take, before any device work:
        a mesh that is not a Mesh, and bf16 storage on the plain sharded
        step (the JAX package's refusal: it consumes raw f32 f)."""
        from lbmdem_tpu_torch.parallel import Mesh

        if not isinstance(mesh, Mesh):
            raise TypeError(f"mesh must be a parallel.Mesh (make_mesh), got "
                            f"{type(mesh).__name__}")
        if cfg.f_storage == "bfloat16" and not use_kernels:
            raise ValueError(
                "f_storage='bfloat16' on a mesh needs use_kernels=True (the "
                "plain sharded step consumes raw f32 f)")

    # --- the state (gathered from the shards on a mesh) ---
    @property
    def state(self) -> SimState:
        """The SimState; on a mesh the global state gathered from the
        shards and the first replica (a copy: set `state` to change it;
        across processes a collective that every rank calls)."""
        if self.mesh is None:
            return self._state
        from lbmdem_tpu_torch.parallel import unshard

        return unshard(self._state, self.mesh)

    @state.setter
    def state(self, value: SimState) -> None:
        if self.mesh is None:
            self._state = value
            return
        from lbmdem_tpu_torch.parallel.sharding import (empty_like_shards,
                                                        shard_state)

        self._state = shard_state(value, self.mesh)
        self._f_spare = empty_like_shards(self._state.f)

    # --- stepping ---
    def _advance(self, stepfn: Callable) -> None:
        with profiling.span("lbmdem.step"):
            old_f = self._state.f
            self._state = stepfn(self._state, self._f_spare)
            self._f_spare = old_f

    def step(self) -> None:
        """One step (coupled: with a fresh binning, no cadence; all-fixed
        scenes: the per-step drift step, static or not)."""
        self._advance(self._step)

    def _run_chunk(self, n: int) -> None:
        """n steps. The plain path takes them one at a time. On the
        kernels: Verlet-cadence blocks of BIN_CADENCE steps (the JAX
        single-device coupled chunk): each block wraps the positions and
        selects the periodic ghosts with BIN_MARGIN slack, rebuilds the
        tile lists with the same slack and counts both overflows, then
        takes its b steps as b // coupling_k windows and b % coupling_k
        single steps; under paranoia="chunk" the block is validated at
        its end. The static hoist (all disks fixed at rest, unless
        paranoia="step") instead takes n // TEMPORAL_K K7 passes of
        TEMPORAL_K steps and n % TEMPORAL_K of one step over the solid
        stack stamped once. Pure fluid: n // TEMPORAL_K K5 passes, then
        n % TEMPORAL_K K4 steps (the JAX pure-fluid chunk). On a mesh the
        coupled chunks are parallel/_kernel_step's (the cadence chunk with
        its windows, the static chunk), and paranoia="step" takes the
        per-step sharded step."""
        if not self.use_kernels or (self.mesh is not None
                                    and self.grid is not None
                                    and self.cfg.paranoia_mode == "step"):
            # on a mesh paranoia="step" validates at the sharded step's
            # boundary (the JAX paranoid_wrap of the sharded step)
            for _ in range(n):
                self._advance(self._step)
            return
        if self.mesh is not None and self.grid is not None:
            from lbmdem_tpu_torch.parallel._kernel_step import (
                make_sharded_coupled_chunk, make_sharded_static_chunk,
            )

            if self.static_solid:
                wins = self._static_solid_operands()
                with profiling.span("lbmdem.static.chunk"):
                    chunk = make_sharded_static_chunk(self.cfg, self.mesh, n,
                                                      wins)
                    self._state, self._f_spare = chunk(self._state,
                                                       self._f_spare)
                return
            chunk = make_sharded_coupled_chunk(
                self.cfg, self.grid, self.mesh, n, self.dem_axis,
                self.dem_mode)
            self._state, self._f_spare = chunk(self._state, self._f_spare)
            return
        if self.grid is None:
            passes, singles = divmod(n, TEMPORAL_K)
            for _ in range(passes):
                self._advance(self._kstep)
            for _ in range(singles):
                self._advance(self._step)
            return
        cfg = self.cfg
        if self.static_solid and cfg.paranoia_mode != "step":
            solid = self._static_solid_operands()
            passes, singles = divmod(n, TEMPORAL_K)
            with profiling.span("lbmdem.static.chunk"):
                for k, m in ((TEMPORAL_K, passes), (1, singles)):
                    sstep = make_static_step_fn(cfg, solid, k)
                    for _ in range(m):
                        self._advance(sstep)
            return
        # paranoia="chunk": validate once per cadence block instead of
        # per step (the inner steps run unwrapped)
        par_chunk = cfg.paranoia_mode == "chunk"
        step_cfg = cfg.replace(paranoia=False) if par_chunk else cfg
        done = 0
        while done < n:
            k = min(BIN_CADENCE, n - done)
            with profiling.span("lbmdem.block"):
                self._run_block(k, step_cfg, par_chunk)
            done += k

    def _run_block(self, k: int, step_cfg: SimConfig,
                   par_chunk: bool) -> None:
        """One Verlet-cadence block of k coupled steps (`_run_chunk`)."""
        cfg = self.cfg
        if par_chunk:
            # the block's steps overwrite both f buffers: keep the
            # block-start f for a commit that stays frozen
            st_in = self.state._replace(f=self.state.f.clone())
        d = self.state.disks
        gparent = gaxes = None
        xb, actb = d.x, d.active
        with profiling.span("lbmdem.block.bin"):
            if cfg.wrap_lx or cfg.wrap_ly:
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
            with profiling.span("lbmdem.block.closures"):
                wstep = make_step_fn(step_cfg, self.grid, tl, self.dem_axis,
                                     coupling_k=ck, dem_mode=self.dem_mode)
            for _ in range(nwin):
                self._advance(wstep)
        if rem:
            with profiling.span("lbmdem.block.closures"):
                stepfn = make_step_fn(step_cfg, self.grid, tl, self.dem_axis,
                                      dem_mode=self.dem_mode)
            for _ in range(rem):
                self._advance(stepfn)
        if par_chunk:
            self.state = paranoid_commit(st_in, self.state,
                                         state_ok(cfg, self.state))

    def _static_solid_operands(self):
        """The static hoist's solid stack (`static_solid_stack`), or on a
        mesh the shards' solid windows (`_kernel_step.
        sharded_static_solid`), stamped once and cached (again after
        `load_state`); each stamp is counted (`profiling.static_stamped`)."""
        if self._solid_stack is None:
            with profiling.span("lbmdem.static.stamp"):
                if self.mesh is None:
                    self._solid_stack = static_solid_stack(self.cfg,
                                                           self.state.disks)
                else:
                    from lbmdem_tpu_torch.parallel._kernel_step import (
                        sharded_static_solid,
                    )

                    self._solid_stack = sharded_static_solid(
                        self.cfg, self.mesh, self._state)
            profiling.static_stamped()
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
        with profiling.span("lbmdem.run"):
            while done < steps:
                n = min(interval, steps - done)
                self._run_chunk(n)
                done += n
                if self.cfg.paranoia:
                    self.check_health()
                if callback is not None:
                    profiling.device_wait("callback", self._sync)
                    with profiling.span("lbmdem.callback"):
                        callback(self)
            profiling.device_wait("run_end", self._sync)
        dt_s = time.perf_counter() - t0
        self.mlups_last = self.cfg.nx * self.cfg.ny * steps / dt_s / 1e6
        return self.mlups_last

    def check_health(self) -> None:
        """Raise SimulationDiverged if paranoid validation tripped (one
        read of fail_step from the device; on a mesh the first replica's,
        which every replica and rank shares)."""
        st = self._state
        fail_step, overflow = ((st.fail_step, st.overflow) if self.mesh is None
                               else (st.fail_step[0], st.overflow[0]))
        fail = profiling.device_wait("health", int, fail_step)
        if fail >= 0:
            raise SimulationDiverged(
                f"paranoid check failed at step {fail}: non-finite f, "
                f"rho <= 0, non-finite disk state, or capacity overflow "
                f"(overflow={int(overflow)}); state frozen at "
                f"the failing step for inspection", fail)

    def _sync(self) -> None:
        devices = [self.device] if self.mesh is None else self.mesh.replicas
        for d in devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def load_state(self, d: dict) -> None:
        """Replace the state by one in the numpy form of
        `interop.state_to_numpy` (e.g. converted from the JAX package)."""
        from lbmdem_tpu_torch.interop import state_from_numpy

        # on a mesh through the CPU: each rank takes its own shards
        state = state_from_numpy(d, self.device if self.mesh is None
                                 else "cpu")
        want = fused_fluid.storage_dtype(self.cfg)
        if state.f.dtype != want:
            raise ValueError(f"load_state: f is {state.f.dtype}, but "
                             f"f_storage={self.cfg.f_storage!r} and dtype="
                             f"{self.cfg.dtype!r} store it as {want}")
        self.state = state
        if self.mesh is None:
            self._f_spare = torch.empty_like(state.f)
        self._solid_stack = None  # the loaded disks may sit elsewhere

    # --- observation ---
    def macroscopic(self):
        """(rho, ux, uy) as numpy arrays."""
        rho, ux, uy = lbm.moments(lbm.from_storage(self.state.f, self.cfg),
                                  self.cfg.gx, self.cfg.gy)
        return rho.cpu().numpy(), ux.cpu().numpy(), uy.cpu().numpy()

    def disk_arrays(self):
        """The disk state as numpy arrays (copies: a writer may hold
        them while the run goes on)."""
        return {k: v.to("cpu", copy=True).numpy()
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
