"""The kernel path on a lattice mesh: K4, K5 and K2 in their pre-haloed
modes, K1 on each shard's stamp canvas, K3 per replica.

Counterpart of the JAX package's `lbmdem_tpu/parallel/_pallas_step.py`,
on f32 and shifted-bf16 storage. Each step exchanges the shards'
pre-collision populations into frames of HY = 8 halo rows per side on
f32 and HY_BF16 = 16 on bf16 (the JAX row granules) and, on a mesh with
more than one column of shards ("yx" mode), HX = 128 halo columns per
side: x after y, so that the corner blocks hold the diagonal
neighbours' cells. The fused kernels run on the frames; the collide is
pointwise, so they collide the halo cells they need themselves. The
coupled kernels' solid window keeps 8 halo rows in both storages.

- Pure fluid: one step is K4 on the frame, then the walls of the shards
  at a global edge are fixed outside the kernel and the Zou/He closures
  applied there; a block of k steps is one K5 pass, which runs the walls
  and closures of the shard's edges itself at every inner step (the halo
  is the k-step dependency cone: one exchange feeds k steps). The
  fixups bounce back the post-collision populations that the kernel
  hands out for the interior's edge rows and columns (`edge_post`): the
  JAX path collides those rows again with the plain collide, whose
  division rounds otherwise on the card, and in 16 steps of the 4096^2
  column collapse that put the mesh 1e-5 from one device. On bf16 those
  populations are the kernel's shifted ones in f32, unrounded, and the
  bounce-back (shift-invariant: w_opp(i) = w_i) rounds once at the store,
  as the one-device kernel does; the Zou/He fixup runs in f32 on the
  stored shifted populations and rounds once
  (`apply_open_boundaries_sharded`).
- Coupled: the disks are binned and stamped (K1) on the shard's canvas,
  its frame padded by pady rows (the stamp tile's height) and, in "yx"
  mode, padx = 128 columns, so that a disk straddling the shard's edge
  stamps its whole window and the canvas's tiles align with the
  interior's. The interior tiles' binning (`stamp.remap_entry_slots`)
  and the canvas rows [pady - 8, pady + h + 8) feed K2. The disk records
  stay in global coordinates: the binning and K1 take the canvas's
  global offset as their origin, K2 the interior's (the JAX path shifts
  the records into canvas coordinates, which rounds positions in f32
  near the low global edges - y + 256 for y < 256 - and put the 4096^2
  column collapse on a mesh 1e-5 from one device in 16 steps). The
  per-disk forces are summed over the shards in mesh order on every
  replica, and each replica runs the DEM (K3, or the cell-list subcycle).
  The edge fixups take K2's own post-collision edge populations, as
  K4's do.

`make_sharded_coupled_chunk` drives n coupled steps in Verlet-cadence
blocks, as the single-device chunk does: every BIN_CADENCE steps the
replicas wrap their positions and select periodic ghosts, and each shard
rebuilds its canvas binning, with BIN_MARGIN cells of slack; travel past
the margin is counted into `overflow`.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from lbmdem_tpu_torch import lattice
from lbmdem_tpu_torch.config import SimConfig, WALL
from lbmdem_tpu_torch.ops import (fused_fluid, fused_lbm, fused_static, imb,
                                  lbm, slab_dem, stamp)
from lbmdem_tpu_torch.ops.dem import DemGrid
from lbmdem_tpu_torch.ops.fused_fluid import HX, HY, HY_BF16
from lbmdem_tpu_torch.parallel.sharding import (
    Mesh, MeshState, _inlet_rows, advance_replica,
    apply_open_boundaries_sharded, halo_moves, mask_open_edges,
    max_over_shards, mesh_state_ok, on_device, paranoid_commit_mesh,
    per_position, shard_dims, sum_over_shards,
)
from lbmdem_tpu_torch.utils import profiling

# stamp tile rows, the coupled lattice tile rows of the JAX chain
_CANVAS_ROWS = (256, 128, 64, 32, 16, 8)


def canvas_pads(h: int, two_d: bool):
    """(pady, padx) of a shard's stamp canvas: pady the largest stamp
    tile height that divides h (so the canvas's tiles are pady rows high
    and align with the interior's), padx one 128-column tile on a 2D
    mesh - the frame's x halo, so K2's solid window is a row slice of
    the canvas."""
    pady = next((t for t in _CANVAS_ROWS if h % t == 0), None)
    if pady is None:
        raise ValueError(f"shard height {h} is not a multiple of 8")
    return pady, (HX if two_d else 0)


def exchange(fs, mesh: Mesh) -> List[Optional[torch.Tensor]]:
    """(9, h, w) shards -> their (9, h + 2 hy, w [+ 256]) pre-collision
    frames (by position; None where another rank holds it): hy rows from
    the south and north neighbours (HY on f32 shards, HY_BF16 on bf16:
    keyed on the shards' dtype), then on a 2D mesh HX columns of the
    y-extended frames from the west and east neighbours - the y pass
    done first, so the corners carry the diagonal neighbours' cells.
    The ring wrap is the periodic boundary; the halo beyond a wall is
    never used. Copies on a card, device to device between cards, and
    point-to-point over the process group to a neighbour on another
    rank (`sharding.halo_moves`)."""
    two_d = mesh.shape["x"] > 1
    hx = HX if two_d else 0
    f0 = fs[mesh.positions()[0][0]]
    q, h, w = f0.shape
    hy = HY_BF16 if f0.dtype == torch.bfloat16 else HY

    def frame(p, iy, ix):
        fr = torch.empty((q, h + 2 * hy, w + 2 * hx), dtype=f0.dtype,
                         device=fs[p].device)
        fr[:, hy:hy + h, hx:hx + w] = fs[p]
        return fr

    frames = per_position(mesh, frame)

    def put(sl):
        def put_at(p, v):
            frames[p][sl] = v
        return put_at

    rows_s = (slice(None), slice(0, hy), slice(hx, hx + w))
    rows_n = (slice(None), slice(hy + h, None), slice(hx, hx + w))
    moves = []
    for p, iy, ix in mesh.all_positions():
        moves += [(p, mesh.index(iy - 1, ix), lambda r: fs[r][:, -hy:, :],
                   put(rows_s)),
                  (p, mesh.index(iy + 1, ix), lambda r: fs[r][:, :hy, :],
                   put(rows_n))]
    halo_moves(mesh, moves)
    if two_d:
        moves = []
        for p, iy, ix in mesh.all_positions():
            moves += [(p, mesh.index(iy, ix - 1),
                       lambda r: frames[r][:, :, w:w + HX],
                       put((slice(None), slice(None), slice(0, HX)))),
                      (p, mesh.index(iy, ix + 1),
                       lambda r: frames[r][:, :, HX:2 * HX],
                       put((slice(None), slice(None), slice(HX + w, None))))]
        halo_moves(mesh, moves)
    return frames


class _Sharded:
    """The per-shard pieces of the kernel path for (cfg, mesh): the edge
    fixups, the fluid step, the coupled step and the cadence rebuild."""

    def __init__(self, cfg: SimConfig, grid: Optional[DemGrid], mesh: Mesh,
                 dem_axis: str, dem_mode: str):
        self.cfg, self.grid, self.mesh = cfg, grid, mesh
        self.dem_axis, self.dem_mode = dem_axis, dem_mode
        self.h, self.w = h, w = shard_dims(cfg, mesh)
        if cfg.f_storage == "bfloat16" and h % HY_BF16:
            raise ValueError(f"f_storage='bfloat16' on a mesh needs per-shard "
                             f"ny%16==0 (the 16-row bf16 halo; got {h})")
        self.two_d = mesh.shape["x"] > 1
        self.mode = "yx" if self.two_d else "y"
        self.local_cfg = cfg.replace(ny=h, nx=w)
        self.coupled = cfg.max_disks > 0
        self.periodic = self.coupled and bool(cfg.wrap_lx or cfg.wrap_ly)
        ny_sh, nx_sh = mesh.shape["y"], mesh.shape["x"]
        # K5's edge flags per position: south, north, west, east, and the
        # shard's global row offset
        self.edges = [(int(iy == 0), int(iy == ny_sh - 1), int(ix == 0),
                       int(ix == nx_sh - 1), iy * h)
                      for _, iy, ix in mesh.all_positions()]
        # the local shards' rows of the inlet profile and the outlet
        # density, made once per shard (tensors: a division by a Python
        # float rounds otherwise on the card than the kernels' closures)
        inlet = cfg.bc_west == "inlet"
        dt = lbm.torch_dtype(cfg)
        self.u_rows = per_position(mesh, lambda p, iy, ix: _inlet_rows(
            cfg, iy, h, torch.empty(0, dtype=dt, device=mesh.devices[p]))
            if inlet else None)
        self.rho_o = per_position(mesh, lambda p, iy, ix: torch.full(
            (), cfg.rho_outlet or cfg.rho0, dtype=dt, device=mesh.devices[p])
            if inlet else None)
        if self.coupled:
            self.pady, self.padx = canvas_pads(h, self.two_d)
            self.canvas_cfg = cfg.replace(ny=h + 2 * self.pady,
                                          nx=w + 2 * self.padx)
            th, tw = stamp.tile_dims(self.canvas_cfg)
            if (th, tw) != (self.pady, 128) or w % 128:
                raise ValueError(
                    f"canvas stamp tiles {th}x{tw} do not align with the "
                    f"shard's {self.pady}x128 tiles (shard {h}x{w})")
            self.nty_c = self.canvas_cfg.ny // th
            self.ntx_c = self.canvas_cfg.nx // tw
            self.nty_i, self.ntx_i = h // th, w // tw
            self.oy_t, self.ox_t = self.pady // th, self.padx // tw

    # --- the edge fixups of the one-step kernels (K4, K2) ---
    def _y_row_cols(self, i: int):
        """Columns of row 0 / h - 1 the y-wall fixup writes for
        population i: all on a 2D mesh (the x fixup runs after it and
        wins at the corners); in "y" mode the x walls ran in the kernel
        and win, so their corner entries stay."""
        cfg, w = self.cfg, self.w
        if self.two_d:
            return slice(0, w)
        ex = int(lattice.E[i, 0])
        lo = 1 if cfg.bc_west == WALL and ex == 1 else 0
        hi = w - 1 if cfg.bc_east == WALL and ex == -1 else w
        return slice(lo, hi)

    def fix_walls(self, fnew, iy: int, ix: int, edge_post):
        """Half-way bounce-back on the shard's global-edge sides that the
        kernel skipped: y walls from the post-collision rows 0 and h - 1,
        then (2D mesh) x walls from columns 0 and w - 1, in the oracle's
        order. edge_post = (rows (9, 2, w), cols (9, h, 2)): the
        post-collision populations of those rows and columns that the
        kernel handed out (edge_buffers; on bf16 the shifted ones, so
        the f32 sum rounds once into fnew). In place."""
        cfg = self.cfg
        opp = lattice.OPP
        rows, cols = edge_post
        ny_sh, nx_sh = self.mesh.shape["y"], self.mesh.shape["x"]
        sides = [(iy == 0, cfg.bc_south, rows[:, 0:1], lattice.IN_N, 0,
                  cfg.uw_south),
                 (iy == ny_sh - 1, cfg.bc_north, rows[:, 1:2], lattice.IN_S,
                  -1, cfg.uw_north)]
        for on, bc, fp, idxs, row, uw in sides:
            if not (on and bc == WALL):
                continue
            for i in (int(j) for j in idxs):
                sl = self._y_row_cols(i)
                fnew[i, row, sl] = (fp[int(opp[i]), 0, sl]
                                    + lattice.wall_corr(i, uw, 0.0, cfg.rho0))
        if not self.two_d:
            return fnew
        sides = [(ix == 0, cfg.bc_west, cols[:, :, 0:1], lattice.IN_E, 0,
                  cfg.uw_west),
                 (ix == nx_sh - 1, cfg.bc_east, cols[:, :, 1:2], lattice.IN_W,
                  -1, cfg.uw_east)]
        for on, bc, fp, idxs, col, uw in sides:
            if not (on and bc == WALL):
                continue
            for i in (int(j) for j in idxs):
                fnew[i, :, col] = (fp[int(opp[i]), :, 0]
                                   + lattice.wall_corr(i, 0.0, uw, cfg.rho0))
        return fnew

    def edge_buffers(self, device):
        """(rows (9, 2, w), cols (9, h, 2)) f32 buffers for a one-step
        kernel's edge post-collision populations."""
        return (torch.empty((9, 2, self.w), device=device),
                torch.empty((9, self.h, 2), device=device))

    # --- pure fluid ---
    def fluid_step(self, ms: MeshState, outs, k: int) -> MeshState:
        """k steps: K5 on every frame (k > 1, edges in the kernel), or K4
        then the edge fixups (k = 1)."""
        cfg, lc = self.cfg, self.local_cfg
        frames = exchange(ms.f, self.mesh)
        for p, iy, ix in self.mesh.positions():
            with on_device(self.mesh.devices[p]):
                if k > 1:
                    fused_fluid.fused_step_fluid_multi(
                        frames[p], lc, k, outs[p], prehalo=self.mode,
                        edges=self.edges[p], ny_glob=cfg.ny)
                    continue
                edge = self.edge_buffers(frames[p].device)
                fnew = fused_fluid.fused_step_fluid(frames[p], lc, outs[p],
                                                    prehalo=self.mode,
                                                    edge_post=edge)
                self.fix_walls(fnew, iy, ix, edge)
                apply_open_boundaries_sharded(fnew, cfg, iy, ix, self.mesh,
                                              self.u_rows[p], self.rho_o[p])
        return ms._replace(f=tuple(outs), step=tuple(s + k for s in ms.step))

    # --- coupled ---
    def canvas_origin(self, iy: int, ix: int):
        """The global cell of the shard's canvas cell (0, 0)."""
        return iy * self.h - self.pady, ix * self.w - self.padx

    def interior_origin(self, iy: int, ix: int):
        """The global cell of the shard's interior cell (0, 0): K2's
        origin for records in global coordinates."""
        return iy * self.h, ix * self.w

    def _bin(self, iy: int, ix: int, x, act, margin: int):
        """The shard's canvas binning of disks at global positions x:
        (lists, counts, interior entry slots, overflow)."""
        lists, counts, entries_c, bovf = stamp.build_tile_lists(
            x, act, self.canvas_cfg, margin=margin,
            origin=self.canvas_origin(iy, ix))
        entries_i = stamp.remap_entry_slots(
            entries_c, self.cfg.tile_cap, self.ntx_c, self.oy_t, self.ox_t,
            self.nty_i, self.ntx_i)
        return lists, counts, entries_i, bovf

    def rebuild(self, ms: MeshState):
        """A Verlet-cadence rebuild: every replica wraps its positions and
        selects ghosts with BIN_MARGIN slack (periodic axes), every shard
        bins the disks on its canvas with the same slack. Returns (ms with
        the wrapped positions and both overflows, ctx)."""
        from lbmdem_tpu_torch.simulation import BIN_MARGIN

        mesh = self.mesh
        disks, ovf, reps, xb = [], [], [], []
        for r, d in enumerate(ms.disks):
            gparent = gaxes = None
            o = ms.overflow[r]
            with on_device(mesh.replicas[r]):
                if self.periodic:
                    xw, aug, gparent, gaxes, govf = imb.periodic_ghosts(
                        d.x, d.v, d.omega, d.r, d.active, self.cfg,
                        margin=BIN_MARGIN)
                    d = d._replace(x=xw)
                    o = torch.maximum(o, govf)
                    xb.append((aug[0], aug[4]))
                else:
                    xb.append((d.x, d.active))
            disks.append(d)
            ovf.append(o)
            reps.append((d.x, gparent, gaxes))
        shards, bovf = [None] * mesh.size, []
        for p, iy, ix in mesh.positions():
            xa, act = xb[mesh.replica_of[p]]
            with on_device(mesh.devices[p]):
                lists, counts, entries_i, b = self._bin(iy, ix, xa, act,
                                                        BIN_MARGIN)
            shards[p] = (lists, counts, entries_i)
            bovf.append(b)
        ovf = [torch.maximum(o, b) for o, b in
               zip(ovf, max_over_shards(bovf, mesh))]
        return (ms._replace(disks=tuple(disks), overflow=tuple(ovf)),
                (shards, reps))

    def shard_inputs(self, iy: int, ix: int, aug, lists=None):
        """K2's inputs on shard (iy, ix) from its replica's disks `aug` =
        (x, v, omega, r, active) at global positions, ghosts included: the
        canvas binning
        (afresh, margin 0, when `lists` is None, else the rebuild's
        (lists, counts, entry slots)), K1 on the canvas, the Zou/He
        columns zeroed. Returns (interior entry slots, canvas solid
        stack, interior tile_data and counts, K2's solid window, the
        binning's overflow or None)."""
        xa, va, oma, ra, acta = aug
        bovf = None
        if lists is None:
            lists, counts, entries_i, bovf = self._bin(iy, ix, xa, acta, 0)
        else:
            lists, counts, entries_i = lists
        tile_data = stamp.gather_tile_data(lists, xa, va, oma, ra, acta)
        solid = stamp.stamp_fields(tile_data, counts, self.canvas_cfg,
                                   self.canvas_origin(iy, ix))
        pady, padx, h, w = self.pady, self.padx, self.h, self.w
        mask_open_edges(solid, self.cfg, ix, self.mesh, padx, padx + w - 1)
        tiles = (slice(self.oy_t, self.oy_t + self.nty_i),
                 slice(self.ox_t, self.ox_t + self.ntx_i))
        td_i = tile_data.reshape(self.nty_c, self.ntx_c, -1)[tiles].reshape(
            self.nty_i * self.ntx_i, 1, -1).contiguous()
        cnt_i = counts.reshape(self.nty_c, self.ntx_c)[tiles].reshape(
            -1, 1, 1).contiguous()
        s_k = solid[:, pady - HY:pady + h + HY, :].contiguous()
        return entries_i, solid, td_i, cnt_i, s_k, bovf

    def _replica_inputs(self, ms: MeshState, ctx):
        """Every replica's disks and coupling view: (disks, aug = (x, v,
        omega, r, active) with the ghosts appended, ghost parents,
        binning overflow). ctx None: ghosts selected afresh (margin 0);
        else the rebuild's selection at the current positions and its
        travel check."""
        from lbmdem_tpu_torch.simulation import BIN_MARGIN

        cfg, mesh = self.cfg, self.mesh
        reps, aug, gparents, bovf_r = [], [], [], []
        for r, d in enumerate(ms.disks):
            with on_device(mesh.replicas[r]):
                gparent = None
                bovf = torch.zeros((), dtype=torch.int32, device=d.x.device)
                if ctx is None:
                    if self.periodic:
                        xw, a, gparent, _, bovf = imb.periodic_ghosts(
                            d.x, d.v, d.omega, d.r, d.active, cfg)
                        d = d._replace(x=xw)
                    else:
                        a = (d.x, d.v, d.omega, d.r, d.active)
                else:
                    x_bin, gparent, gaxes = ctx[1][r]
                    travel2 = torch.where(d.active,
                                          torch.sum((d.x - x_bin) ** 2, -1),
                                          torch.zeros_like(d.r))
                    bovf = torch.sum(travel2 > float(BIN_MARGIN) ** 2).to(
                        torch.int32)
                    a = (imb.apply_ghosts(gparent, gaxes, d.x, d.v, d.omega,
                                          d.r, d.active, cfg)
                         if self.periodic
                         else (d.x, d.v, d.omega, d.r, d.active))
            reps.append(d)
            aug.append(a)
            gparents.append(gparent)
            bovf_r.append(bovf)
        return reps, aug, gparents, bovf_r

    def coupled_step(self, ms: MeshState, outs, ctx) -> MeshState:
        """One coupled step (the JAX coupled_step). ctx None: every
        replica selects ghosts and every shard bins afresh (margin 0);
        else the rebuild's (shards, replicas), whose travel check counts
        into overflow."""
        cfg, lc, mesh = self.cfg, self.local_cfg, self.mesh
        frames = exchange(ms.f, mesh)
        reps, aug, gparents, bovf_r = self._replica_inputs(ms, ctx)
        fh_p, th_p, bovf_p = [], [], []
        for p, iy, ix in mesh.positions():
            xa, va, oma, ra, acta = aug[mesh.replica_of[p]]
            f = ms.f[p]
            with on_device(mesh.devices[p]):
                entries_i, solid, td_i, cnt_i, s_k, b = self.shard_inputs(
                    iy, ix, aug[mesh.replica_of[p]],
                    None if ctx is None else ctx[0][p])
                if b is not None:
                    bovf_p.append(b)
                edge = self.edge_buffers(f.device)
                fnew, partials = fused_lbm.fused_step_imb_reduce(
                    frames[p], s_k, td_i, cnt_i, lc, outs[p],
                    prehalo=self.mode, origin=self.interior_origin(iy, ix),
                    edge_post=edge)
                self.fix_walls(fnew, iy, ix, edge)
                apply_open_boundaries_sharded(fnew, cfg, iy, ix, mesh,
                                              self.u_rows[p], self.rho_o[p])
                fh, th = stamp.gather_partials(partials, entries_i,
                                               xa.dtype)
            fh_p.append(fh)
            th_p.append(th)
        fhs = sum_over_shards(fh_p, mesh)
        ths = sum_over_shards(th_p, mesh)
        if bovf_p:
            bovf_r = [torch.maximum(a, b) for a, b in
                      zip(bovf_r, max_over_shards(bovf_p, mesh))]
        disks, ovfs, ncs = [], [], []
        for r, d in enumerate(reps):
            with on_device(mesh.replicas[r]):
                fh, th = fhs[r], ths[r]
                if self.periodic:
                    fh, th = imb.fold_ghost_forces(fh, th, gparents[r],
                                                   d.x.shape[0])
                use_slab = slab_dem.slab_supported(
                    self.grid, self.dem_axis, kt=cfg.kt > 0.0,
                    device=d.x.device)
                nd, ovf, nc = advance_replica(d, fh, th, self.grid, cfg,
                                              self.dem_mode, use_slab,
                                              self.dem_axis)
                disks.append(nd)
                ovfs.append(torch.maximum(ms.overflow[r],
                                          torch.maximum(ovf, bovf_r[r])))
                ncs.append(nc)
        return MeshState(f=tuple(outs), disks=tuple(disks),
                         step=tuple(s + 1 for s in ms.step),
                         overflow=tuple(ovfs), n_contacts=tuple(ncs),
                         fail_step=ms.fail_step)

    def window_step(self, ms: MeshState, outs, ctx, k: int) -> MeshState:
        """k coupled steps of one coupling_k window (the JAX
        coupled_window_step): one exchange; per shard K1 on its canvas
        and one K6 pass on its frame over those window-start solid fields
        and binning, the walls and Zou/He closures of the shard's global
        edges in the kernel (no edge fixups); every inner step's forces
        gathered per shard and summed over the shards as one stacked (k,
        ...) tensor; per replica the ghost fold, then the window DEM (K3w
        chained over the k forces; past the slab gate the cell-list DEM
        or the drift per inner step) and the Zou/He cull. ctx: the
        cadence rebuild's (shards, replicas)."""
        from lbmdem_tpu_torch.simulation import window_disks

        cfg, lc, mesh = self.cfg, self.local_cfg, self.mesh
        frames = exchange(ms.f, mesh)
        reps, aug, gparents, bovf_r = self._replica_inputs(ms, ctx)
        fh_p, th_p = [], []
        for p, iy, ix in mesh.positions():
            xa = aug[mesh.replica_of[p]][0]
            with on_device(mesh.devices[p]):
                entries_i, _, td_i, cnt_i, s_k, _ = self.shard_inputs(
                    iy, ix, aug[mesh.replica_of[p]], ctx[0][p])
                _, partials = fused_lbm.fused_step_imb_reduce_multi(
                    frames[p], s_k, td_i, cnt_i, lc, k, outs[p],
                    prehalo=self.mode, origin=self.interior_origin(iy, ix),
                    edges=self.edges[p], ny_glob=cfg.ny)
                fts = [stamp.gather_partials(partials[t], entries_i,
                                             xa.dtype) for t in range(k)]
            fh_p.append(torch.stack([fh for fh, _ in fts]))
            th_p.append(torch.stack([th for _, th in fts]))
        fhs = sum_over_shards(fh_p, mesh)
        ths = sum_over_shards(th_p, mesh)
        disks, ovfs, ncs = [], [], []
        for r, d in enumerate(reps):
            with on_device(mesh.replicas[r]):
                forces = [(fhs[r][t], ths[r][t]) for t in range(k)]
                if self.periodic:
                    forces = [imb.fold_ghost_forces(fh, th, gparents[r],
                                                    d.x.shape[0])
                              for fh, th in forces]
                nd, ovf, nc = window_disks(d, forces, self.grid, cfg,
                                           self.dem_axis, self.dem_mode,
                                           ms.n_contacts[r])
                disks.append(nd)
                ovfs.append(torch.maximum(ms.overflow[r],
                                          torch.maximum(ovf, bovf_r[r])))
                ncs.append(nc)
        return MeshState(f=tuple(outs), disks=tuple(disks),
                         step=tuple(s + k for s in ms.step),
                         overflow=tuple(ovfs), n_contacts=tuple(ncs),
                         fail_step=ms.fail_step)

    # --- the static hoist ---
    def static_prep(self, ms: MeshState):
        """The static hoist's per-shard solid windows (the JAX
        static_prep): every replica selects the periodic ghosts of the
        fixed disks (margin 0), every shard bins them on its canvas, K1
        stamps it, the Zou/He columns are zeroed, and the canvas rows
        [pady - 8, pady + h + 8) are kept. Returns (windows, overflow):
        the ghost and binning overflow summed over the shards, a 0-dim
        tensor on the first replica's device for one host check."""
        _, aug, _, govf = self._replica_inputs(ms, None)
        wins, ovf = [None] * self.mesh.size, []
        for p, iy, ix in self.mesh.positions():
            r = self.mesh.replica_of[p]
            with on_device(self.mesh.devices[p]):
                _, _, _, _, s_k, bovf = self.shard_inputs(iy, ix, aug[r])
            wins[p] = s_k
            ovf.append(torch.maximum(bovf, govf[r]))
        return wins, sum_over_shards(ovf, self.mesh)[0]

    def static_step(self, ms: MeshState, outs, wins, k: int) -> MeshState:
        """k all-fixed-at-rest coupled steps (the JAX static_step): one
        exchange and one K7 pass per shard over its solid window, the
        walls and Zou/He closures of the shard's global edges in the
        kernel; no binning, stamp, reduce or DEM."""
        frames = exchange(ms.f, self.mesh)
        for p, _, _ in self.mesh.positions():
            with on_device(self.mesh.devices[p]):
                fused_static.fused_step_imb_static_multi(
                    frames[p], wins[p], self.local_cfg, k, outs[p],
                    prehalo=self.mode, edges=self.edges[p],
                    ny_glob=self.cfg.ny)
        return ms._replace(f=tuple(outs), step=tuple(s + k for s in ms.step))


def make_sharded_step_kernels(cfg: SimConfig, grid: Optional[DemGrid],
                              mesh: Mesh, dem_axis: str = "y",
                              temporal_k: int = 1,
                              dem_mode: str = "subcycle") -> Callable:
    """step(ms, outs) -> MeshState on the kernels: temporal_k fluid
    steps (K5 for temporal_k > 1, else K4), or one coupled step with a
    fresh binning. `outs` are the per-shard second f buffers."""
    parts = _Sharded(cfg, grid, mesh, dem_axis, dem_mode)
    if parts.coupled:
        if temporal_k != 1:
            raise ValueError("temporal blocking is pure-fluid only")
        return lambda ms, outs: parts.coupled_step(ms, outs, None)
    kmax = fused_fluid.MAX_K[cfg.f_storage]
    if not 1 <= temporal_k <= kmax:
        raise ValueError(f"temporal block k={temporal_k} outside 1..{kmax} "
                         f"for f_storage={cfg.f_storage!r}")
    return lambda ms, outs: parts.fluid_step(ms, outs, temporal_k)


def make_sharded_coupled_chunk(cfg: SimConfig, grid: Optional[DemGrid],
                               mesh: Mesh, n: int, dem_axis: str = "y",
                               dem_mode: str = "subcycle") -> Callable:
    """chunk(ms, spare) -> (ms, spare): n coupled steps in Verlet-cadence
    blocks of BIN_CADENCE (the last one shorter), each a rebuild then its
    b steps as b // coupling_k windows (window_step) and b % coupling_k
    single steps, the two f buffers of every shard trading places each
    call. Under paranoia="chunk" each block is validated at its end
    (state_ok per shard, the minimum over the shards) and the state
    frozen at the first failing block (paranoid_commit)."""
    from lbmdem_tpu_torch.simulation import BIN_CADENCE

    parts = _Sharded(cfg, grid, mesh, dem_axis, dem_mode)
    if not parts.coupled:
        raise ValueError("the coupled chunk needs a coupled scene")
    par_chunk = cfg.paranoia_mode == "chunk"
    ck = cfg.coupling_k

    def chunk(ms: MeshState, spare):
        done = 0
        while done < n:
            b = min(BIN_CADENCE, n - done)
            if par_chunk:
                # the block's steps overwrite both f buffers: keep the
                # block-start shards for a commit that stays frozen
                ms_in = ms._replace(f=tuple(None if f is None else f.clone()
                                            for f in ms.f))
            ms, ctx = parts.rebuild(ms)
            nwin, rem = divmod(b, ck) if ck > 1 else (0, b)
            for i in range(nwin + rem):
                old = ms.f
                ms = (parts.window_step(ms, spare, ctx, ck) if i < nwin
                      else parts.coupled_step(ms, spare, ctx))
                spare = old
            if par_chunk:
                ms = paranoid_commit_mesh(ms_in, ms,
                                          mesh_state_ok(cfg, ms, mesh), mesh)
            done += b
        return ms, spare

    return chunk


def make_sharded_static_chunk(cfg: SimConfig, mesh: Mesh, n: int,
                              wins) -> Callable:
    """chunk(ms, spare) -> (ms, spare): n all-fixed-at-rest coupled steps
    of the static hoist over the shards' solid windows (`_Sharded.
    static_prep`, made once): n // TEMPORAL_K K7 passes of TEMPORAL_K
    steps, then n % TEMPORAL_K passes of one step (the JAX
    make_sharded_static_chunk). Under paranoia="chunk" every pass is
    validated at its end."""
    from lbmdem_tpu_torch.simulation import TEMPORAL_K

    parts = _Sharded(cfg, None, mesh, "y", "drift")
    par_chunk = cfg.paranoia_mode == "chunk"
    passes, singles = divmod(n, TEMPORAL_K)

    def chunk(ms: MeshState, spare):
        for k in [TEMPORAL_K] * passes + [1] * singles:
            new = parts.static_step(ms, spare, wins, k)
            if par_chunk:
                new = paranoid_commit_mesh(ms, new,
                                           mesh_state_ok(cfg, new, mesh), mesh)
            ms, spare = new, ms.f
        return ms, spare

    return chunk


def sharded_static_solid(cfg: SimConfig, mesh: Mesh, ms: MeshState):
    """The static hoist's per-shard solid windows of the fixed disks at
    rest in `ms` (`_Sharded.static_prep`), after one host check of their
    ghost and binning overflow (as `simulation.static_solid_stack`)."""
    wins, ovf = _Sharded(cfg, None, mesh, "y", "drift").static_prep(ms)
    if profiling.device_wait("static_binning", int, ovf) != 0:
        raise ValueError(
            "static-solid binning overflow: raise cfg.tile_cap (or "
            "cfg.ghost_cap for periodic obstacle arrays)")
    return wins
