"""Lattice domain decomposition over a mesh of devices, in one process
or across the processes of a `torch.distributed` group.

Counterpart of the JAX package's `lbmdem_tpu/parallel/sharding.py`. The
(9, ny, nx) populations are cut into a ('y', 'x') grid of (9, h, w)
shards, one per mesh position, each on its device; the disks are
replicated, one replica per distinct device of the mesh. A mesh may name
one device several times: the CPU tests run 4 shards on the CPU, and one
card holds a 2 x 2 mesh whose shards exchange their halos by copies on
that card. Shards on distinct cards exchange by device-to-device copies;
nothing is staged through the host.

After `launch.init_distributed` a mesh spans the processes
(`make_mesh`): each position belongs to a rank (`Mesh.ranks`, blocks of
positions in rank order), a rank holds only its own positions' shards
(the other entries of `MeshState.f` are None) and a replica of the disks
on each of its devices. Halos cross to a neighbour on another rank by
`torch.distributed` point-to-point (`halo_moves`), and the per-shard
results that every replica needs (forces, overflow counters, paranoid
checks, the gathered state) by `all_gather`, then combined in mesh order
as in one process, so every rank's replicas get one process's bits.

The plain sharded step here (`make_sharded_step(use_kernels=False)`, the
JAX XLA path) collides each shard, builds its (9, h + 2, w + 2) frame of
post-collision populations by a halo exchange (x first, then y over the
x-extended rows, so that diagonal links cross a corner in two hops),
pull-streams from it, and applies bounce-back and the Zou/He closures on
the shards that hold a global edge. Each shard stamps and reduces the
disks in its local frame; the per-disk forces are summed over the shards
in one fixed mesh order on every replica, so the replicas stay bitwise
equal, and each replica runs the DEM.

The kernel path (`use_kernels=True`) is `parallel/_kernel_step.py`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from lbmdem_tpu_torch import lattice
from lbmdem_tpu_torch.config import SimConfig, WALL
from lbmdem_tpu_torch.ops import dem, imb, lbm
from lbmdem_tpu_torch.ops.dem import DemGrid, DiskState
from lbmdem_tpu_torch.parallel import launch

# populations each halo side feeds in pull streaming: a cell at the low
# edge pulls f_i from outside the shard iff e_i points into it from there
_NEED_W = lattice.IN_E.tolist()  # the west halo feeds +x populations
_NEED_E = lattice.IN_W.tolist()
_NEED_S = lattice.IN_N.tolist()  # the south halo feeds +y populations
_NEED_N = lattice.IN_S.tolist()


class Mesh:
    """A ('y', 'x') grid of torch devices: `shape` = {"y": ny_sh, "x":
    nx_sh}; position (iy, ix) holds the shard of global rows [iy h, (iy +
    1) h) and columns [ix w, (ix + 1) w). `ranks[p]` is the process that
    holds position p (default: all this one, `rank` 0), `devices[p]` its
    device there; every rank holds as many positions. `replicas` are the
    distinct devices of this rank's positions in order of first
    appearance (row-major), one disk replica each; `replica_of[p]` is
    the replica of local position p (None for another rank's)."""

    def __init__(self, devices: Sequence, shape: Tuple[int, int],
                 ranks: Optional[Sequence[int]] = None, rank: int = 0):
        ny_sh, nx_sh = (int(s) for s in shape)
        devs = [torch.device(d) for d in devices]
        if ny_sh < 1 or nx_sh < 1 or len(devs) != ny_sh * nx_sh:
            raise ValueError(f"a {ny_sh}x{nx_sh} mesh needs {ny_sh * nx_sh} "
                             f"devices, got {len(devs)}")
        self.shape = {"y": ny_sh, "x": nx_sh}
        self.devices = devs  # row-major
        self.ranks = [rank] * len(devs) if ranks is None else list(ranks)
        self.rank = rank
        held = [self.ranks.count(r) for r in sorted(set(self.ranks))]
        if len(self.ranks) != len(devs) or rank not in self.ranks or (
                len(set(held)) != 1):
            raise ValueError(f"ranks {self.ranks}: every rank, {rank} "
                             f"included, must hold as many positions")
        self.world = len(held)
        self.replicas: List[torch.device] = []
        self.replica_of: List[Optional[int]] = []
        for p, d in enumerate(devs):
            if not self.is_local(p):
                self.replica_of.append(None)
                continue
            if d not in self.replicas:
                self.replicas.append(d)
            self.replica_of.append(self.replicas.index(d))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distributed(self) -> bool:
        """Whether other ranks hold positions of the mesh."""
        return self.world > 1

    def is_local(self, p: int) -> bool:
        return self.ranks[p] == self.rank

    def all_positions(self):
        """(p, iy, ix) of every position, row-major."""
        nx_sh = self.shape["x"]
        return [(p, p // nx_sh, p % nx_sh) for p in range(self.size)]

    def positions(self):
        """(p, iy, ix) of this rank's positions, row-major (every position
        in one process)."""
        return [t for t in self.all_positions() if self.is_local(t[0])]

    def index(self, iy: int, ix: int) -> int:
        """The position of mesh coordinates (iy, ix), wrapped as a ring."""
        ny_sh, nx_sh = self.shape["y"], self.shape["x"]
        return (iy % ny_sh) * nx_sh + ix % nx_sh

    def __repr__(self) -> str:
        ranks = f", ranks {self.ranks}" if self.distributed else ""
        return (f"Mesh({self.shape['y']}x{self.shape['x']}, "
                f"{[str(d) for d in self.devices]}{ranks})")


def _squarish(n: int) -> Tuple[int, int]:
    ysz = int(np.sqrt(n))
    while n % ysz:
        ysz -= 1
    return ysz, n // ysz


def make_mesh(devices=None, shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """A ('y', 'x') mesh over `devices` (default: every visible card, or
    after `launch.init_distributed` every process's devices).

    Without a shape the devices split squarish, as the JAX make_mesh
    does. An explicit device list may name a device several times
    (`["cpu"] * 4`, or one card for every shard). With a shape and the
    default devices the cards are taken in turn, so a mesh larger than
    the host's cards puts several shards on a card. Raises RuntimeError
    when no card is visible and no devices are given.

    In a group of several processes the positions go to the ranks in
    blocks of equal size in rank order (rank 0 the first rows, as the
    JAX mesh over `jax.devices()`), so the mesh's size must be a
    multiple of the world size; explicit devices name each position's
    device on its rank, and the default takes each rank's own devices in
    turn for its positions."""
    if not launch.is_initialized():
        if devices is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "make_mesh: no CUDA device is available; pass devices "
                    "(e.g. ['cpu'] * 4) to shard over the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            if shape is not None:
                want = shape[0] * shape[1]
                devices = [devices[i % len(devices)] for i in range(want)]
        devices = list(devices)
        return Mesh(devices, shape or _squarish(len(devices)))
    rank, world = dist.get_rank(), dist.get_world_size()
    if devices is None:
        _, _, _, n_global = launch.process_info()
        shape = shape or _squarish(n_global)
    else:
        devices = list(devices)
        shape = shape or _squarish(len(devices))
    size = shape[0] * shape[1]
    if size % world:
        raise ValueError(f"a {shape[0]}x{shape[1]} mesh does not split over "
                         f"{world} processes")
    per = size // world
    if devices is None:
        every = [None] * world
        dist.all_gather_object(every, [str(d) for d in
                                       launch.local_devices()])
        devices = [every[r][i % len(every[r])]
                   for r in range(world) for i in range(per)]
    return Mesh(devices, shape, [p // per for p in range(size)], rank)


def on_device(dev: torch.device):
    """Make `dev` the current CUDA device while a shard's or a replica's
    kernels launch (they launch on the current device's stream)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class MeshState(NamedTuple):
    """A SimState on a mesh: `f` holds one (9, h, w) shard per position
    (row-major; None where another rank holds the position), the other
    fields one entry per replica (Mesh.replicas), each a copy of the same
    values on its device."""

    f: Tuple[torch.Tensor, ...]
    disks: Tuple[DiskState, ...]
    step: Tuple[torch.Tensor, ...]
    overflow: Tuple[torch.Tensor, ...]
    n_contacts: Tuple[torch.Tensor, ...]
    fail_step: Tuple[torch.Tensor, ...]


def shard_dims(cfg: SimConfig, mesh: Mesh) -> Tuple[int, int]:
    """(h, w) of a shard; raise if the lattice does not tile the mesh."""
    ny_sh, nx_sh = mesh.shape["y"], mesh.shape["x"]
    if cfg.ny % ny_sh or cfg.nx % nx_sh:
        raise ValueError(f"lattice {cfg.ny}x{cfg.nx} does not tile the "
                         f"{ny_sh}x{nx_sh} mesh")
    return cfg.ny // ny_sh, cfg.nx // nx_sh


def per_position(mesh: Mesh, make) -> list:
    """[make(p, iy, ix) for this rank's positions, None for the others'],
    indexed by position."""
    out = [None] * mesh.size
    for p, iy, ix in mesh.positions():
        out[p] = make(p, iy, ix)
    return out


def empty_like_shards(fs) -> tuple:
    """A second buffer for each local shard of `fs` (None stays None)."""
    return tuple(None if f is None else torch.empty_like(f) for f in fs)


def shard_state(state, mesh: Mesh) -> MeshState:
    """Place a SimState on the mesh: f cut into shards, this rank's taken
    onto their devices, every other field copied to each replica's
    device. `state` may lie on any device (the CPU, so that no rank
    holds another's shards on its card)."""
    _, ny, nx = state.f.shape
    ny_sh, nx_sh = mesh.shape["y"], mesh.shape["x"]
    if ny % ny_sh or nx % nx_sh:
        raise ValueError(f"lattice {ny}x{nx} does not tile the "
                         f"{ny_sh}x{nx_sh} mesh")
    h, w = ny // ny_sh, nx // nx_sh
    f = tuple(per_position(mesh, lambda p, iy, ix: state.f[
        :, iy * h:(iy + 1) * h, ix * w:(ix + 1) * w].to(
            mesh.devices[p], copy=True).contiguous()))

    def rep(t):
        return tuple(t.to(d, copy=True) for d in mesh.replicas)

    disks = tuple(DiskState(*(t.to(d, copy=True) for t in state.disks))
                  for d in mesh.replicas)
    return MeshState(f=f, disks=disks, step=rep(state.step),
                     overflow=rep(state.overflow),
                     n_contacts=rep(state.n_contacts),
                     fail_step=rep(state.fail_step))


def unshard(ms: MeshState, mesh: Mesh, device=None):
    """The global SimState of a MeshState on `device` (default: the
    first replica's): the shards gathered, the first replica's disks and
    counters. Across processes every rank calls it and gets every shard
    (`gather_positions`)."""
    from lbmdem_tpu_torch.simulation import SimState

    dev = torch.device(device) if device is not None else mesh.replicas[0]
    ny_sh, nx_sh = mesh.shape["y"], mesh.shape["x"]
    fs = gather_positions([ms.f[p] for p, _, _ in mesh.positions()], mesh)
    rows = [torch.cat([fs[iy * nx_sh + ix].to(dev)
                       for ix in range(nx_sh)], dim=2)
            for iy in range(ny_sh)]
    return SimState(f=torch.cat(rows, dim=1),
                    disks=DiskState(*(t.to(dev) for t in ms.disks[0])),
                    step=ms.step[0].to(dev), overflow=ms.overflow[0].to(dev),
                    n_contacts=ms.n_contacts[0].to(dev),
                    fail_step=ms.fail_step[0].to(dev))


def _wire(t: torch.Tensor) -> torch.Tensor:
    """t's bytes as a contiguous uint8 tensor, which both NCCL and gloo
    move bit for bit whatever t's dtype (bf16 and bool included)."""
    return t.contiguous().view(torch.uint8)


def gather_positions(parts: Sequence[torch.Tensor], mesh: Mesh) -> list:
    """Every position's tensor, in mesh order, from `parts`: this rank's
    positions' tensors of one shape and dtype, in positions() order. In
    one process that is `parts`; across processes an all_gather over the
    group (every rank calls it), the remote ones landing on this rank's
    first device."""
    if not mesh.distributed:
        return list(parts)
    dev = mesh.replicas[0]
    with on_device(dev):
        local = torch.stack([t.to(dev) for t in parts])
        bufs = [torch.empty_like(_wire(local)) for _ in range(mesh.world)]
        dist.all_gather(bufs, _wire(local))
    seen = [0] * mesh.world
    out = []
    for r in mesh.ranks:
        out.append(bufs[r].view(local.dtype).view(local.shape)[seen[r]])
        seen[r] += 1
    return out


def halo_moves(mesh: Mesh, moves) -> None:
    """One pass of a halo exchange: `moves` lists (dst, src, take, put)
    for every position of the mesh, in one order that every rank builds
    alike; take(p) is the view of position p's tensor that it sends, and
    put(p, values) writes what it receives. A move within this rank is a
    copy (device to device between cards); one across ranks is a
    point-to-point send and receive on the process group, all of a pass
    in one batch (matched in list order; the list index is the tag)."""
    ops, recvs = [], []
    for tag, (dst, src, take, put) in enumerate(moves):
        to_me, from_me = mesh.is_local(dst), mesh.is_local(src)
        if to_me and from_me:
            put(dst, take(src).to(mesh.devices[dst]))
        elif from_me:
            ops.append(dist.P2POp(dist.isend, _wire(take(src)),
                                  mesh.ranks[dst], tag=tag))
        elif to_me:
            like = take(dst)  # the shards' slices have one shape
            buf = torch.empty_like(_wire(like))
            ops.append(dist.P2POp(dist.irecv, buf, mesh.ranks[src], tag=tag))
            recvs.append((dst, put, buf, like))
    if not ops:
        return
    with on_device(mesh.replicas[0]):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for dst, put, buf, like in recvs:
        put(dst, buf.view(like.dtype).view(like.shape))


def sum_over_shards(parts: Sequence[torch.Tensor], mesh: Mesh):
    """One sum of the shards' tensors per replica, in mesh order on every
    replica's device, so every replica gets the same bits. `parts`: this
    rank's positions' tensors in positions() order (across processes the
    others' are gathered first)."""
    parts = gather_positions(parts, mesh)
    out = []
    for d in mesh.replicas:
        tot = parts[0].to(d)
        for t in parts[1:]:
            tot = tot + t.to(d)
        out.append(tot)
    return out


def max_over_shards(vals, mesh: Mesh):
    """The max of the shards' 0-dim counters (this rank's, in positions()
    order), on every replica's device, in mesh order."""
    vals = gather_positions(vals, mesh)
    out = []
    for d in mesh.replicas:
        m = vals[0].to(d)
        for v in vals[1:]:
            m = torch.maximum(m, v.to(d))
        out.append(m)
    return out


def exchange_halo(fposts: Sequence[torch.Tensor], mesh: Mesh):
    """The (9, h + 2, w + 2) halo-extended post-collision frame of every
    local shard (a list by position, None for another rank's). Two
    exchanges, x then y - y over the x-extended rows, so that diagonal
    populations cross a shard corner in two hops. Only the 3 populations
    entering through each face are sent; the rest of the halo stays zero
    and is never read. The ring wrap is the periodic boundary; on a wall
    side the wrapped values are pulled only into populations that
    bounce-back overwrites."""
    def ext_of(p, iy, ix):
        fp = fposts[p]
        q, h, w = fp.shape
        ext = fp.new_zeros((q, h + 2, w + 2))
        ext[:, 1:-1, 1:-1] = fp
        return ext

    exts = per_position(mesh, ext_of)

    def put_at(idx):
        def put(p, v):
            exts[p][idx] = v
        return put

    x_moves, y_moves = [], []
    for p, iy, ix in mesh.all_positions():
        x_moves += [
            (p, mesh.index(iy, ix - 1),
             lambda q: fposts[q][_NEED_W, :, -1],
             put_at((_NEED_W, slice(1, -1), 0))),
            (p, mesh.index(iy, ix + 1),
             lambda q: fposts[q][_NEED_E, :, 0],
             put_at((_NEED_E, slice(1, -1), -1)))]
        y_moves += [
            (p, mesh.index(iy - 1, ix),
             lambda q: exts[q][_NEED_S, -2, :], put_at((_NEED_S, 0))),
            (p, mesh.index(iy + 1, ix),
             lambda q: exts[q][_NEED_N, 1, :], put_at((_NEED_N, -1)))]
    halo_moves(mesh, x_moves)
    halo_moves(mesh, y_moves)
    return exts


def stream_from_halo(ext: torch.Tensor) -> torch.Tensor:
    """Pull streaming from a halo-extended frame: static shifted slices."""
    _, hp, wp = ext.shape
    h, w = hp - 2, wp - 2
    outs = []
    for i in range(lattice.Q):
        ex, ey = int(lattice.E[i, 0]), int(lattice.E[i, 1])
        outs.append(ext[i, 1 - ey:1 - ey + h, 1 - ex:1 - ex + w])
    return torch.stack(outs)


def apply_bounce_back_sharded(fnew, fpost, cfg: SimConfig, iy: int, ix: int,
                              mesh: Mesh):
    """Half-way bounce-back (moving walls included) on the sides of the
    shard (iy, ix) that are global edges, in the order south, north,
    west, east (the x-wall rule wins at corners). In place."""
    ny_sh, nx_sh = mesh.shape["y"], mesh.shape["x"]
    opp = lattice.OPP
    for on, side, idxs, sl, uwx, uwy in (
            (iy == 0, cfg.bc_south, lattice.IN_N, (0, slice(None)),
             cfg.uw_south, 0.0),
            (iy == ny_sh - 1, cfg.bc_north, lattice.IN_S, (-1, slice(None)),
             cfg.uw_north, 0.0),
            (ix == 0, cfg.bc_west, lattice.IN_E, (slice(None), 0), 0.0,
             cfg.uw_west),
            (ix == nx_sh - 1, cfg.bc_east, lattice.IN_W, (slice(None), -1),
             0.0, cfg.uw_east)):
        if not (on and side == WALL):
            continue
        for i in (int(j) for j in idxs):
            fnew[(i,) + sl] = (fpost[(int(opp[i]),) + sl]
                               + lattice.wall_corr(i, uwx, uwy, cfg.rho0))
    return fnew


def _inlet_rows(cfg: SimConfig, iy: int, h: int, like: torch.Tensor):
    """The shard's h rows of the global inlet profile (the host-built
    array the single-device step uses), in like's dtype and device."""
    u = lbm.inlet_profile_array(cfg)[iy * h:(iy + 1) * h]
    return torch.as_tensor(u, dtype=like.dtype, device=like.device)


def apply_open_boundaries_sharded(fnew, cfg: SimConfig, iy: int, ix: int,
                                  mesh: Mesh, u_rows=None, rho_o=None):
    """The Zou/He inlet on the west-edge shards and outlet on the
    east-edge shards, in the oracle's order (lbm.apply_open_boundaries),
    with the inlet profile at the shard's global rows (`u_rows`, or
    sliced here from the global profile) and the outlet density `rho_o`
    (default cfg's). f32 or f64 storage, or shifted bf16 (the JAX
    package's storage-aware fixup, keyed on the tensor's dtype): the
    closures run in f32 on the stored g = f - w rho0 with the density
    shift rho0, and their results round back to bf16 once, at the
    store. In place."""
    if cfg.bc_west != "inlet":
        return fnew
    nx_sh = mesh.shape["x"]
    shifted = fnew.dtype == torch.bfloat16
    shift = cfg.rho0 if shifted else 0.0

    def col(c):
        return tuple(fnew[i, :, c].float() if shifted else fnew[i, :, c]
                     for i in range(9))

    if ix == 0:
        if u_rows is None:
            like = fnew.new_empty(0, dtype=torch.float32) if shifted else fnew
            u_rows = _inlet_rows(cfg, iy, fnew.shape[1], like)
        n1, n5, n8 = lbm.zou_he_inlet(col(0), u_rows, shift)
        fnew[1, :, 0], fnew[5, :, 0], fnew[8, :, 0] = n1, n5, n8
    if ix == nx_sh - 1:
        if rho_o is None:
            rho_o = cfg.rho_outlet or cfg.rho0
        n3, n7, n6 = lbm.zou_he_outlet(col(-1), rho_o, shift)
        fnew[3, :, -1], fnew[7, :, -1], fnew[6, :, -1] = n3, n7, n6
    return fnew


def mask_open_edges(a: torch.Tensor, cfg: SimConfig, ix: int, mesh: Mesh,
                    cw: int = 0, ce: int = -1):
    """Zero columns cw (global x = 0) and ce (global x = nx - 1) of the
    solid fields `a` (..., rows, cols) on the shards that hold them, under
    Zou/He (the closures assume fluid there). In place."""
    if cfg.bc_west != "inlet":
        return a
    if ix == 0:
        a[..., cw].zero_()
    if ix == mesh.shape["x"] - 1:
        a[..., ce].zero_()
    return a


def advance_replica(d: DiskState, fh, th, grid: DemGrid, cfg: SimConfig,
                    dem_mode: str, use_slab: bool = False,
                    dem_axis: str = "y"):
    """One step of a replica's disk motion: the slab DEM (K3), the
    cell-list DEM subcycle, or under dem_mode "drift" the prescribed
    motion; then the Zou/He cull."""
    from lbmdem_tpu_torch.ops import slab_dem
    from lbmdem_tpu_torch.simulation import _advance_disks

    if use_slab and dem_mode == "subcycle":
        disks, ovf, nc = slab_dem.dem_subcycle(d, fh, th, grid, cfg, dem_axis)
    else:
        disks, ovf, nc = _advance_disks(d, fh, th, grid, cfg, dem_mode)
    if cfg.bc_west == "inlet":
        disks = dem.cull_open_boundaries(disks, cfg)
    return disks, ovf, nc


def _position_state(ms: MeshState, mesh: Mesh, p: int):
    """The SimState of position p: its shard of f with its replica's
    disks and counters."""
    from lbmdem_tpu_torch.simulation import SimState

    r = mesh.replica_of[p]
    return SimState(f=ms.f[p], disks=ms.disks[r], step=ms.step[r],
                    overflow=ms.overflow[r], n_contacts=ms.n_contacts[r],
                    fail_step=ms.fail_step[r])


def mesh_state_ok(cfg: SimConfig, ms: MeshState, mesh: Mesh):
    """Paranoid mode's validity of a MeshState, one 0-dim bool per
    replica (the same value on each): simulation.state_ok of every
    position, the minimum over the shards (the JAX pmin; across
    processes over every rank's), so every shard freezes or none."""
    from lbmdem_tpu_torch.simulation import state_ok

    oks = gather_positions([state_ok(cfg, _position_state(ms, mesh, p))
                            for p, _, _ in mesh.positions()], mesh)
    out = []
    for d in mesh.replicas:
        ok = oks[0].to(d)
        for o in oks[1:]:
            ok = ok & o.to(d)
        out.append(ok)
    return out


def paranoid_commit_mesh(old: MeshState, new: MeshState, oks,
                         mesh: Mesh) -> MeshState:
    """simulation.paranoid_commit of every position with its replica's
    validity `oks` (mesh_state_ok): each shard's f is selected into
    new.f's buffer, so the two f buffers keep trading places; a
    replica's fields are those its first position committed (every
    position of a replica commits the same values)."""
    from lbmdem_tpu_torch.simulation import paranoid_commit

    per = per_position(mesh, lambda p, iy, ix: paranoid_commit(
        _position_state(old, mesh, p), _position_state(new, mesh, p),
        oks[mesh.replica_of[p]]))
    first = [per[mesh.replica_of.index(r)] for r in range(len(mesh.replicas))]
    return MeshState(f=tuple(None if c is None else c.f for c in per),
                     disks=tuple(c.disks for c in first),
                     step=tuple(c.step for c in first),
                     overflow=tuple(c.overflow for c in first),
                     n_contacts=tuple(c.n_contacts for c in first),
                     fail_step=tuple(c.fail_step for c in first))


def make_sharded_step(cfg: SimConfig, grid: Optional[DemGrid], mesh: Mesh,
                      use_kernels: bool = False, dem_axis: str = "y",
                      temporal_k: int = 1,
                      dem_mode: str = "subcycle") -> Callable:
    """The step of a MeshState: step(ms, f_out) -> MeshState.

    use_kernels=False: the plain sharded step (the JAX XLA path), one
    step per call, on any device and in f32 or f64 (f_out unused).
    use_kernels=True: the kernel path of `_kernel_step` - pure fluid
    through K4 (temporal_k 1) or K5 (temporal_k > 1) on pre-haloed
    shards, coupled scenes one step of K1 on the shard's canvas and K2
    with a fresh binning; the step writes the new shards into the
    per-shard buffers f_out.

    With cfg.paranoia the step is followed by mesh_state_ok and
    paranoid_commit_mesh (the JAX paranoid_wrap of the sharded step)."""
    step = _sharded_step(cfg, grid, mesh, use_kernels, dem_axis, temporal_k,
                         dem_mode)
    if not cfg.paranoia:
        return step

    def wrapped(ms: MeshState, f_out=None) -> MeshState:
        new = step(ms, f_out)
        return paranoid_commit_mesh(ms, new, mesh_state_ok(cfg, new, mesh),
                                    mesh)

    return wrapped


def _sharded_step(cfg: SimConfig, grid: Optional[DemGrid], mesh: Mesh,
                  use_kernels: bool, dem_axis: str, temporal_k: int,
                  dem_mode: str) -> Callable:
    """make_sharded_step without paranoid mode."""
    if use_kernels:
        from lbmdem_tpu_torch.parallel._kernel_step import (
            make_sharded_step_kernels,
        )

        return make_sharded_step_kernels(cfg, grid, mesh, dem_axis,
                                         temporal_k, dem_mode)
    if temporal_k != 1:
        raise ValueError("temporal blocking needs the kernel path")
    if cfg.f_storage != "float32":
        raise ValueError("the plain sharded step takes float32 or float64 "
                         "storage (f_storage='float32')")
    h, w = shard_dims(cfg, mesh)
    coupled = cfg.max_disks > 0
    periodic_dem = coupled and bool(cfg.wrap_lx or cfg.wrap_ly)
    local_cfg = cfg.replace(ny=h, nx=w)

    def step(ms: MeshState, f_out=None) -> MeshState:
        dt = ms.f[mesh.positions()[0][0]].dtype
        aug, gparent, govf, reps = [], [], [], []
        if coupled:
            for r, d in enumerate(ms.disks):
                if periodic_dem:
                    # wrap and select ghosts at global coordinates (every
                    # replica makes the same selection)
                    xw, a, gp, _, go = imb.periodic_ghosts(
                        d.x, d.v, d.omega, d.r, d.active, cfg)
                    d = d._replace(x=xw)
                else:
                    a, gp = (d.x, d.v, d.omega, d.r, d.active), None
                    go = torch.zeros((), dtype=torch.int32, device=d.x.device)
                reps.append(d)
                aug.append(a)
                gparent.append(gp)
                govf.append(go)
        fposts, solids, xlocs = [None] * mesh.size, [], []
        for p, iy, ix in mesh.positions():
            f = ms.f[p]
            if coupled:
                xa, va, oma, ra, acta = aug[mesh.replica_of[p]]
                shift = torch.tensor([ix * w, iy * h], dtype=xa.dtype,
                                     device=xa.device)
                xloc = xa - shift
                eps, usx, usy = imb.stamp_solid_fraction(xloc, va, oma, ra,
                                                         acta, local_cfg)
                for a in (eps, usx, usy):
                    mask_open_edges(a, cfg, ix, mesh)
                fpost, phix, phiy = imb.collide_imb(f, eps, usx, usy,
                                                    local_cfg)
                solids.append((eps, phix, phiy))
                xlocs.append(xloc)
            else:
                fpost = lbm.collide(f, cfg.tau, cfg.gx, cfg.gy,
                                    cfg.smagorinsky, cfg.trt_lambda)
            fposts[p] = fpost
        exts = exchange_halo(fposts, mesh)

        def stream(p, iy, ix):
            fn = stream_from_halo(exts[p])
            apply_bounce_back_sharded(fn, fposts[p], cfg, iy, ix, mesh)
            return apply_open_boundaries_sharded(fn, cfg, iy, ix, mesh)

        fnew = per_position(mesh, stream)
        if not coupled:
            return ms._replace(f=tuple(fnew),
                               step=tuple(s + 1 for s in ms.step))
        fh_p, th_p = [], []
        for i, (p, _, _) in enumerate(mesh.positions()):
            _, va, oma, ra, acta = aug[mesh.replica_of[p]]
            eps, phix, phiy = solids[i]
            fh, th = imb.reduce_hydro_forces(xlocs[i], ra, acta, eps, phix,
                                             phiy, local_cfg)
            fh_p.append(fh)
            th_p.append(th)
        fhs = sum_over_shards(fh_p, mesh)
        ths = sum_over_shards(th_p, mesh)
        disks, ovfs, ncs = [], [], []
        for r, d in enumerate(reps):
            fh, th = fhs[r], ths[r]
            if periodic_dem:
                fh, th = imb.fold_ghost_forces(fh, th, gparent[r],
                                               d.x.shape[0])
            nd, ovf, nc = advance_replica(d, fh.to(dt), th.to(dt), grid, cfg,
                                          dem_mode)
            disks.append(nd)
            ovfs.append(torch.maximum(ms.overflow[r],
                                      torch.maximum(ovf, govf[r])))
            ncs.append(nc)
        return MeshState(f=tuple(fnew), disks=tuple(disks),
                         step=tuple(s + 1 for s in ms.step),
                         overflow=tuple(ovfs), n_contacts=tuple(ncs),
                         fail_step=ms.fail_step)

    return step
