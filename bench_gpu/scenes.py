"""The benchmark's scene generator: a configuration's deployment and a
cell's start state, made from `--seed`.

A frozen copy of the scene settings the program's own scenarios use
(`lbmdem_tpu_torch/models/scenarios.py` at commit caccc23:
`_pack_disks`, `column_collapse`; `bench.py`'s fluid stage and the
packing of its static-hoist stage, `_run_static`), so that a later
change there does not move a workload. Every seed gives the same sizes
and the same amount of work; the seed draws only the jitter of the
packing, the disks' start motion and the phases and amplitudes of a
start flow.

A configuration file's "scene" table says what is in the domain:

    {"kind": "hex_column", "n_disks": .., "r": .., "x_frac": ..,
     "y_frac": .., "pitch": .., "jitter": ..}   hex-packed disks in the
        box x <= x_frac nx, y <= y_frac ny against the west and south
        walls, rows from the bottom, centre pitch pitch * 2r, each disk
        jittered by up to jitter * r on each axis
    {"kind": "grid_bed", "n_disks": .., "r": .., "margin": ..,
     "jitter": ..}                              a porous bed: side =
        ceil(sqrt(n_disks)) columns and rows over the lattice less a
        margin of margin cells on each side, disk i at the centre of
        grid cell (i mod side, i div side), each coordinate jittered
        uniformly in [-jitter, jitter] cells
    {"kind": "fluid"}                           no disks

A disk scene's table may add "fixed": true (default false): every disk
is then fixed, a solid the forces never move (the program's
`DiskSpec.fixed`). Fixed disks start at rest: a "disk_motion" start
with them is refused.

A workload file's "start" table says how the run starts:

    {"kind": "rest"}
        fluid and disks at rest (the program's own start)
    {"kind": "disk_motion", "speed": s, "spin": w}
        fluid at rest; each disk's velocity components uniform in
        [-s, s] and its spin in [-w, w]
    {"kind": "flow_modes", "u_max": u, "modes": [[kx, ky], ...]}
        the equilibrium at rho0 of a velocity field of standing modes,
        u_x = sum_m a_m sin(2 pi kx x / nx + p_m) sin(pi ky (y + 1/2) /
        ny) and u_y likewise with the modes' other draws; the seed draws
        the signs, the phases p_m and |a_m| in [1/2, 1] of u / n_modes
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from bench_gpu.reference import lbm_dem


class Scene(NamedTuple):
    """The inputs both sides are given: disks as float64 numpy arrays
    (x, y, r, vx, vy, omega) and a bool array (fixed), None without
    disks; and, where the start is not the program's own rest state, a
    maker of the start populations (device -> (9, ny, nx) tensor in the
    configuration's dtype)."""

    disks: Optional[dict]
    start_f: Optional[Callable[[object], torch.Tensor]]


def hex_column(sc: dict, nx: int, ny: int, rng) -> dict:
    """Hex-packed disks against the west and south walls (the column
    collapse): rows from y = r, x from r (odd rows shifted by half a
    pitch), as many as fit in the box, at most n_disks."""
    r, n = float(sc["r"]), int(sc["n_disks"])
    pitch = 2.0 * r * float(sc["pitch"])
    x1, y1 = float(sc["x_frac"]) * nx, float(sc["y_frac"]) * ny
    xs, ys = [], []
    y, row = r, 0
    while y < y1 - r and len(xs) < n:
        x = r + (0.5 * pitch if row % 2 else 0.0)
        while x < x1 - r and len(xs) < n:
            xs.append(x)
            ys.append(y)
            x += pitch
        y += pitch * math.sqrt(3.0) / 2.0
        row += 1
    if len(xs) < n:
        raise ValueError(f"the box holds {len(xs)} disks, not {n}")
    jit = rng.uniform(-float(sc["jitter"]) * r, float(sc["jitter"]) * r,
                      (n, 2))
    z = np.zeros(n)
    return {"x": np.asarray(xs) + jit[:, 0], "y": np.asarray(ys) + jit[:, 1],
            "r": np.full(n, r), "vx": z, "vy": z.copy(), "omega": z.copy()}


def grid_bed(sc: dict, nx: int, ny: int, rng) -> dict:
    """A jittered grid of disks at rest over the lattice less a margin
    (`bench.py`'s static-hoist packing)."""
    n, r = int(sc["n_disks"]), float(sc["r"])
    margin, jit = float(sc["margin"]), float(sc["jitter"])
    side = int(math.ceil(math.sqrt(n)))
    gy, gx = np.divmod(np.arange(n), side)
    d = rng.uniform(-jit, jit, (n, 2))
    z = np.zeros(n)
    return {"x": margin + (gx + 0.5) * ((nx - 2 * margin) / side) + d[:, 0],
            "y": margin + (gy + 0.5) * ((ny - 2 * margin) / side) + d[:, 1],
            "r": np.full(n, r), "vx": z, "vy": z.copy(), "omega": z.copy()}


def flow_modes(st: dict, p: lbm_dem.Params, rng):
    """The start populations' maker of a "flow_modes" start."""
    modes = [tuple(m) for m in st["modes"]]
    amp = float(st["u_max"]) / len(modes)
    draws = [(rng.choice([-1.0, 1.0]) * rng.uniform(0.5, 1.0) * amp,
              rng.uniform(0.0, 2.0 * math.pi)) for _ in range(2 * len(modes))]

    def make(device) -> torch.Tensor:
        x = torch.arange(p.nx, dtype=torch.float64, device=device)[None, :]
        y = torch.arange(p.ny, dtype=torch.float64, device=device)[:, None]
        u = []
        for c in range(2):
            acc = torch.zeros((p.ny, p.nx), dtype=torch.float64, device=device)
            for (kx, ky), (a, ph) in zip(modes,
                                         draws[c * len(modes):]):
                acc += (a * torch.sin(2.0 * math.pi * kx * x / p.nx + ph)
                        * torch.sin(math.pi * ky * (y + 0.5) / p.ny))
            u.append(acc.to(p.dtype))
        rho = torch.full((p.ny, p.nx), p.rho0, dtype=p.dtype, device=device)
        return lbm_dem.equilibrium(rho, u[0], u[1])

    return make


PACKINGS = {"hex_column": hex_column, "grid_bed": grid_bed}


def build(config: dict, workload: dict, seed: int) -> Scene:
    """The scene of `config` with `workload`'s start, drawn from seed."""
    rng = np.random.default_rng(seed)
    sim = config["sim"]
    sc, st = config["scene"], workload["start"]
    disks = None
    if sc["kind"] in PACKINGS:
        disks = PACKINGS[sc["kind"]](sc, int(sim["nx"]), int(sim["ny"]), rng)
        disks["fixed"] = np.full(len(disks["x"]), bool(sc.get("fixed")))
    elif sc["kind"] != "fluid":
        raise ValueError(f"unknown scene kind {sc['kind']!r}")
    start_f = None
    if st["kind"] == "disk_motion":
        if disks["fixed"].any():
            raise ValueError("a disk_motion start moves disks that the "
                             "scene fixes")
        n = len(disks["x"])
        v = rng.uniform(-float(st["speed"]), float(st["speed"]), (n, 2))
        disks.update(vx=v[:, 0], vy=v[:, 1], omega=rng.uniform(
            -float(st["spin"]), float(st["spin"]), n))
    elif st["kind"] == "flow_modes":
        start_f = flow_modes(st, lbm_dem.Params.from_sim(sim), rng)
    elif st["kind"] != "rest":
        raise ValueError(f"unknown start kind {st['kind']!r}")
    return Scene(disks, start_f)
