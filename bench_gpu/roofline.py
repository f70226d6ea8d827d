"""The yardstick of the kernels' roofline shares.

The published peaks of one NVIDIA H100 SXM (the data sheet's dense
rates, at its 700 W limit): HBM3 at 3.35 TB/s and float32 outside the
tensor cores at 67 TFLOP/s (the kernels use no tensor cores). A call's
bound is the larger of its counted bytes over the bandwidth and its
counted operations over the float32 rate (`bench_gpu/work/`); its share
is the bound over its measured device time per call.
"""

from __future__ import annotations

from typing import Optional, Tuple

HBM_BPS = 3.35e12
F32_FLOPS = 67e12


def bound_s(moved: float, flops: float) -> float:
    """The least time the chip could take for the work."""
    return max(moved / HBM_BPS, flops / F32_FLOPS)


def geometry(sim: dict, disks: Optional[dict], solid_cells: int,
             pairs: int, window: int) -> dict:
    """What the work counts read of a cell: the lattice, the storage's
    bytes per population, the disks, the coverage at the start, the
    directed neighbour pairs within the skin and the walls."""
    n = 0 if disks is None else len(disks["x"])
    walls = sum(sim[s] == "wall" for s in
                ("bc_west", "bc_east", "bc_south", "bc_north"))
    return {"nx": sim["nx"], "ny": sim["ny"], "cells": sim["nx"] * sim["ny"],
            "f_bytes": 2 if sim["f_storage"] == "bfloat16" else 4,
            "n_disks": n, "window": window,
            "eps_samples": sim.get("eps_samples", 4),
            "n_sub": sim.get("n_sub", 1), "walls": walls,
            "solid_cells": solid_cells, "pairs": pairs}


def call_bound_s(ctx, kernel: str) -> Optional[Tuple[float, int]]:
    """(bound of one call, calls) of `kernel` in the traced window, or
    None where it made no call. A call's steps are the window's steps
    over its calls."""
    if kernel not in ctx.trace.kernels:
        return None
    _, calls = ctx.trace.kernels[kernel]
    k = max(1, round(ctx.trace.steps / calls))
    return bound_s(*ctx.work[kernel].per_call(ctx.geometry, k)), calls


def share(ctx, kernel: str) -> Optional[float]:
    """Percent of its roofline that `kernel` reached in the window."""
    got = call_bound_s(ctx, kernel)
    if got is None:
        return None
    bound, calls = got
    seconds, _ = ctx.trace.kernels[kernel]
    return 100.0 * bound * calls / seconds


def step_share(ctx) -> Optional[float]:
    """Percent of the window's wall time that the chip's peaks need for
    the work of every hand-written kernel call in it: the whole step's
    share of the chip, which bounds what taking a kernel off the path
    can gain."""
    total = 0.0
    for kernel in ctx.trace.kernels:
        bound, calls = call_bound_s(ctx, kernel)
        total += bound * calls
    return 100.0 * total / ctx.trace.window_s if total else None
