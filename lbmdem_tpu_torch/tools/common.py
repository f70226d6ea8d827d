"""What the validation and study tools share: the device check, the
card's label for every printed speed, the path a Simulation took, the
goldens, and the gate that a failed check raises."""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from lbmdem_tpu_torch.ops import slab_dem

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class GateFailed(AssertionError):
    """A physics gate of a tool failed (raised, never skipped: unlike an
    assert statement it stays under python -O)."""


def gate(ok, msg: str) -> None:
    """Raise GateFailed(msg) unless `ok`."""
    if not ok:
        raise GateFailed(msg)


def require_device(device) -> torch.device:
    """torch.device(device); RuntimeError for the card when none is
    present (a tool never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available (torch.cuda.is_available() is "
            "False); pass --device cpu (device='cpu') to run the plain "
            "PyTorch versions on the CPU")
    return dev


def device_label(device) -> str:
    """The card's name and power limit as nvidia-smi gives them ("cpu"
    on the CPU): printed beside every speed."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    res = subprocess.run(
        ["nvidia-smi", f"--id={idx}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if res.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip()


def sync(device) -> None:
    """End a timed window: wait for the card's queue."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def describe_path(sim) -> str:
    """The path a Simulation takes: kernels or plain, and its disk
    motion (slab DEM K3 / K3w, with springs; the cell-list DEM; the
    drift or the static hoist of fixed disks; pure fluid)."""
    cfg = sim.cfg
    where = "kernels" if sim.use_kernels else "plain"
    if sim.grid is None:
        fluid = "K5 + K4" if sim.use_kernels else "lbm.step_pure_fluid"
        return (f"{where}, pure fluid ({fluid}), {_storage(cfg)}, "
                f"{sim.device.type}")
    if sim.dem_mode == "drift":
        motion = ("static hoist (K1 once, K7)" if sim.use_kernels
                  and sim.static_solid else "drift of fixed disks")
    elif sim.use_kernels and slab_dem.slab_supported(
            sim.grid, sim.dem_axis, kt=cfg.kt > 0.0, device=sim.device):
        slab = "K3w" if cfg.coupling_k > 1 else "K3"
        motion = f"slab DEM ({slab}{' kt' if cfg.kt > 0.0 else ''}, axis " \
                 f"{sim.dem_axis})"
    else:
        motion = "cell-list DEM"
    lbm = ""
    if sim.use_kernels and sim.dem_mode != "drift":
        lbm = (f"K1 + K6 (coupling_k={cfg.coupling_k}), " if
               cfg.coupling_k > 1 else "K1 + K2, ")
    return f"{where}, {lbm}{motion}, {_storage(cfg)}, {sim.device.type}"


def _storage(cfg) -> str:
    return ("bf16 storage" if cfg.f_storage == "bfloat16"
            else cfg.dtype)


def golden(name: str) -> np.ndarray:
    """A golden trajectory of tests/golden (header row skipped)."""
    return np.loadtxt(os.path.join(REPO, "tests", "golden", name),
                      delimiter=",", skiprows=1)
