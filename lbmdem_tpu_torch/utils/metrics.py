"""Observability, as the JAX package's `lbmdem_tpu/utils/metrics.py`:
the scalar diagnostics in one pass over the state on its device and one
transfer to the host, and `MetricsLogger`, which appends them to a CSV
(and optionally JSONL) with the wall-clock MLUPS between calls. Mass
drift is the canary; the overflow counter surfaces silent capacity
failures."""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Optional

import torch

from lbmdem_tpu_torch.config import SimConfig
from lbmdem_tpu_torch.ops import lbm
from lbmdem_tpu_torch.ops.imb import sqrt_rn

# diagnostics read back as Python ints (the rest as floats)
_INT_KEYS = ("step", "nan", "n_contacts", "overflow")


def compute_diagnostics(state, cfg: SimConfig) -> Dict[str, torch.Tensor]:
    """Every scalar diagnostic as a 0-dim tensor on the state's device,
    with the JAX package's keys, in its order."""
    f = lbm.from_storage(state.f, cfg)
    rho, ux, uy = lbm.moments(f, cfg.gx, cfg.gy)
    umag2 = ux * ux + uy * uy
    d = state.disks
    act = d.active
    zero = torch.zeros((), dtype=d.x.dtype, device=d.x.device)
    v2 = torch.sum(d.v ** 2, -1)
    return {
        "step": state.step,
        "mass": torch.sum(rho),
        "mom_x": torch.sum(rho * ux),
        "mom_y": torch.sum(rho * uy),
        "fluid_ke": 0.5 * torch.sum(rho * umag2),
        "max_u": sqrt_rn(torch.max(umag2)),
        "min_rho": torch.min(rho),
        "nan": torch.sum(~torch.isfinite(f)).to(torch.int32),
        "disk_ke": 0.5 * torch.sum(torch.where(act, d.mass * v2, zero)),
        "disk_rot_ke": 0.5 * torch.sum(
            torch.where(act, d.inertia * d.omega ** 2, zero)),
        "max_disk_v": sqrt_rn(torch.max(torch.where(act, v2, zero))),
        "n_contacts": state.n_contacts,
        "overflow": state.overflow,
    }


def read_diagnostics(state, cfg: SimConfig) -> Dict[str, float]:
    """compute_diagnostics as Python numbers, in one device-to-host copy
    (every value widens to float64 exactly; the counters come back as
    ints), keyed in sorted order as the JAX package's jitted call
    returns them - the order of its metrics CSV's columns."""
    diag = compute_diagnostics(state, cfg)
    keys = sorted(diag)
    vals = torch.stack([diag[k].to(torch.float64) for k in keys]).tolist()
    return {k: int(v) if k in _INT_KEYS else v for k, v in zip(keys, vals)}


class MetricsLogger:
    """Appends diagnostics to CSV (and optionally JSONL) with wall-clock
    MLUPS computed between calls; with no CSV path it only reads them
    (a rank of a multi-process run that does not write)."""

    def __init__(self, path_csv: Optional[str],
                 path_jsonl: Optional[str] = None):
        self.path_csv = path_csv
        self.path_jsonl = path_jsonl
        self._fields = None
        self._t_last = None
        self._step_last = 0

    def log(self, sim) -> Dict[str, float]:
        row = read_diagnostics(sim.state, sim.cfg)
        now = time.perf_counter()
        if self._t_last is not None and row["step"] > self._step_last:
            cells = sim.cfg.nx * sim.cfg.ny * (row["step"] - self._step_last)
            row["mlups"] = cells / (now - self._t_last) / 1e6
        else:
            row["mlups"] = 0.0
        self._t_last = now
        self._step_last = row["step"]

        if self.path_csv is None:
            return row
        if self._fields is None:
            self._fields = list(row)
            new = not os.path.exists(self.path_csv)
            os.makedirs(os.path.dirname(self.path_csv) or ".", exist_ok=True)
            with open(self.path_csv, "a", newline="") as fh:
                w = csv.DictWriter(fh, fieldnames=self._fields)
                if new:
                    w.writeheader()
                w.writerow(row)
        else:
            with open(self.path_csv, "a", newline="") as fh:
                csv.DictWriter(fh, fieldnames=self._fields).writerow(row)
        if self.path_jsonl:
            with open(self.path_jsonl, "a") as fh:
                fh.write(json.dumps(row) + "\n")
        return row
