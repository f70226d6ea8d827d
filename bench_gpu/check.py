"""How `correct` is decided: the program's state after the checked
calls against the plain reference's from the same inputs, and the
configuration's guarantees at the window's end.

The checked calls are the set-up's two calls of the window's entry:
`sim.run(first_steps)`, one coupling window (no disk has moved between
two stamps of the program or of the reference yet, so the two agree to
rounding), then `sim.run(check_steps - first_steps)`. Over the second
the program's and the reference's positions part by float32 ulps and
the sample coverage flips single 1/16 samples where a sample point lies
that close to a disk's edge, so its gaps are read over the whole
lattice and all disks, and as the share of disks that are off.

Numbers (each compared where the cell's "limits" or the
configuration's numeric "guarantees" give it a limit; the others are
printed as information):

    first_f_gap   max |f - f_ref| after the first call
    f_gap         the same after the second call
    f_l2          |f - f_ref| / |f_ref - w rho0| in the L2 norm over the
                  lattice after the second call (the error against the
                  departure from rest)
    v_med, omega_med  the median mobile disk's error over the median
                  mobile disk's speed (spin); left out where every disk
                  is fixed
    disks_off     the share of mobile disks whose error of v or of omega
                  is over OFF times the median disk's speed (spin): a
                  fault in a minority of disks; left out as v_med
    x_gap         max |x - x_ref| over the fixed disks (where some are):
                  0 where the bed stayed where it was
    contacts      disk-disk contacts of the last step (the program's)
    contacts_gap  |contacts - the reference's| / the reference's
    overflow      the program's binning and slab overflow at the
                  window's end (a running maximum over the whole run)
    mass_drift_rate   |sum f at the window's end / sum f at the start - 1|
                  per step of the whole run (float32 rounding alone cannot
                  move it by more than one unit roundoff, 2^-24, per step)
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from bench_gpu.reference import lbm_dem

# a disk is off where its error is over this share of the median disk's
# speed (spin); sound runs leave almost none so, the bf16 control most
OFF = 1e-3


def physical(f: torch.Tensor, sim: dict, i: int) -> torch.Tensor:
    """Population i of the program's f in float32 (the bf16 storage
    holds f_i - w_i rho0)."""
    if sim["f_storage"] == "bfloat16":
        return f[i].float() + float(np.float32(lbm_dem.W[i] * sim["rho0"]))
    return f[i]


def to_storage(f: torch.Tensor, sim: dict) -> torch.Tensor:
    """Physical float32 populations in the program's storage."""
    if sim["f_storage"] == "bfloat16":
        w = torch.as_tensor((lbm_dem.W * sim["rho0"]).astype(np.float32),
                            device=f.device)[:, None, None]
        return (f - w).to(torch.bfloat16)
    return f


def snapshot(sim_obj, sim: dict) -> dict:
    """The program's state on the host, after the checked call."""
    st = sim_obj.state
    out = {"f": st.f.to("cpu", copy=True), "contacts": int(st.n_contacts)}
    if sim.get("max_disks", 0):
        d = st.disks
        out.update(x=d.x.to("cpu", copy=True), v=d.v.to("cpu", copy=True),
                   omega=d.omega.to("cpu", copy=True))
    return out


def mass(f: torch.Tensor, sim: dict) -> float:
    """sum f in float64, population by population."""
    return sum(float(physical(f, sim, i).double().sum()) for i in range(9))


def window_end(sim_obj, sim: dict) -> dict:
    """The guarantees' readings of the state the window left."""
    st = sim_obj.state
    return {"overflow": int(st.overflow), "mass": mass(st.f, sim)}


def per_disk(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Each disk's error over the median disk's magnitude (the length of
    a vector per disk), in float64."""
    err, mag = (a - b).double(), b.double()
    if err.dim() > 1:
        err, mag = err.norm(dim=-1), mag.norm(dim=-1)
    scale = float(mag.abs().median())
    return err.abs() / scale if scale > 0 else torch.full_like(err, math.inf)


def first_gap(snap: dict, f_ref: torch.Tensor, sim: dict) -> float:
    """max |f - f_ref| of the first call's snapshot."""
    return max(float((physical(snap["f"], sim, i).to(f_ref.device)
                      - f_ref[i]).abs().max()) for i in range(9))


def compare(snap: dict, f_ref: torch.Tensor, d_ref, contacts_ref,
            sim: dict) -> Tuple[Dict[str, float], Optional[torch.Tensor]]:
    """The numbers of the second call's snapshot against the reference's
    state, and each mobile disk's larger relative error of v and omega
    (None without mobile disks)."""
    dev = f_ref.device
    gap, err2, sig2 = 0.0, 0.0, 0.0
    for i in range(9):
        p = physical(snap["f"], sim, i).to(dev)
        diff = (p - f_ref[i]).double()
        gap = max(gap, float(diff.abs().max()))
        err2 += float(torch.sum(diff * diff))
        sig = f_ref[i].double() - float(lbm_dem.W[i] * sim["rho0"])
        sig2 += float(torch.sum(sig * sig))
    out = {"f_gap": gap, "f_l2": math.sqrt(err2 / sig2) if sig2 else math.inf}
    if d_ref is None:
        return out, None
    v, om = snap["v"].to(dev), snap["omega"].to(dev)
    v_ref, om_ref = d_ref.v, d_ref.omega
    if d_ref.fixed is not None:
        fx, mob = d_ref.fixed, ~d_ref.fixed
        out["x_gap"] = float((snap["x"].to(dev)[fx].double()
                              - d_ref.x[fx].double()).abs().max())
        v, om, v_ref, om_ref = v[mob], om[mob], v_ref[mob], om_ref[mob]
    worst = None
    if len(v):
        ev, eo = per_disk(v, v_ref), per_disk(om, om_ref)
        worst = torch.maximum(ev, eo)
        out.update(v_med=float(ev.median()), omega_med=float(eo.median()),
                   disks_off=float((worst > OFF).double().mean()))
    out.update(contacts=float(snap["contacts"]),
               contacts_gap=abs(snap["contacts"] - contacts_ref)
               / max(contacts_ref, 1))
    return out, worst


def guarantees(end: dict, mass0: float, steps: int) -> Dict[str, float]:
    """The window end's readings: overflow and the mass drift rate."""
    return {"overflow": float(end["overflow"]),
            "mass_drift_rate": abs(end["mass"] / mass0 - 1.0) / steps}


def limits(workload: dict, config: dict) -> Dict[str, float]:
    """The cell's limits and the configuration's numeric guarantees."""
    out = {k: float(v) for k, v in config.get("guarantees", {}).items()
           if isinstance(v, (int, float)) and not isinstance(v, bool)}
    out.update({k: float(v) for k, v in workload["limits"].items()})
    return out


def judge(nums: Dict[str, float], lim: Dict[str, float]
          ) -> List[Tuple[str, float, float, bool]]:
    """(name, value, limit, within) of every compared number; a number
    that is not finite is never within its limit."""
    missing = sorted(set(lim) - set(nums))
    if missing:
        raise KeyError(f"limits name numbers the check has not: {missing}")
    return [(k, nums[k], lim[k], math.isfinite(nums[k]) and nums[k] <= lim[k])
            for k in sorted(lim)]


def info_line(nums: Dict[str, float], lim: Dict[str, float]) -> Optional[str]:
    """The numbers printed for information (those without a limit)."""
    rest = {k: v for k, v in nums.items() if k not in lim}
    if not rest:
        return None
    return "info " + " ".join(f"{k}={v!r}" for k, v in sorted(rest.items()))
