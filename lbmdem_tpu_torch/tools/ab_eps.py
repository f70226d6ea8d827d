"""A/B of the solid-fraction coverage model (cfg.eps_method) on the card.

Counterpart of the JAX package's `tools/ab_eps.py`. The stamp (K1) and
the in-kernel hydro reduce (K2) recompute each disk's coverage per cell,
so the coverage model's arithmetic multiplies into both. eps_method:

  "sample" (default): eps_samples^2 = 16 subgrid compare-accumulates,
      reference-style cell saturation, the parity baseline;
  "ramp": clip(r + 1/2 - d, 0, 1), one sqrt and a clip, a different
      (linear, ~1-cell) interface model;
  "exact": the analytic tangent-plane overlap.

This tool measures, in one process: (1) the settling-velocity delta
ramp against sample on the kernels, the interface-model difference a
user accepts with the ramp (loosely bounded at 5 %; the 1 % parity
budget is pinned on "sample"); (2) the coupled step at 4096^2/10k for
sample against ramp (f32, and with --bf16 on bf16 storage, through
`ab_bf16.bench_coupled`); (3) with --cylinder, Schafer-Turek 2D-1 cD
with each coverage model (D = 20, 30k steps, plain path).

    python -m lbmdem_tpu_torch.tools.ab_eps [--bf16] [--cylinder] \
        [--device cpu]

It runs on the card unless given --device cpu, and raises without a
card; every speed is printed with the card's name and power limit.
"""

from __future__ import annotations

import argparse

import numpy as np

from lbmdem_tpu_torch.models import make_scenario
from lbmdem_tpu_torch.simulation import Simulation
from lbmdem_tpu_torch.tools.ab_bf16 import bench_coupled, settling_vy
from lbmdem_tpu_torch.tools.common import (describe_path, device_label,
                                           gate, require_device)


def settling_delta(device="cuda"):
    """Settling trajectory on the kernels, ramp against sample: the
    coverage-model physics delta (reported, loosely bounded at 5 %: an
    interface-model difference, not an error budget). Returns it."""
    vs = settling_vy(device, eps_method="sample")
    vr = settling_vy(device, eps_method="ramp")
    rel = np.max(np.abs(vr - vs)) / np.max(np.abs(vs))
    print(f"ramp-vs-sample settling-velocity delta: {rel * 100:.3f}% "
          f"(interface-model difference, loose bound 5%)", flush=True)
    gate(rel < 0.05, f"ramp-vs-sample delta {rel * 100:.3f}% exceeds 5%")
    return float(rel)


def cylinder_drag_delta(device="cuda", steps: int = 30000):
    """Schafer-Turek 2D-1 cD (D = 20, float32 on the card, float64 on
    the CPU; the plain path: the deck is untileable) with sample and
    ramp coverage: the diffuse-interface drag bias is the observable
    most sensitive to the coverage model. Returns {method: cD}."""
    device = require_device(device)
    out = {}
    for method in ("sample", "ramp"):
        cfg, disks = make_scenario("schafer_turek")
        cfg = cfg.replace(
            dtype="float32" if device.type == "cuda" else "float64",
            out_interval=10**9, eps_method=method)
        sim = Simulation(cfg, disks, device=device, use_kernels=False)
        sim.run(steps)
        F, _ = sim.hydro_forces()
        u_mean = (2.0 / 3.0) * cfg.u_inlet
        cd = float(F[0, 0]) / (0.5 * cfg.rho0 * u_mean**2 * 20.0)
        out[method] = cd
        print(f"  {method} ({describe_path(sim)}): cD = {cd:.4f} "
              f"({abs(cd - 5.5795) / 5.5795:+.2%} vs 5.5795)", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="ab_eps")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    ap.add_argument("--bf16", action="store_true",
                    help="also bench sample vs ramp on bf16 storage")
    ap.add_argument("--cylinder", action="store_true",
                    help="also Schafer-Turek 2D-1 cD per coverage model")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    label = device_label(device)
    print(f"device: {label}", flush=True)
    print("settling delta (128x256, kernels):", flush=True)
    out = {"settling_delta": settling_delta(device)}
    print("bench 4096^2/10k coupled:", flush=True)
    ms = bench_coupled("float32", eps_method="sample", device=device)
    mr = bench_coupled("float32", eps_method="ramp", device=device)
    print(f"ramp speedup (f32): {mr / ms:.3f}x on {label}", flush=True)
    out.update(sample=ms, ramp=mr)
    if args.bf16:
        msb = bench_coupled("bfloat16", eps_method="sample", device=device)
        mrb = bench_coupled("bfloat16", eps_method="ramp", device=device)
        print(f"ramp speedup (bf16 storage): {mrb / msb:.3f}x on {label}",
              flush=True)
        out.update(sample_bf16=msb, ramp_bf16=mrb)
    if args.cylinder:
        print("schafer-turek 2D-1 drag (D=20):", flush=True)
        out["cd"] = cylinder_drag_delta(device)
    return out


if __name__ == "__main__":
    main()
