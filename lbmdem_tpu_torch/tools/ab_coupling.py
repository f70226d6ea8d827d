"""A/B of coupling-cadence temporal blocking (cfg.coupling_k) on the card.

Counterpart of the JAX package's `tools/ab_coupling.py`, in one process:
  1. the physics gate first, for every k > 1 to be benched: the
     validation's couplingk leg (settling against the float64 per-step
     golden, 1 % budget) - a tier that fails physics is not benched
     into the record (AB_SKIP_GATE=1 skips it when the gate already ran);
  2. the coupled bench at 4096^2/10k (`ab_bf16.bench_coupled`): f32 and
     bf16 + ramp, k = 1 against k = 4 by default; BENCH_KS overrides the
     k list (e.g. BENCH_KS=1,4,8).

    python -m lbmdem_tpu_torch.tools.ab_coupling [--device cpu]

It runs on the card unless given --device cpu, and raises without a
card; every speed is printed with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import os

from lbmdem_tpu_torch.tools.ab_bf16 import bench_coupled
from lbmdem_tpu_torch.tools.common import device_label, require_device
from lbmdem_tpu_torch.tools.validate import coupling_k


def bench_ks(env=None) -> tuple:
    """The k list: BENCH_KS (comma-separated) of `env` (default
    os.environ), else (1, 4)."""
    env = os.environ if env is None else env
    if env.get("BENCH_KS"):
        return tuple(int(k) for k in env["BENCH_KS"].split(","))
    return (1, 4)


def main(argv=None, env=None):
    """Gate every k > 1 (unless AB_SKIP_GATE), then bench; returns
    {(storage, eps_method, k): MLUPS}."""
    ap = argparse.ArgumentParser(prog="ab_coupling")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    env = os.environ if env is None else env
    device = require_device(args.device)
    label = device_label(device)
    print(f"device: {label}", flush=True)
    ks = bench_ks(env)
    if not env.get("AB_SKIP_GATE"):
        for k in sorted({k for k in ks if k > 1}):
            coupling_k(device, k)
    results = {}
    for storage, eps in (("float32", None), ("bfloat16", "ramp")):
        for k in ks:
            results[(storage, eps, k)] = bench_coupled(
                storage, coupling_k=k, eps_method=eps, device=device)
    print(f"coupling-cadence A/B (4096^2/10k, MLUPS on {label}):",
          flush=True)
    for (storage, eps, k), v in results.items():
        name = storage + (f"+{eps}" if eps else "")
        print(f"  {name} k={k}: {v:.0f}", flush=True)
    return results


if __name__ == "__main__":
    main()
