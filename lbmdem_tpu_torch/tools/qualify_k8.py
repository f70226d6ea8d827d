"""Qualify the coupling_k window tiers at 8192^2 with 40 000 disks on the
card.

Counterpart of the JAX package's `tools/qualify_k8.py`: the column
collapse at 8192^2 with coupling_k k, f_storage `storage` and
eps_method `eps` (defaults 8, bfloat16, ramp: the largest stage of
`bench.py`), in chunks of 48 steps (a multiple of the binning cadence,
as the bench's stage geometry), through `Simulation`: per window K1 and
K6, per inner step K3w (k = 1: K1, K2, K3 per step). Prints and checks
what `qualify_8192` does (the DEM axis, the slab plane, cold and best
run(48), MLUPS beside the card's name and power limit, peak memory,
overflow 0, finite, no zero population, mass drift within 1e-5, bf16
1e-4).

    python -m lbmdem_tpu_torch.tools.qualify_k8 [k] [storage] [eps]
        [--device cpu]

`python -m lbmdem_tpu_torch.tools.qualify_k8 4 float32 sample` is the
f32 window tier. It runs on the card unless given --device cpu, and
raises without a card.
"""

from __future__ import annotations

import argparse

from lbmdem_tpu_torch.tools.qualify_8192 import make_sim, run_stage

CHUNK = 48


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="qualify_k8")
    ap.add_argument("k", nargs="?", type=int, default=8)
    ap.add_argument("storage", nargs="?", default="bfloat16")
    ap.add_argument("eps", nargs="?", default="ramp")
    ap.add_argument("--device", default="cuda", help="cuda or cpu")
    args = ap.parse_args(argv)
    sim = make_sim(k=args.k, storage=args.storage, eps=args.eps,
                   device=args.device)
    print(f"k={args.k} storage={args.storage} eps={args.eps}", flush=True)
    res = run_stage(sim, CHUNK, log=lambda s: print(s, flush=True))
    print("QUALIFY-K8 OK", flush=True)
    return res


if __name__ == "__main__":
    main()
