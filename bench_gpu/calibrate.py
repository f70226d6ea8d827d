"""The readings that the check's limits are set from, on the card.

    python3 -m bench_gpu.calibrate --workload <cell> --seeds 11 12 ... \
        --control-seeds 21 22 23 [--faults contact minority] [--seconds 0]

For each seed, in one process: the cell's set-up, its checked calls, a
window of --seconds (0: one call) and the check (`run.run_cell`),
printing every number of the check and the shares of disks whose error
is over a few thresholds; then the control: the same with the
program's own bfloat16 storage (f_storage="bfloat16", the step below
the configuration's float32) on the control seeds; then each planted
fault on the control seeds:

    contact    the program's contact law off: its normal stiffness and
               damping (kn, gamma_n) 25 % high, the reference's as
               configured
    minority   one disk in 64 altered where it is produced: its velocity
               and spin after the checked calls scaled by 1 + 1e-3
    unfixed    a bed's fixed disks given to the program as mobile ones
               (the reference keeps them fixed): the program then runs
               the coupled path with its DEM, not the static hoist

Last, per number, the largest reading of the program's runs (the lower
reading) and the smallest of the control's and of each fault's. The
benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
import time

import numpy as np
import torch

from bench_gpu import run, spec

THRESHOLDS = (1e-5, 3e-5, 1e-4, 3e-4, 1e-3)


def _minority(snap: dict) -> None:
    for q in ("v", "omega"):
        snap[q][::64] *= 1.0 + 1e-3


def _unfixed(scene):
    return scene._replace(disks=dict(
        scene.disks, fixed=np.zeros_like(scene.disks["fixed"])))


def faults(cell) -> dict:
    """The planted faults: run_cell's keyword arguments by name."""
    sim = cell.config["sim"]
    return {"contact": {"program_sim": {"kn": 1.25 * sim["kn"],
                                        "gamma_n": 1.25 * sim["gamma_n"]}},
            "minority": {"alter": _minority},
            "unfixed": {"program_scene": _unfixed}}


def readings(cell, seeds, seconds: float, label: str, **plant) -> list:
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        res = run.run_cell(cell, seed, seconds, False, "cuda", t0, **plant)
        rec = {"kind": label, "seed": seed, "correct": res["correct"],
               "seconds": time.perf_counter() - t0, **res["numbers"]}
        err = res["disk_errors"]
        if err is not None:
            rec.update({f"off@{t:g}": float((err > t).double().mean())
                        for t in THRESHOLDS})
            rec["err_p99"] = float(torch.quantile(err.float(), 0.99))
            rec["err_max"] = float(err.max())
        print(json.dumps(rec), flush=True)
        out.append(rec)
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=0.0)
    args = ap.parse_args(argv)
    cell = spec.cell(spec.load_benchmark(), args.workload)
    prog = readings(cell, args.seeds, args.seconds, "program")
    ctrl_cell = copy.deepcopy(cell)
    ctrl_cell.config["sim"]["f_storage"] = "bfloat16"
    others = {"control": readings(ctrl_cell, args.control_seeds,
                                  args.seconds, "control")}
    planted = faults(cell)
    for name in args.faults:
        others[name] = readings(cell, args.control_seeds, args.seconds, name,
                                **planted[name])
    for k in sorted(k for k in prog[0] if k not in
                    ("kind", "seed", "correct", "seconds")):
        lo = max(r[k] for r in prog)
        line = f"{args.workload} {k}: program max {lo!r} over {len(prog)}"
        for name, rows in others.items():
            hi = min((r[k] for r in rows), default=float("nan"))
            line += f"; {name} min {hi!r}"
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
