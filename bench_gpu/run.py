"""The benchmark of lbmdem_tpu_torch on one NVIDIA H100: one cell, one
process, one JSON line.

    python3 -m bench_gpu.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (timed as setup_s, from the process's start): the kernels'
library (built into lbmdem_tpu_torch/_build/ on the first run of a
checkout), the cell's scene from --seed (bench_gpu/scenes.py), the
`Simulation`, and the checked calls `sim.run(first_steps)` and
`sim.run(check_steps - first_steps)`, which drive every kernel and
shape the window uses; their states are copied to the host. Then the
window: `sim.run(chunk)` again and again until --seconds have passed,
each call ended by the program's own device synchronize; mlups is the
lattice's cells times every step the window completed over the
window's wall seconds. With --trace 1 torch.profiler records the
window's first seconds (bench_gpu/trace.py) and the line carries the
per-layer metrics instead (bench_gpu/metrics/). After the window: the
peak memory (over set-up and window, and over the window alone), the
guarantees at the window's end,
the program freed, then the plain reference (bench_gpu/reference/) over
the checked calls' steps from the same inputs, and the comparison
(bench_gpu/check.py). The check's numbers are the last lines on
standard error and the last key of the result, the last line on
standard output.

It exits 2 without a result where the card or the chips the cell asks
for are missing, and 3 where the process has loaded JAX or the JAX
package (compared by whole top-level module names).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402
from typing import Callable, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "lbmdem_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (the part before the first dot, compared whole: lbmdem_tpu_torch is
    not lbmdem_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in list(names)} & set(FORBIDDEN))


def power_limit():
    """The card's power limit as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout
        return float(out.splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def set_up(cell, sim_kw: dict, scene, device: str, t0: float):
    """The program built from the scene and driven through the checked
    calls: (sim, the two calls' host snapshots, setup_s, the set-up's
    parts in seconds)."""
    import torch

    from bench_gpu import check
    from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation, kernels

    w = cell.workload
    cuda = device == "cuda"
    parts = {"imports": time.perf_counter() - t0}
    t = time.perf_counter()
    if cuda:
        kernels.library()
    parts["library"] = time.perf_counter() - t
    t = time.perf_counter()
    dk = scene.disks
    disks = [] if dk is None else [
        DiskSpec(*row) for row in zip(*(dk[q].tolist() for q in
                                        ("x", "y", "r", "vx", "vy",
                                         "omega", "fixed")))]
    # a start flow is the program's input, like a restart's populations:
    # made before the peak is reset, so that its making does not count
    start = (None if scene.start_f is None
             else check.to_storage(scene.start_f(device), sim_kw))
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    parts["inputs"] = time.perf_counter() - t
    t = time.perf_counter()
    sim = Simulation(SimConfig(**sim_kw), disks, device=device)
    if start is not None:
        sim.state = sim.state._replace(f=start)
        del start
    if cuda:
        torch.cuda.synchronize()
    parts["simulation"] = time.perf_counter() - t
    t = time.perf_counter()
    first = int(w["first_steps"])
    sim.run(first)
    t_copy = time.perf_counter()
    snap1 = check.snapshot(sim, sim_kw)
    t_copy = time.perf_counter() - t_copy
    sim.run(int(w["check_steps"]) - first)
    parts["checked_calls"] = time.perf_counter() - t - t_copy
    # set-up without the check's copy of the first call's state
    setup_s = time.perf_counter() - t0 - t_copy
    return sim, (snap1, check.snapshot(sim, sim_kw)), setup_s, parts


def window(sim, chunk: int, seconds: float, recorder, trace_s: float,
           cuda: bool):
    """`sim.run(chunk)` until `seconds` have passed: (steps, calls, wall
    seconds, (steps, seconds) of the traced part). Under `recorder`
    (trace.Recorder) the profiler records the calls of the window's
    first `trace_s` seconds and stops after the call that reaches them;
    the window then runs on untraced."""
    import torch

    if recorder is not None:
        recorder.__enter__()
    if cuda:
        torch.cuda.synchronize()
    tw = time.perf_counter()
    steps = calls = 0
    traced = None
    while True:
        sim.run(chunk)
        steps += chunk
        calls += 1
        elapsed = time.perf_counter() - tw
        if recorder is not None and traced is None and (
                elapsed >= trace_s or elapsed >= seconds):
            traced = (steps, elapsed)
            recorder.__exit__(None, None, None)
            elapsed = time.perf_counter() - tw
        if elapsed >= seconds:
            break
    return steps, calls, time.perf_counter() - tw, traced


def per_layer(cell, tr, sim_kw: dict, scene, d0, p, lbm_dem,
              window_peak: int) -> dict:
    """The cell's per-layer metrics from the reduced trace `tr`, with the
    work counts' geometry worked out from the scene's start by the
    reference module `lbm_dem`, and the window's own memory peak."""
    from bench_gpu import roofline, spec
    from bench_gpu import trace as tracing

    if d0 is None:
        window_cells = solid = pairs = 0
    else:
        window_cells = lbm_dem.window_cells(float(d0.r.max()))
        solid = lbm_dem.solid_cells(d0, p)
        pairs = int((lbm_dem.neighbour_pairs(d0) >= 0).sum())
    ctx = types.SimpleNamespace(
        trace=tr, work=tracing.kernel_files(), window_peak_bytes=window_peak,
        geometry=roofline.geometry(sim_kw, scene.disks, solid, pairs,
                                   window_cells))
    out = {}
    for m in cell.per_layer:
        v = spec.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str,
             t0: float, program_sim: Optional[dict] = None,
             alter: Optional[Callable[[dict], None]] = None,
             program_scene: Optional[Callable] = None) -> dict:
    """One run of `cell` (spec.Cell): the result's fields and the check.
    device "cpu" runs the program's plain versions (the harness's tests);
    the benchmark runs on "cuda". `program_sim` (fields of the program's
    SimConfig alone), `alter` (called on the second checked call's
    snapshot) and `program_scene` (scenes.Scene -> the Scene the program
    alone is given) plant faults for the calibration and the tests."""
    import torch

    from bench_gpu import check, scenes
    from bench_gpu import trace as tracing

    # the configuration's plain reference, bench_gpu/reference/<name>.py
    lbm_dem = importlib.import_module(
        f"bench_gpu.reference.{cell.config['reference']}")
    cuda = device == "cuda"
    w = cell.workload
    k = int(w.get("coupling_k", 1))
    sim_kw = dict(cell.config["sim"], coupling_k=k)
    first, check_steps = int(w["first_steps"]), int(w["check_steps"])
    scene = scenes.build(cell.config, w, seed)
    sim, (snap1, snap2), setup_s, parts = set_up(
        cell, dict(sim_kw, **(program_sim or {})),
        scene if program_scene is None else program_scene(scene), device, t0)
    if alter is not None:
        alter(snap2)
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()

    rec = tracing.Recorder() if trace else None
    trace_s = float(w.get("trace_seconds", tracing.TRACE_SECONDS))
    steps, calls, window_s, traced = window(sim, int(w["chunk"]), seconds,
                                            rec, trace_s, cuda)
    stages = {"setup": setup_s, **parts, "window": window_s}
    t_after = time.perf_counter()
    window_peak = torch.cuda.max_memory_allocated() if cuda else 0
    peak = max(setup_peak, window_peak)
    end = check.window_end(sim, sim_kw)
    del sim
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    p = lbm_dem.Params.from_sim(sim_kw)
    f0 = (scene.start_f(device) if scene.start_f is not None
          else lbm_dem.equilibrium_rest(p, device))
    mass0 = check.mass(f0, dict(sim_kw, f_storage="float32"))
    dk = scene.disks
    d0 = None if dk is None else lbm_dem.make_disks(
        dk["x"], dk["y"], dk["r"], dk["vx"], dk["vy"], dk["omega"], p, device,
        fixed=dk["fixed"])
    res = {}
    if rec is not None:
        tr = tracing.reduce(rec, traced[1], traced[0])
        del rec
        stages["trace"] = time.perf_counter() - t_after
        res["metrics"] = per_layer(cell, tr, sim_kw, scene, d0, p, lbm_dem,
                                   window_peak)
        res["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                            "idle_gaps": [list(x) for x in tr.idle_gaps]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s}
    else:
        values = {"mlups": sim_kw["nx"] * sim_kw["ny"] * steps / window_s
                  / 1e6,
                  "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s}
        res["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in cell.end_to_end}
        extra = {}

    t_ref = time.perf_counter()
    f_ref, d_ref, _ = lbm_dem.advance(f0, d0, p, first, k)
    nums = {"first_f_gap": check.first_gap(snap1, f_ref, sim_kw)}
    del snap1
    f_ref, d_ref, info = lbm_dem.advance(f_ref, d_ref, p, check_steps - first,
                                         k)
    got, worst = check.compare(snap2, f_ref, d_ref, info.get("contacts"),
                               sim_kw)
    nums.update(got)
    nums.update(check.guarantees(end, mass0, check_steps + steps))
    lim = check.limits(w, cell.config)
    judged = check.judge(nums, lim)
    stages["reference"] = time.perf_counter() - t_ref
    stages["after_window"] = time.perf_counter() - t_after
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": cell.chips if cuda else 0,
                   "memory_peak_bytes": int(peak), **extra}
    if cuda:
        device_info["power_limit_w"] = power_limit()
    failed = sum(not ok for _, _, _, ok in judged)
    return {"correct": failed == 0, "attempted": len(judged),
            "failed": failed, "device": device_info, **res,
            "steps": steps, "calls": calls, "stages": stages,
            "numbers": nums, "disk_errors": worst,
            "info": check.info_line(nums, lim),
            "check": {n: {"value": v, "limit": lm} for n, v, lm, _ in judged}}


def emit(res: dict) -> None:
    """The run's stages, the information numbers and the check's numbers
    on standard error (the check's last), then the result as the last
    line on standard output (the check its last key)."""
    print("seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                  res["stages"].items()), file=sys.stderr)
    if res["info"]:
        print(res["info"], file=sys.stderr)
    print(f"window: {res['steps']} steps in {res['calls']} calls",
          file=sys.stderr)
    for n, c in res["check"].items():
        ok = "within" if c["value"] <= c["limit"] else "OVER"
        print(f"check {n} {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    keys = ("correct", "attempted", "failed", "metrics", "device",
            "breakdown", "check")
    print(json.dumps({k: res[k] for k in keys if k in res}), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    import lbmdem_tpu_torch  # noqa: F401  (a checkout without it fails here)
    from bench_gpu import spec

    cell = spec.cell(spec.load_benchmark(), args.workload)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"bench_gpu: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees {have}", file=sys.stderr)
        return 2
    res = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T0)
    bad = forbidden_modules()
    if bad:
        print(f"bench_gpu: the process loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    emit(res)
    return 0


if __name__ == "__main__":
    sys.exit(main())
