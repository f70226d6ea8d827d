"""The kernels of two checkouts of the repository on the same card
inputs, each through its own Python entry points in a process of its
own, timed in turns (A, B, B, A) with a digest of every output, so that
a redesign shows its speed beside the tree it replaces and whether it
agrees bit for bit.

    python -m lbmdem_tpu_torch.tools.ab A_DIR B_DIR [OUT.json]

A_DIR and B_DIR hold unpacked trees of the repository (for instance
`git archive <commit> | tar -x -C _checkout/parent`). Each worker runs
this file as a script with its tree first on PYTHONPATH, so it builds and
loads that tree's kernels (`kernels.library()`) and calls only the
wrappers a user calls, whose signatures outlive the C entry points':
`stamp_fields`, `fused_step_fluid`, `fused_step_fluid_multi`,
`fused_step_imb_reduce`, `fused_step_imb_reduce_multi`,
`fused_step_imb_static_multi`, `fused_step_imb`, `subcycle_slabs` and
`subcycle_slabs_window`.

Cases: K4 and K5 (k = 4, 8; bf16 also 16) at 4096^2 (tau 0.8, gx 1e-6,
periodic x, f = w_i (1 + 0.02 N(0, 1))), f32 and bf16; K1 (the stamp),
K2 and K6 (k = 4) on the 4096^2 / 10k-disk column packed into contact
(positions scaled by 0.94) and K7 (k = 4) on a 4096^2 porous bed of
4096 fixed disks of r = 4, f32 and bf16, under BGK and under TRT (K1
and K8, the split step on the packed column, f32 only); K3, K3w, both
with springs (kt = 25, two subcycles first so live springs are
carried), and K3 on a periodic x axis, on the packed column with seeded
velocities and forces. The inputs are made by each tree's own code and
digested too, so a line says whether both trees saw the same inputs.
CUDA-event ms per call after a warm call (the slab kernels run on in
place); the first worker of each tree also digests the outputs (sha256
of their bytes) of a call on the fresh inputs.
Prints one line per case and the card's name and power limit, and
writes every number to OUT.json when given. Needs one CUDA device.
"""

from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

_N = 4096


def _log(msg: str) -> None:
    print(f"[ab] {msg}", flush=True)


def digest(*tensors) -> str:
    """sha256 of the tensors' bytes (any dtype), in order."""
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().reshape(-1).view(torch.uint8)
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def cuda_ms(fn, iters: int) -> float:
    """Mean CUDA-event time of fn() over `iters` calls, after a warm call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def fluid_cases():
    """(name, inputs, run, outputs) of K4 and K5 at 4096^2."""
    from lbmdem_tpu_torch import SimConfig, lattice
    from lbmdem_tpu_torch.ops import fused_fluid, lbm

    for storage, ks in (("float32", (1, 4, 8)), ("bfloat16", (1, 4, 8, 16))):
        cfg = SimConfig(nx=_N, ny=_N, tau=0.8, gx=1e-6, dtype="float32",
                        f_storage=storage)
        g = torch.Generator(device="cuda").manual_seed(7)
        w = torch.as_tensor(lattice.W, dtype=torch.float32, device="cuda")
        f = lbm.to_storage(w[:, None, None] * (1.0 + 0.02 * torch.randn(
            (9, _N, _N), generator=g, device="cuda")), cfg)
        out = torch.empty_like(f)
        for k in ks:
            name = f"K4 {storage}" if k == 1 else f"K5 {storage} k={k}"
            def run(fresh=False, k=k, cfg=cfg, f=f, out=out):
                fused_fluid.fused_step_fluid_multi(f, cfg, k, out)

            yield name, (f,), run, lambda out=out: (out,)


def _packed_column():
    from lbmdem_tpu_torch import DiskSpec
    from lbmdem_tpu_torch.models import column_collapse

    cfg, disks = column_collapse()
    return cfg, [DiskSpec(d.x * 0.94, d.y * 0.94, d.r) for d in disks]


def block_cases():
    """K1; K2, K6 and K7 (k = 4), f32 and bf16, BGK then TRT; K8, f32,
    BGK and TRT."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import porous_bed
    from lbmdem_tpu_torch.ops import fused_lbm, fused_static, lbm, stamp

    cfg, disks = _packed_column()
    sim = Simulation(cfg, disks, device="cuda")
    d = sim.state.disks
    td, cnt, _, _ = stamp.bin_disks_to_tiles(d.x, d.v, d.omega, d.r,
                                             d.active, sim.cfg)
    solid = stamp.stamp_fields(td, cnt, sim.cfg)
    bed = Simulation(*porous_bed(nx=_N, ny=_N, r=4.0, pitch=64),
                     device="cuda")
    bsolid = bed._static_solid_operands()
    stamped = {}

    def stamp_run(fresh=False):
        stamped["s"] = stamp.stamp_fields(td, cnt, sim.cfg)

    yield "K1", (td, cnt), stamp_run, lambda: (stamped["s"],)
    g = torch.Generator(device="cuda").manual_seed(9)
    for storage, coll in (("float32", "bgk"), ("bfloat16", "bgk"),
                          ("float32", "trt"), ("bfloat16", "trt")):
        for name, c, ins in (("K2", sim.cfg, (solid, td, cnt)),
                             ("K6", sim.cfg, (solid, td, cnt)),
                             ("K7", bed.cfg, (bsolid,))):
            c = c.replace(f_storage=storage, collision=coll)
            f = lbm.to_storage(lbm.init_equilibrium(c, "cuda") * (
                1.0 + 0.02 * torch.randn((9, c.ny, c.nx), generator=g,
                                         device="cuda")), c)
            out = torch.empty_like(f)
            res = {}
            if name == "K2":
                def run(fresh=False, f=f, c=c, out=out, res=res):
                    res["p"] = fused_lbm.fused_step_imb_reduce(
                        f, solid, td, cnt, c, out)[1]

                def outs(out=out, res=res):
                    return (out, res["p"])
            elif name == "K6":
                def run(fresh=False, f=f, c=c, out=out, res=res):
                    res["p"] = fused_lbm.fused_step_imb_reduce_multi(
                        f, solid, td, cnt, c, 4, out)[1]

                def outs(out=out, res=res):
                    return (out, res["p"])
            else:
                def run(fresh=False, f=f, c=c, out=out):
                    fused_static.fused_step_imb_static_multi(f, bsolid, c, 4,
                                                             out)

                def outs(out=out):
                    return (out,)
            tag = ("" if coll == "bgk" else " trt") + (
                "" if name == "K2" else " k=4")
            yield f"{name} {storage}{tag}", (f, *ins), run, outs
            if name == "K2" and storage == "float32":
                res8 = {}

                def run8(fresh=False, f=f, c=c, out=out, res=res8):
                    res["phi"] = fused_lbm.fused_step_imb(
                        f, solid[0], solid[1], solid[2], c, out)[1:]

                yield (f"K8 float32{'' if coll == 'bgk' else ' trt'}",
                       (f, solid), run8,
                       lambda out=out, res=res8: (out, *res["phi"]))


def slab_cases():
    """K3, K3w (with and without springs) and K3 on a periodic x axis."""
    from lbmdem_tpu_torch import DiskSpec, Simulation
    from lbmdem_tpu_torch.ops import dem, slab_dem

    cfg, disks = _packed_column()
    rng = np.random.default_rng(3)

    def rnd(shape, amp):
        return torch.as_tensor(rng.uniform(-amp, amp, shape),
                               dtype=torch.float32, device="cuda")

    def case(name, c, grid, axis, sl, f3):
        slabs, kmax, n_occ, bands = sl[0], sl[3], sl[4], sl[5]
        s = slabs.clone()
        res = {}

        def run(fresh=False):  # in place: timed calls run on and on
            if fresh:
                s.copy_(slabs)
            if f3 is None:
                res["n"] = slab_dem.subcycle_slabs(s, kmax, n_occ, bands,
                                                   grid, c, axis)[1]
            else:
                res["n"] = slab_dem.subcycle_slabs_window(
                    s, f3, kmax, n_occ, bands, grid, c, axis)[1]

        ins = (slabs, kmax, n_occ, bands) + (() if f3 is None else (f3,))
        return name, ins, run, lambda: (s, res["n"])

    for kt in (0.0, 25.0):
        sim = Simulation(cfg.replace(kt=kt), disks, device="cuda")
        c, grid, axis = sim.cfg, sim.grid, sim.dem_axis
        d = sim.state.disks
        n = d.x.shape[0]
        d = d._replace(v=rnd((n, 2), 0.02), omega=rnd((n,), 2e-3))
        F, T = rnd((n, 2), 1e-3), rnd((n,), 1e-4)
        if kt:
            for _ in range(2):
                d, _, _ = slab_dem.dem_subcycle(d, F, T, grid, c, axis)
        body = dem.body_forces(d, c)
        tag = " kt" if kt else ""
        sl = slab_dem.build_slabs(d, F, T, body, grid, axis, kt=kt > 0)
        yield case(f"K3{tag}", c, grid, axis, sl, None)
        sw = slab_dem.build_slabs(d, None, None, body, grid, axis,
                                  kt=kt > 0, bake_forces=False)
        f3 = slab_dem._force_planes_window(sw[1], [(F, T)], body,
                                           sw[0].shape)[0]
        yield case(f"K3w{tag}", c, grid, axis, sw, f3)
    pcfg = cfg.replace(bc_west="periodic", bc_east="periodic")
    shift = 0.04 * cfg.nx
    psim = Simulation(pcfg, [DiskSpec((s.x - shift) % cfg.nx, s.y, s.r)
                             for s in disks], device="cuda")
    pd = psim.state.disks
    n = pd.x.shape[0]
    pd = pd._replace(v=rnd((n, 2), 0.02), omega=rnd((n,), 2e-3))
    F, T = rnd((n, 2), 1e-3), rnd((n,), 1e-4)
    sl = slab_dem.build_slabs(pd, F, T, dem.body_forces(pd, psim.cfg),
                              psim.grid, psim.dem_axis)
    yield case("K3 periodic", psim.cfg, psim.grid, psim.dem_axis, sl, None)


def worker(out_path: str, with_digests: bool) -> None:
    """Run every case on this process's tree; write {name: {...}}."""
    from lbmdem_tpu_torch import kernels

    kernels.library()
    res = {}
    for cases, iters in ((fluid_cases, 10), (block_cases, 10),
                         (slab_cases, 20)):
        for name, ins, run, outs in cases():
            row = {"ms": cuda_ms(run, iters)}
            if with_digests:
                run(fresh=True)
                torch.cuda.synchronize()
                row["inputs"] = digest(*ins)
                row["outputs"] = digest(*outs())
            res[name] = row
        torch.cuda.empty_cache()
    with open(out_path, "w") as fh:
        json.dump(res, fh)


def run_worker(tree: str, with_digests: bool) -> dict:
    tree = os.path.abspath(tree)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--worker", path]
        if with_digests:
            cmd.append("--digests")
        env = {**os.environ, "PYTHONPATH": tree}
        res = subprocess.run(cmd, cwd=tree, env=env, capture_output=True,
                             text=True, timeout=1800)
        if res.returncode != 0:
            raise RuntimeError(f"worker on {tree} failed:\n{res.stderr}")
        with open(path) as fh:
            return json.load(fh)


def main(argv) -> int:
    if len(argv) >= 2 and argv[1] == "--worker":
        worker(argv[2], "--digests" in argv)
        return 0
    if len(argv) not in (3, 4):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("ab: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    a, b = argv[1], argv[2]
    _log(f"card {smi}; A {a}, B {b}; in turns A, B, B, A")
    runs = [run_worker(a, True), run_worker(b, True), run_worker(b, False),
            run_worker(a, False)]
    ra, rb = runs[0], runs[1]
    table = {}
    for name in ra:
        if name not in rb:
            continue
        same_in = ra[name]["inputs"] == rb[name]["inputs"]
        same = ra[name]["outputs"] == rb[name]["outputs"]
        ta = [runs[0][name]["ms"], runs[3][name]["ms"]]
        tb = [runs[1][name]["ms"], runs[2][name]["ms"]]
        table[name] = {"a_ms": ta, "b_ms": tb, "inputs_equal": same_in,
                       "outputs_equal": same}
        _log(f"{name}: A {ta[0]:.4f}, {ta[1]:.4f} ms; B {tb[0]:.4f}, "
             f"{tb[1]:.4f} ms per call (CUDA events); inputs equal {same_in},"
             f" outputs equal {same}")
    if len(argv) == 4:
        with open(argv[3], "w") as fh:
            json.dump({"card": smi, "a": a, "b": b, "cases": table}, fh,
                      indent=1)
    _log(f"done on {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
