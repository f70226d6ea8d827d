"""Drive the PyTorch + CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure raises and exits non-zero, and
nothing falls back to the CPU):

1. probe: the card, its power limit, nvcc, CUDA_HOME, triton;
2. build: compile lbmdem_tpu_torch/csrc/*.cu into lbmdem_tpu_torch/_build/
   and print each kernel entry's registers and spills (ptxas); the f32
   and bf16 BGK instantiations of K2's step, of the K6/K7 temporal block
   and of K5's row sweep (its sweeps through f32 scratch too) must not
   spill;
3. kernels: K1 stamp, K2 fused IMB step + reduce, K3 slab DEM, K6
   coupled temporal block (k = 2, 4, 8; at 4096^2 k = 2, 4) and K3w
   window slab DEM (4 chained calls), each against its plain PyTorch
   version (K6: on CPU copies of the inputs) on a small scene and at
   the slice's shapes
   (column_collapse: 4096^2, 10k disks), with CUDA-event times of kernel
   and plain version (on the card) at the slice's shapes;
4. slice: Simulation(*column_collapse(), device="cuda"), run(100) to
   warm, run(100) timed: MLUPS, launch counts, overflow, finiteness,
   mass conservation, disk motion;
5. slice vs CPU: 16 steps of a 256^2 column collapse on the card against
   the same run on CPU tensors (the plain versions);
5w. window slice: phase 4 with coupling_k=4 (K1 + K6 once per window,
   K3w per inner step), its MLUPS beside phase 4's; the 256^2 window
   run (19 steps) against CPU tensors; the couplingk settling leg
   through lbmdem_tpu_torch/tools/validate.py (128x192, f32, 3000
   steps, vy within 1 % of the f64 golden over the second half);
6. fluid kernels: K4 (one pure-fluid step) and K5 (k steps per pass)
   against their plain versions on the card, over the lattice-option
   matrix at 256x64 (and two domains smaller than a tile), f32 and
   shifted-bf16 storage, then at 4096^2 with CUDA-event times;
7. fluid slice: Simulation(SimConfig(nx=4096, ny=4096, tau=0.8,
   gx=1e-6), device="cuda") for f32 and bf16 storage, run(400) to warm,
   run(400) timed: MLUPS, launch counts (K5 100, K4 0; then run(19): K5
   4, K4 3), finiteness, mass;
8. Poiseuille on the card (models.poiseuille, 64^2, 20 ny^2 steps)
   against the analytic parabola;
9. fluid vs CPU: a 256x64 Zou/He channel and a 128^2 lid-driven cavity,
   19 steps each, on the card against CPU tensors;
10. static kernel: K7 (k coupled steps over a constant solid stack)
   against its plain version on CPU copies of the inputs over the
   lattice-option matrix at 256x64 (k = 1, 4, 8; f32 and bf16), then at
   4096^2 on the static scene (k = 4) with CUDA-event times of the
   kernel and of the plain version on the card, beside the pass's
   memory floor;
11. static slice: Simulation(*static_bed(), device="cuda") - bench.py's
   static/4096 scene, 4096 fixed disks at rest - for f32 and bf16
   storage: run(400) to warm, run(400) timed: MLUPS, launch counts (K1
   once over the run's life, then K7 100 per run(400) and nothing
   else), mass, finiteness, overflow, and torch.profiler's device time
   per step and idle share;
12. periodic ghosts: a 256^2 porous bed offset by half a pitch (disks on
   the seams and corners, fully periodic): its ghost count, run(40) on
   the card against the CPU run, hydro_forces() against the CPU's;
13. drift: a 256^2 periodic-x channel with a fixed disk at rest and one
   moving at vx = 0.01, run(19) on the card against the CPU run, the
   moving disk at x0 + 19 vx, launches K1 + K2 per step and no K7;
14. split kernels: K8 (fused_step_imb, one coupled step emitting phi)
   against its plain version on CPU copies over the lattice-option
   matrix at 256x64; then on the packed 256^2 and 4096^2 scenes for
   eps_method sample, ramp, exact and sample with eps_r_shift: K1 against
   its plain version (the coverage of every method), K8 + K9
   (reduce_hydro_forces) against K2 on the same input (f' equal, forces
   1e-6), K9 against its plain version, K2's reduce against its plain
   version under ramp and exact; K8 and K9 timed at 4096^2 (phase 3
   holds the sample path's K1/K2/K3 as before);
15. cell-list DEM: dem.dem_subcycle on the card against the CPU on
   phase 3's packed copy (contacts equal, x/v/omega 1e-4);
16. ramp slice: phase 4 with eps_method="ramp", its MLUPS beside phase
   4's sample MLUPS, overflow and mass gates; K8 and K2 timed on the
   run's own state; the 256^2 ramp run against the CPU;
17. ablation: lbmdem_tpu_torch.tools.ablate's f32 variants at
   4096^2/10k disks (chunk 20; K1, K8, K9 and the slab DEM per step,
   "fused" with K2), then the coupling_k = 4 window set, then the bf16
   set (every variant on the K2 step), each row and the marginals;
18. lattice breadth: K2 and K6 (k = 2, 4) over the lattice-option matrix
   (TRT, LES, lambda, moving walls, Zou/He, periodic, all at once) at
   256x64 on f32 and shifted-bf16 storage against their plain versions
   on CPU copies, and on f32 K8 + K9 against K2 bit for bit; then K2 and
   K6 at 4096^2 on bf16 and under TRT + LES, timed beside the f32 BGK
   instantiation and their byte bounds;
19. DEM breadth: K3 and K3w with history springs (kt = 25, live springs
   carried in) and K3 on a periodic axis under both slab orientations
   against their plain versions, every slab channel, at 256^2 and at the
   slice's shapes (4096^2, 10k disks), timed beside kt = 0;
20. bf16 coupled slices: phase 4 and 5w's slice with
   f_storage="bfloat16" (coupling_k 1 and 4), MLUPS beside the f32
   slices', mass drift < 1e-4, overflow 0; the 256^2 bf16 and kt runs
   (per step and per window) against CPU tensors; the 4096^2 / 10k-disk
   slice packed into contact with kt = 25, per step and per window (the
   slab DEM with springs at full width);
21. open channel: a 512x256 Zou/He channel under TRT + LES with a
   mobile disk that leaves through the outlet and is culled, the card
   against CPU tensors;
22. decks: examples/column_collapse_friction.par (2048^2, 2 500 disks,
   kt = 25) and examples/periodic_channel.par, the card against CPU
   tensors, then the friction deck through coupling_k = 4 windows;
23. coverage sweep (after phase 3's small scene): K1 against its plain
   version bit for bit for sample (ns 2, 3, 4, 5, 8), ramp and exact,
   with and without eps_r_shift, on a 512^2 scene of sub-cell centres and
   rims through sample points, with an empty tile and a full one (count
   == cap) and windows clipped by tiles and the domain; on the same
   scenes K2's and K9's reduces against the plain one, K8 + K9 == K2 bit
   for bit, and the zero rows past every tile's count;
24. boundary matrix: K2 on a 240x80 lattice (no multiple of the 32-wide
   step blocks) with four walls and a moving lid, fully periodic,
   periodic x with walls on y, and Zou/He with walls, f32 and bf16, at
   the step kernel's block sizes 128, 256 and 512, against its plain
   version on CPU copies, K8 + K9 == K2 bit for bit on f32, and K8 alone
   on a 250x70 lattice;
25. redesign timings (after phase 3's timed run): K1 under sample, ramp
   and exact, K2 f32 BGK, bf16 and TRT + LES at the three block sizes,
   and the reduce alone, at 4096^2/10k with CUDA events beside their
   bounds (phase 16 times K2 on the slice's own state at the three block
   sizes). The build phase fails if K2's f32 or bf16 BGK step kernel
   or the f32 or bf16 BGK instantiation of the K6/K7 temporal block
   spills;
26. temporal-block identities (after phase 24): the row-sweep K6(k)
   equal to k chained K2 steps (f' and every inner step's partials) over
   the lattice-option matrix of phase 18, and K7(k) equal to k chained K8
   steps over phase 10's matrix, k = 1, 2, 4, 8, at 256x64, 240x80 and
   96x32 (smaller than one strip), then on 240x80 at several strips
   (threads, rows), all by torch.equal on f32;
27. temporal-block timings (after phase 25): at 4096^2/10k on phase 3's
   inputs K6(4) == 4 x K2 bit for bit, K6 k = 4 f32, bf16 and TRT + LES
   beside 4 chained K2 steps (CUDA events, alternating; device time by
   torch.profiler), K6 f32 at k = 8 beside 8 chained K2 steps; on the
   static scene K7(4) == 4 x K8 bit for bit, K7 f32 and bf16 beside 4
   chained K8 steps; the strip sweep (threads 64/128 x rows
   32/64/128/256) of K6 and K7 f32. Phase 5w and 20 time K6
   beside 4 chained K2 steps on the window slices' own states, phase 11
   K7 beside 4 chained K8 steps on the static slice's, phase 18 4 chained
   K2 steps beside K6 on its inputs;
28. K3 redesign (after phase 27): every K3/K3w instantiation (K3, K3 with
   springs, K3w, K3w with springs, K3 on a periodic axis) at 4096^2/10k
   packed into contact, against its plain version (bit for bit without
   springs, 3e-5 with them, contacts equal), timed at each grid cap (the
   same result bit for bit), with device ms per call from the profiler
   and device operations per call from a CUDA graph capture of one call
   (one kernel launch and nothing else, or the phase fails);
29. K5 redesign (after phase 6): the row-sweep K5(k) equal to k chained
   K4 steps bit for bit over the f32 cases of FLUID_MATRIX at 256x64 and
   240x80, k = 2, 4, 7, 8, and at every strip of IDENTITY_STRIPS; bf16 K5
   at k = 4, 12, 16 within 3e-4 of its plain version; at 4096^2 K5(4) ==
   4 x K4, K5 and 4 chained K4 steps timed in turns (f32, bf16), K4's
   one-step body (f32) beside the sweep at k = 1 (f' equal), k = 8 (bf16
   16: two sweeps) beside the chain, and the strip sweep;
30. CLI at full width: `python -m lbmdem_tpu_torch.cli
   examples/column_collapse.par --steps 200` in this process (the auto
   path: the kernels), its launches (K1, K2, K3 200 each, nothing else),
   files (metrics.csv, the fluid and particle VTK, trajectories.csv),
   mass drift < 1e-5, its step-200 disk state bit for bit against an
   in-process Simulation.run(200) of the deck, both runs' MLUPS and the
   host time of one snapshot's reads;
31. checkpoint on the card: examples/settling_column.par, run(100),
   save_state, a fresh Simulation restored and run(100) against the
   continuing run and one run(200), bit for bit;
32. plain path on the card: examples/schafer_turek.par (440 x 82)
   through the CLI's auto path (the plain-path note, no kernel launch,
   200 steps, finite, overflow 0; --kernels on it exits 2); float64
   settling_column on the card against the CPU (20 steps, f and disk x
   within 1e-9, equal contacts) and its MLUPS; column_collapse at 4096^2
   (10k disks, f32) on the plain path: MLUPS over run(4);
33. paranoia on the card: a NaN injected into f after step 4 of a
   128x32 channel with a fixed disk reports step 5 under "step" (K1 +
   K2 per step) and step 8 under "chunk" (the static hoist's K7 passes),
   the state frozen there, as on the CPU;
34. mesh kernels: K4, K5 (k = 4, edge flags of corner, edge and
   interior shards) and K2 on pre-haloed shards ("y" and "yx") against
   their plain versions on the card - K4/K5 over a lattice-option matrix
   at a 256 x 128 shard, K2 on every shard of a 512^2 column collapse on
   2 x 2 and 4 x 1 meshes of one card; then at the 2 x 2 (2048^2) and 4
   x 1 shards of the 4096^2 slice, timed beside the same kernel without
   a halo on the shard's interior (K2: partials equal to the halo-free
   step's on the same cells) and their bounds (the halo cells each
   reads: a ring of one for K4 and K2, of k for K5);
35. mesh slice: BASELINE config 5, the 4096^2 column collapse with
   10 000 disks, through Simulation(..., mesh=...) on a 2 x 2 and a 4 x 1
   mesh: run(16) against the single-device run(16) (f 5e-6, x 1e-5, v
   1e-6), then run(100) timed in alternating pairs with the
   single-device run(100) (three each, every reading printed), its
   launches per step (K1 and K2 once per shard, K3 once per replica),
   overflow 0, mass drift < 1e-5;
36. mesh fluid: 4096^2 pure fluid on a 2 x 2 mesh, run(19) against one
   device within 1e-7 (K5 4, K4 3 per shard), then run(400) timed in
   alternating pairs with one device; with 4 cards or more phases 35 and
   36 run again on distinct cards; every mesh phase prints the cards its
   shards spanned;
37. mesh kernels II: K6 and K7 pre-haloed (k = 1, 2, 4, 8) over the
   lattice-option matrices of phases 18 and 10, and K8 pre-haloed over
   phase 18's, on the 256 x 128 shards of a 3 x 3 ("yx": corner, edge,
   interior shards) and a 3 x 1 ("y") mesh of one card, against their
   plain versions on CPU copies (K6 f' 5e-6 and every inner step's
   forces 1e-6 of the largest |F|, K7 rtol 1e-5 + atol 2e-6, K8 f' 5e-6
   and phi 1e-6); the identity (mesh_identity) - with no edge flags on a
   fully periodic lattice, frames filled from the lattice, pre-haloed
   K4, K5(k), K2, K6(k) (f' and partials) and K7(k) against the
   halo-free kernels on the shards' rows, torch.equal, any difference
   printed; then at the 2 x 2 and 4 x
   1 shards of the 4096^2 window and static scenes K6 (k = 4), K8 and K7
   (k = 4) timed with CUDA events beside the halo-free kernel on the
   shard's interior and their bounds (a ring of k, or 1, read);
38. mesh window: BASELINE config 5 with coupling_k = 4 through
   Simulation(..., mesh=...) on 2 x 2 and 4 x 1: run(16) against one
   device (f 5e-6, x 1e-5, v 1e-6), run(100) in three alternating pairs
   with one device, launches per run(100) (K1 and K6 25 per shard, K3w
   100, nothing else), overflow 0, mass drift < 1e-5;
39. mesh static: the static/4096 scene on 2 x 2 and 4 x 1: run(19)
   against one device (f 2e-6, disk x equal; K1 once and K7 7 times per
   shard), run(400) in three alternating pairs (K7 100 per shard);
40. paranoia on a mesh: a NaN injected after step 4 of a 128 x 256
   channel with a fixed disk on a 2 x 2 mesh reports the one-device
   fail_step under "step" (5) and "chunk" (8), frozen there;
41. mesh kernels bf16: K2, K4, K5 (k = 1, 2, 4), K6 and K7 (k = 1, 2, 4,
   8) on bf16 frames (16 halo rows, the solid window 8) against their
   plain versions on the card (f' 3e-4, forces 5e-6 of the largest |F|):
   K4/K5 over phase 34's matrix and edge flags, K2/K6 over phase 18's,
   K7 over phase 10's, on corner, edge and interior shards of 3 x 3
   ("yx") and 3 x 1 ("y") meshes; each against its halo-free bf16 kernel
   on a fully periodic lattice framed from itself (torch.equal); then
   timed at the 2 x 2 and 4 x 1 shards of the 4096^2 fluid, slice
   (sample), window (ramp) and static scenes beside the halo-free bf16
   kernel on the shard's interior and their bounds;
42. mesh bf16 slice: BASELINE config 5 in bf16 (bench.py's
   4096x4096/bfloat16/sample) on 2 x 2 and 4 x 1: run(16) against one
   device's bf16 run (f 3e-4, x 1e-5, v 1e-6), run(100) in three pairs,
   launches K1 and K2 per shard and K3 per replica per step, mass drift
   < 1e-4;
43. mesh bf16 window: the same with eps_method ramp and coupling_k 8
   (bench.py's .../bfloat16/ramp/k8): launches per run(100) 12 windows
   (K1 + K6 per shard, K3w 8 per replica) and 4 single steps;
44. mesh bf16 fluid: phase 36 in bf16 on 2 x 2 (f within one bf16 ulp of
   one device, rtol 1e-2 + atol 1e-6, equality printed);
45. mesh bf16 static: phase 39 in bf16 on 2 x 2 (f within one bf16 ulp);
46. mesh bf16 CLI: examples/column_collapse.par with f_storage bfloat16
   through the CLI with --mesh 2x2 (24 steps), its launches and its disk
   state bit for bit against Simulation(mesh=...).run(24);
47. mesh deep K5: K5 on frames deeper than one row sweep (f32 k = 5-8,
   bf16 k = 5-16; the sweeps between through f32 scratch frames) against
   its plain version on the card over phase 34's matrix on the corner,
   edge and interior shards of 3 x 3 ("yx") and 3 x 1 ("y") meshes
   (phase 34's bars, bf16 3e-4); against the halo-free K5(k) on a fully
   periodic lattice framed from itself (torch.equal, every case); f32
   k = 8 and bf16 k = 16 timed at the 2 x 2 and 4 x 1 shards of the
   4096^2 fluid beside the halo-free K5(k) and their bounds;
48. mesh fluid k = 8 (bf16 k = 16): the 4096^2 fluid on 2 x 2 through
   make_sharded_step(temporal_k=k), one exchange per k steps: f after 2
   calls equal to one device's 2 passes of K5(k), then 400 steps timed
   in turns with the mesh's own run (k = 4) and one device's run, K5 4
   launches per call;
49. distributed CLI: examples/column_collapse.par through the CLI with
   --distributed --mesh 2x2 (24 steps) as one NCCL rank in a subprocess
   started as torchrun starts it: its files equal the one-process
   --mesh 2x2 run's byte for byte (metrics.csv but for the MLUPS), the
   MLUPS of both;
50. validation legs: the port's tools (lbmdem_tpu_torch/tools/) on the
   card with their own gates - validate.py's settling, dkt, dktlit,
   periodic, cavity, trt (on K5: the TRT and BGK Poiseuille errors and
   their ratio, gates < 2e-4 and > 50x), friction and static legs,
   collapse_study at --tiny size (f32 on the kernels, check_scaling
   without the settled gate), benchmark_cylinder --steps 2000 on the
   plain path (cD and cL finite), ab_bf16's parity probe and settling
   parity; each leg's
   seconds and the kernels it launched (the launch counts of its run;
   each kernel the leg's path names must have launched);
51. TRT pair form: the TRT instantiations of K2, K6 (k = 4), K7 (k = 4)
   and K8, which collide in the TPU kernels' pair form (csrc/imb.cuh
   collide_cell_pairs), against their plain versions
   (fused_fluid.collide_imb_pairs) on the same card inputs over the TRT
   options of phase 18's matrix at 256x64 (f32: torch.equal printed,
   bf16 3e-4), on 2 x 2 and 4 x 1 mesh shards under TRT + LES, and at
   4096^2 timed; the trt leg's deck through K7 and K6 over an empty
   solid (TRT and BGK Poiseuille errors, their ratio; gates < 2e-4 and
   > 50x); a 256^2 TRT column on the card against CPU tensors; K8 + K9
   per step under TRT through the ablation's split step;
52. 8192^2 tier: bench.py's four 8192^2 / 40 000-disk stages (f32 sample
   k = 1 and k = 4, bf16 ramp k = 1 and k = 8) through
   tools/qualify_8192.py's functions: the slab plane, run(chunk) cold
   and timed (MLUPS, CUDA-event and profiler ms per step, peak memory),
   launches, overflow 0, finite, no zero population, mass; on the f32
   k = 1 state K1, K2, K3, K3w against their plain versions and K6(4)
   equal to 4 chained K2 steps, on the bf16 k = 8 state bf16 K6(8)
   against its plain version; the f32 k = 1 run against the plain path
   and the k = 4 window against its plain versions, 16 steps on the card
   (f 1e-5, x 1e-4, also past the occupied bands).
Each phase of 37-52 prints its seconds.

The second-to-last line holds the per-kernel JSON record (the ten
kernels, then the bf16, TRT + LES, kt and periodic instantiations of K2,
K6, K3 and K3w, the pre-haloed K2, K4, K5, K6, K7 and K8, the
pre-haloed K2, K4, K5, K6 and K7 on bf16 frames, and K5 on frames deeper
than one sweep (f32 k = 8, bf16 k = 16), the TRT instantiations of K2,
K6, K7 and K8, and K1, K2, K3, K6 (f32 k = 4, bf16 k = 8) and K3w at
8192^2 as records of their own;
with each kernel's bound: the
larger of its bytes over 3.35 TB/s and its f32 operations over 67
TFLOP/s; an NT collide counts 350 operations at a cell with eps_raw > 0
and 180 on its fluid branch), the line before it the card's name and
power limit; the last line is the contract line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


# the H100 SXM's published peaks: HBM3 bytes/s and f32 FLOP/s outside
# the tensor cores (the kernels here use no tensor cores)
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
# f32 operations per cell and step, counted from the kernels' arithmetic
# (moments, equilibria, relaxation, Guo forcing): the pure-fluid collide
# (csrc/d2q9.cuh fluid_collide_t's pair form, BGK with a body force
# along x: 29 for the moments and feq0, 34 for the four (E, O) pairs, 35
# for the relaxation, 32 for Guo's source), the NT-blended collide at a
# cell with eps_raw > 0, and its fluid branch at a cell with eps_raw <= 0
# (csrc/imb.cuh relax_cell: moments, 9 equilibria, relaxation; no
# equilibria at u_s, Omega_i or phi)
FLOPS_FLUID = 130
FLOPS_NT = 350
FLOPS_NT_FLUID = 180
# coverage operations per window cell (csrc/coverage.cuh): ns^2 sample
# tests of ~6 operations, the ramp's 8, the exact form's ~40
COV_OPS = {"sample": lambda ns: 6 * ns * ns, "ramp": lambda ns: 8,
           "exact": lambda ns: 40}


T0 = time.perf_counter()


def nt_flops(solid) -> float:
    """Operations of one NT collide step over the solid stack (3, ny,
    nx): FLOPS_NT at the cells with eps_raw > 0, FLOPS_NT_FLUID at the
    others (the work these inputs need)."""
    n = int((solid[0] > 0).sum())
    return FLOPS_NT * n + FLOPS_NT_FLUID * (solid[0].numel() - n)


def log(phase: str, msg: str) -> None:
    """One line of a phase, with the seconds since the script started."""
    print(f"[{phase} +{time.perf_counter() - T0:.0f}s] {msg}", flush=True)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def frame_bytes(t: torch.Tensor, h: int, w: int, mode: str,
                ring: int) -> int:
    """Bytes of a pre-haloed frame t (planes, h + 16, w [+ 256]) that a
    kernel on it must read: the interior and `ring` rows above and below
    it and, in "yx" mode, `ring` columns on either side (a "y" shard
    spans the width and wraps in x)."""
    cols = w + 2 * ring if mode == "yx" else w
    return t.shape[0] * t.element_size() * (h + 2 * ring) * cols


def work(err, ms, pms, moved: int, flops: float) -> dict:
    """A kernel's measured numbers and the work its bound is made of."""
    return {"err": err, "ms": ms, "plain_ms": pms, "bytes": moved,
            "flops": flops}


def bound(w: dict):
    """(bound_ms, bound_by): the least time the card could take for the
    work, the larger of bytes over HBM_BPS and operations over
    F32_FLOPS."""
    tb = w["bytes"] / HBM_BPS * 1e3
    tf = w["flops"] / F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= tf else (tf, "operations")


def run_cmd(cmd) -> str:
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if res.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed: {res.stderr.strip()}")
    return res.stdout.strip()


def probe() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available()"
                         " is False)")
    name = torch.cuda.get_device_name(0)
    smi = run_cmd(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"]).splitlines()[0]
    log("probe", f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log("probe", f"device {name}; count {torch.cuda.device_count()}")
    log("probe", f"nvidia-smi: {smi}")
    from lbmdem_tpu_torch import kernels

    nv = run_cmd([kernels.nvcc(), "--version"]).splitlines()[-1]
    log("probe", f"nvcc {nv}; CUDA_HOME={os.environ.get('CUDA_HOME')}")
    try:
        import triton  # noqa: F401  (reported only)

        tri = f"importable ({triton.__version__})"
    except ImportError as e:
        tri = f"not importable ({e})"
    log("probe", f"triton {tri}")
    return smi


def build() -> None:
    from lbmdem_tpu_torch import kernels

    t0 = time.perf_counter()
    lib = kernels.library()
    log("build", f"{len(kernels.SOURCES)} sources -> {kernels.BUILD} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {lib.build_seconds:.2f} s)")
    spills = {}
    for src, entry, regs, st, ld in kernels.resources():
        name = entry.replace("(anonymous namespace)::", "").removeprefix(
            "void ")
        name = name.split(">(")[0] + ">" if ">(" in name else name.split("(")[0]
        log("build", f"{src} {name}: {regs} registers, spills {st} B stored "
            f"/ {ld} B loaded")
        spills[name] = st + ld
    # the f32 and bf16 BGK instantiations of K2's step, of the K6/K7
    # temporal block and of K5's row sweep (on bf16 with the sweeps
    # through its f32 scratch: bf16 -> f32, f32 -> f32, f32 -> bf16), and
    # the f32 BGK pre-haloed K2 and K8 steps and K5, K6 and K7 sweeps,
    # must not spill
    spills = {k.replace(" ", ""): v for k, v in spills.items()}
    bf = "__nv_bfloat16"
    for s, sh in (("float", "false"), (bf, "true")):
        names = [f"coupled_step_kernel<{s},false,false,false,WSink>",
                 f"temporal_block_kernel<{s},{s},{sh},1,2,NTCell<false,"
                 f"false,false,WSteps>>",
                 f"temporal_block_kernel<{s},{s},{sh},1,2,NTCell<false,"
                 f"false,false,NoSink>>"]
        pairs = [(s, s)] + ([(bf, "float"), ("float", "float"),
                             ("float", bf)] if s == bf else [])
        names += [f"temporal_block_kernel<{a},{b},{sh},2,2,FluidCell<0,0,"
                  f"{fo}>>" for a, b in pairs for fo in (0, 1)]
        # the pre-haloed modes ("y" 1, "yx" 2) of K5, K2, K6, K7 (f32 and
        # bf16 frames) and K8 (f32)
        names += [f"temporal_block_prehalo_kernel<{s},{s},{sh},2,2,"
                  f"FluidCell<0,0,{fo}>,{pre}>" for fo in (0, 1)
                  for pre in (1, 2)]
        names += [f"coupled_step_prehalo_kernel<{s},false,false,false,WSink,"
                  f"{pre}>" for pre in (1, 2)]
        names += [f"temporal_block_prehalo_kernel<{s},{s},{sh},1,2,"
                  f"NTCell<false,false,false,{sink}>,{pre}>"
                  for sink in ("WSteps", "NoSink") for pre in (1, 2)]
        if s == "float":
            names += [f"coupled_step_prehalo_kernel<float,false,false,false,"
                      f"PhiSink,{pre}>" for pre in (1, 2)]
        for name in names:
            assert spills.get(name) == 0, f"{name}: spills {spills.get(name)}"


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


def compressed(disks, s: float):
    """The scene's disks with positions scaled by `s` toward the origin
    (s < 1 packs them into contact, so the DEM check sees contacts)."""
    from lbmdem_tpu_torch.config import DiskSpec

    return [DiskSpec(d.x * s, d.y * s, d.r, d.vx, d.vy, d.omega)
            for d in disks]


def kernel_checks(cfg, disks, label: str, timed: bool, seed: int = 0,
                  sim=None):
    """Each kernel against its plain version on the same card inputs.
    Returns {kernel: work(max_abs_err, ms, plain_ms, bytes, flops)}.
    sim: a run's f32 Simulation whose f and disk positions the kernels
    take (the disks with the seeded velocities); then nothing runs on the
    CPU (no cell-list DEM check) and K6 (k = 4) is held equal to 4
    chained K2 steps under torch.equal beside its plain version on the
    card."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import dem, fused_lbm, lbm, slab_dem, stamp

    on_run = sim is not None
    if not on_run:
        sim = Simulation(cfg, disks, device="cuda")
    cfg, grid, axis = sim.cfg, sim.grid, sim.dem_axis
    rng = np.random.default_rng(seed)
    d = sim.state.disks
    n = d.x.shape[0]
    dev = d.x.device
    # seeded motion (on a run's state too: the force bar is relative to
    # the largest |F|, a bar for moving disks)
    d = d._replace(
        v=torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)),
                          dtype=torch.float32, device=dev),
        omega=torch.as_tensor(rng.uniform(-2e-3, 2e-3, n),
                              dtype=torch.float32, device=dev))
    tile_data, counts, entry_slots, ovf = stamp.bin_disks_to_tiles(
        d.x, d.v, d.omega, d.r, d.active, cfg)
    assert int(ovf) == 0, f"binning overflow {int(ovf)}"
    out = {}
    cov_flops = cov_flops_of(cfg, counts)

    # K1 stamp: atol 1e-6 (the JAX stamp-vs-oracle bar)
    solid = stamp.stamp_fields(tile_data, counts, cfg)
    solid_p = stamp.stamp_fields_plain(tile_data, counts, cfg)
    e1 = float((solid - solid_p).abs().max())
    assert e1 <= 1e-6, f"K1 {label}: max |kernel - plain| {e1} > 1e-6"
    t = (cuda_ms(lambda: stamp.stamp_fields(tile_data, counts, cfg), 20),
         cuda_ms(lambda: stamp.stamp_fields_plain(tile_data, counts, cfg), 2)
         ) if timed else (None, None)
    out["K1"] = work(e1, *t, nbytes(tile_data, counts, solid), cov_flops)
    log("kernels", f"{label} K1 stamp: max err {e1:.3e} (bar 1e-6); "
        f"eps sum {float(solid[0].sum()):.6e}")

    # K2 fused IMB step: f' atol 5e-6; forces after gather_partials atol
    # 1e-6 relative to the largest |F|
    if on_run:
        f = sim.state.f.clone()
    else:
        f = lbm.init_equilibrium(cfg, dev) * (1.0 + 0.02 * torch.as_tensor(
            rng.standard_normal((9, cfg.ny, cfg.nx)), dtype=torch.float32,
            device=dev))
    fa = torch.empty_like(f)
    fb = torch.empty_like(f)
    _, parts = fused_lbm.fused_step_imb_reduce(f, solid, tile_data, counts,
                                               cfg, fa)
    _, parts_p = fused_lbm.fused_step_imb_reduce_plain(
        f, solid, tile_data, counts, cfg, fb)
    e2 = float((fa - fb).abs().max())
    F, T = stamp.gather_partials(parts, entry_slots, torch.float32)
    Fp, Tp = stamp.gather_partials(parts_p, entry_slots, torch.float32)
    fmax = float(Fp.abs().max())
    e2f = float((F - Fp).abs().max())
    assert e2 <= 5e-6, f"K2 {label}: f' max err {e2} > 5e-6"
    assert e2f <= 1e-6 * max(fmax, 1e-30), (
        f"K2 {label}: force err {e2f} > 1e-6 * max|F| ({fmax})")
    t = (cuda_ms(lambda: fused_lbm.fused_step_imb_reduce(
            f, solid, tile_data, counts, cfg, fa), 20),
         cuda_ms(lambda: fused_lbm.fused_step_imb_reduce_plain(
             f, solid, tile_data, counts, cfg, fb), 2)
         ) if timed else (None, None)
    out["K2"] = work(e2, *t, nbytes(f, solid, tile_data, counts, fa, parts),
                     nt_flops(solid) + cov_flops)
    log("kernels", f"{label} K2 fused step: f' max err {e2:.3e} (bar 5e-6); "
        f"force err {e2f:.3e} vs max|F| {fmax:.3e} (bar 1e-6 relative); "
        f"torque err {float((T - Tp).abs().max()):.3e}")

    # K3 slab DEM: x/v/omega atol 2e-5 (the JAX slab-vs-XLA bar),
    # n_contacts equal
    body = dem.body_forces(d, cfg)
    slabs, slot, sovf, kmax, n_occ, band_offs, _ = slab_dem.build_slabs(
        d, F, T, body, grid, axis)
    assert int(sovf) == 0, f"slab overflow {int(sovf)}"
    s_k, nc_k = slab_dem.subcycle_slabs(slabs.clone(), kmax, n_occ, band_offs,
                                        grid, cfg, axis)
    s_p, nc_p = slab_dem.subcycle_slabs_plain(slabs, kmax, cfg, grid, axis)
    dk, _ = slab_dem._unslab(s_k, slot, d, cfg, None, sovf)
    dp, _ = slab_dem._unslab(s_p, slot, d, cfg, None, sovf)
    e3 = max(float((dk.x - dp.x).abs().max()), float((dk.v - dp.v).abs().max()),
             float((dk.omega - dp.omega).abs().max()))
    assert e3 <= 2e-5, f"K3 {label}: x/v/omega max err {e3} > 2e-5"
    assert int(nc_k) == int(nc_p), f"K3 {label}: contacts {int(nc_k)} != " \
        f"{int(nc_p)}"
    scratch = slabs.clone()
    t = (cuda_ms(lambda: slab_dem.subcycle_slabs(
            scratch, kmax, n_occ, band_offs, grid, cfg, axis), 20),
         cuda_ms(lambda: slab_dem.subcycle_slabs_plain(
             slabs, kmax, cfg, grid, axis), 2)
         ) if timed else (None, None)
    # per substep each active disk tests the 9 neighbour cells' kmax
    # slots with a ~60-operation pair law
    dem_flops = (cfg.n_sub * int(d.active.sum()) * 9 * int(kmax) * 60)
    out["K3"] = work(e3, *t, 2 * nbytes(slabs), dem_flops)
    log("kernels", f"{label} K3 slab DEM: x/v/omega max err {e3:.3e} (bar "
        f"2e-5); contacts {int(nc_k)} == {int(nc_p)}; kmax {int(kmax)}, "
        f"occupied bands {int(n_occ)}")
    if on_run:
        del scratch, s_k, s_p
        out.update(k6_on_run(f, solid, tile_data, counts, entry_slots, cfg,
                             label, fa, fb))
        forces4 = out.pop("forces4")
    else:
        cell_list_vs_cpu(d, F, T, grid, cfg, label)

    # K6 coupled temporal block, k = 2, 4, 8: against the plain version
    # on CPU copies of the same inputs. The kernel divides as the CPU
    # does; the plain version on the card multiplies by 1/tau (PyTorch's
    # CUDA scalar division), a 1-ulp change of f that moves the later
    # inner steps' forces by ~1e-6 of the largest |F|. Bars: f' 5e-6,
    # each inner step's forces 1e-6 relative to the largest |F| (K2's).
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cpu_in = [a.cpu() for a in (f, solid, tile_data, counts)] \
        if not on_run else []
    es_cpu = entry_slots.cpu()
    # k = 8 against the CPU at the small scene only (at 4096^2 its plain
    # version takes two minutes of the script's time)
    for k in (() if on_run else (2, 4) if timed else (2, 4, 8)):
        _, pk = fused_lbm.fused_step_imb_reduce_multi(f, solid, tile_data,
                                                      counts, cfg, k, fa)
        fp_cpu, pp = fused_lbm.fused_step_imb_reduce_multi_plain(
            *cpu_in, cfg, k, torch.empty_like(cpu_in[0]))
        e6 = float((fa.cpu() - fp_cpu).abs().max())
        e6f = 0.0
        for s in range(k):
            Fk, _ = stamp.gather_partials(pk[s].cpu(), es_cpu, torch.float32)
            Fp, _ = stamp.gather_partials(pp[s], es_cpu, torch.float32)
            e6f = max(e6f, float((Fk - Fp).abs().max())
                      / max(float(Fp.abs().max()), 1e-30))
        assert e6 <= 5e-6, f"K6 k={k} {label}: f' max err {e6} > 5e-6"
        assert e6f <= 1e-6, f"K6 k={k} {label}: force err {e6f} > 1e-6 " \
            "relative"
        t = (cuda_ms(lambda: fused_lbm.fused_step_imb_reduce_multi(
                f, solid, tile_data, counts, cfg, k, fa), 10),
             cuda_ms(lambda: fused_lbm.fused_step_imb_reduce_multi_plain(
                 f, solid, tile_data, counts, cfg, k, fb), 1)
             ) if timed else (None, None)
        out[f"K6 k={k}"] = work(
            e6, *t, nbytes(f, solid, tile_data, counts, fa, pk),
            k * (nt_flops(solid) + cov_flops))
        log("kernels", f"{label} K6 k={k} coupled block: f' max err {e6:.3e}"
            f" (bar 5e-6); worst inner-step force err {e6f:.3e} of max|F| "
            f"(bar 1e-6 relative; plain version on CPU tensors)")
        if k == 4:
            forces4 = [stamp.gather_partials(pk[s], entry_slots, torch.float32)
                       for s in range(k)]

    # K3w: the window's 4 chained subcycles on one slim slab build, each
    # with its own inner step's forces (K6 k = 4's): x/v/omega atol 2e-5,
    # contacts equal at every inner step
    slabs_w, slot_w, sovf, kmax_w, nocc_w, bands_w, _ = slab_dem.build_slabs(
        d, None, None, body, grid, axis, bake_forces=False)
    assert int(sovf) == 0, f"slab overflow {int(sovf)}"
    f3 = slab_dem._force_planes_window(slot_w, forces4, body, slabs_w.shape)
    s_k, s_p = slabs_w.clone(), slabs_w
    for s in range(4):
        s_k, nc_k = slab_dem.subcycle_slabs_window(
            s_k, f3[s], kmax_w, nocc_w, bands_w, grid, cfg, axis)
        s_p, nc_p = slab_dem.subcycle_slabs_plain(s_p, kmax_w, cfg, grid,
                                                  axis, f3[s])
        assert int(nc_k) == int(nc_p), f"K3w {label} inner step {s}: " \
            f"contacts {int(nc_k)} != {int(nc_p)}"
    dk, _ = slab_dem._unslab(s_k, slot_w, d, cfg, None, sovf, slim=True)
    dp, _ = slab_dem._unslab(s_p, slot_w, d, cfg, None, sovf, slim=True)
    e3w = max(float((dk.x - dp.x).abs().max()),
              float((dk.v - dp.v).abs().max()),
              float((dk.omega - dp.omega).abs().max()))
    assert e3w <= 2e-5, f"K3w {label}: x/v/omega max err {e3w} > 2e-5"
    scratch = slabs_w.clone()
    t = (cuda_ms(lambda: slab_dem.subcycle_slabs_window(
            scratch, f3[0], kmax_w, nocc_w, bands_w, grid, cfg, axis), 20),
         cuda_ms(lambda: slab_dem.subcycle_slabs_plain(
             slabs_w, kmax_w, cfg, grid, axis, f3[0]), 2)
         ) if timed else (None, None)
    out["K3w"] = work(e3w, *t, 2 * nbytes(slabs_w) + nbytes(f3[0]),
                      cfg.n_sub * int(d.active.sum()) * 9 * int(kmax_w) * 60)
    log("kernels", f"{label} K3w window slab DEM, 4 chained calls: x/v/omega"
        f" max err {e3w:.3e} (bar 2e-5); contacts {int(nc_k)} == "
        f"{int(nc_p)} at the last")
    if timed:
        for k, w in out.items():
            bms, by = bound(w)
            log("kernels", f"{label} {k}: kernel {w['ms']:.4f} ms, plain "
                f"{w['plain_ms']:.4f} ms (CUDA events); bound {bms:.4f} ms "
                f"by {by} ({w['bytes'] / 1e9:.4f} GB, "
                f"{w['flops'] / 1e9:.3f} GFLOP)")
    return out


def cell_list_vs_cpu(d, F, T, grid, cfg, label: str) -> None:
    """The cell-list DEM subcycle (plain PyTorch, no kernel) on the card
    against the same call on CPU copies: contacts equal, x/v/omega within
    1e-4."""
    from lbmdem_tpu_torch.ops import dem

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    g, ovf, nc = dem.dem_subcycle(d, F, T, grid, cfg)
    dc = type(d)(*(a.cpu() for a in d))
    c, ovf_c, nc_c = dem.dem_subcycle(dc, F.cpu(), T.cpu(), grid, cfg)
    err = max(float((getattr(g, k).cpu() - getattr(c, k)).abs().max())
              for k in ("x", "v", "omega"))
    ms = cuda_ms(lambda: dem.dem_subcycle(d, F, T, grid, cfg), 3)
    log("cell-list", f"{label} cell-list DEM: card vs CPU x/v/omega max err "
        f"{err:.3e} (bar 1e-4); contacts {int(nc)} == {int(nc_c)}; overflow "
        f"{int(ovf)}; {ms:.3f} ms per subcycle on the card (CUDA events)")
    assert int(ovf) == int(ovf_c) == 0
    assert int(nc) == int(nc_c) > 0, (int(nc), int(nc_c))
    assert err <= 1e-4, f"cell-list DEM {label}: err {err}"


def _wrappers():
    from lbmdem_tpu_torch.ops import (fused_fluid, fused_lbm, fused_static,
                                      slab_dem, stamp)

    return {"K1": stamp.stamp_fields,
            "K2": fused_lbm.fused_step_imb_reduce,
            "K3": slab_dem.subcycle_slabs,
            "K4": fused_fluid.fused_step_fluid,
            "K5": fused_fluid.fused_step_fluid_multi,
            "K6": fused_lbm.fused_step_imb_reduce_multi,
            "K3w": slab_dem.subcycle_slabs_window,
            "K7": fused_static.fused_step_imb_static_multi,
            "K8": fused_lbm.fused_step_imb,
            "K9": stamp.reduce_hydro_forces,
            "KL": slab_dem.leftover_verlet}


def launch_counts():
    return {k: fn.launches for k, fn in _wrappers().items()}


def reset_counts() -> None:
    for fn in _wrappers().values():
        fn.launches = 0


# launches of run(100) twice per coupled slice: coupling_k = 1 takes K1,
# K2, K3 and the leftover fallback (KL) every step; coupling_k = 4 takes
# each cadence block of 8 steps (and the last block of 4) as windows: K1,
# K6 and KL once per window, K3w once per inner step
_NONE = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K3w": 0,
         "K7": 0, "K8": 0, "K9": 0, "KL": 0}
SLICE_COUNTS = {
    1: {**_NONE, "K1": 200, "K2": 200, "K3": 200, "KL": 200},
    4: {**_NONE, "K1": 50, "K6": 50, "K3w": 200, "KL": 50},
}


def slice_run(smi: str, coupling_k: int = 1, eps_method: str = "sample",
              keep: bool = False, storage: str = "float32"):
    """The coupled slice through Simulation(*column_collapse(),
    device="cuda") with cfg.coupling_k, cfg.eps_method and cfg.f_storage:
    run(100) to warm, run(100) timed; the launch counts of both runs,
    overflow, finiteness, mass (bar 1e-5; bf16 storage 1e-4), motion.
    Returns (launch counts, MLUPS), and the Simulation too when `keep`."""
    from lbmdem_tpu_torch.ops import lbm
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import column_collapse

    cfg, disks = column_collapse()
    cfg = cfg.replace(coupling_k=coupling_k, eps_method=eps_method,
                      f_storage=storage)
    tag = ("slice" if coupling_k == 1 else
           f"window-slice k={coupling_k}")
    if eps_method != "sample":
        tag = f"{eps_method}-slice"
    if storage != "float32":
        tag = f"{storage}-{tag}"
    sim = Simulation(cfg, disks, device="cuda")
    x0 = sim.state.disks.x.clone()
    reset_counts()
    sim.run(100)
    torch.cuda.reset_peak_memory_stats()
    mlups = sim.run(100)
    counts = launch_counts()
    steps = int(sim.state.step)
    st = sim.state
    assert st.f.dtype == (torch.bfloat16 if storage == "bfloat16"
                          else torch.float32)
    f = lbm.from_storage(st.f, cfg)
    finite = bool(torch.isfinite(f).all())
    mass_err = abs(float(f.double().sum()) / (cfg.nx * cfg.ny) - 1.0)
    disp = float((st.disks.x - x0).abs().max())
    log(tag, f"column_collapse {cfg.nx}x{cfg.ny}, {len(disks)} disks, "
        f"coupling_k={coupling_k}, eps_method={eps_method}, f_storage="
        f"{storage}, {steps} steps: "
        f"{mlups:.1f} MLUPS (timed "
        f"run(100), wall clock) on {smi}; peak mem "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(tag, f"launches {counts}; overflow {int(st.overflow)}; "
        f"n_contacts {int(st.n_contacts)}; finite {finite}; "
        f"|sum f/(nx ny) - 1| {mass_err:.3e}; max disk displacement {disp:.4e}")
    assert steps == 200, steps
    assert counts == SLICE_COUNTS[coupling_k], counts
    assert int(st.overflow) == 0, f"overflow {int(st.overflow)}"
    assert finite, "non-finite f"
    assert mass_err < (1e-5 if storage == "float32" else 1e-4), \
        f"mass drift {mass_err}"
    assert disp > 0.0, "disks did not move"
    return (counts, mlups, sim) if keep else (counts, mlups)


def slice_vs_cpu(coupling_k: int = 1, steps: int = 16,
                 eps_method: str = "sample", storage: str = "float32",
                 kt: float = 0.0, collision: str = "bgk") -> None:
    """`steps` steps of a 256^2 column collapse on the card against the
    same run on CPU tensors (the plain versions). Bars: f 1e-5 (bf16
    storage 3e-4, one flipped rounding of the shifted populations), disk
    x 1e-4. kt > 0: the column packed into contact, so springs form."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import column_collapse

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60, kt=kt)
    if kt:
        disks = compressed(disks, 0.94)
    cfg = cfg.replace(coupling_k=coupling_k, eps_method=eps_method,
                      f_storage=storage, collision=collision)
    g = Simulation(cfg, disks, device="cuda")
    c = Simulation(cfg, disks, device="cpu")
    g.run(steps)
    c.run(steps)
    ef = float((g.state.f.float().cpu() - c.state.f.float()).abs().max())
    ex = float((g.state.disks.x.cpu() - c.state.disks.x).abs().max())
    fbar = 1e-5 if storage == "float32" else 3e-4
    springs = int((g.state.disks.ct_j >= 0).sum())
    log("vs-cpu", f"256x256, {len(disks)} disks, coupling_k={coupling_k}, "
        f"eps_method={eps_method}, f_storage={storage}, kt={kt:g}, "
        f"collision={collision}, {steps} "
        f"steps: f max err {ef:.3e} (bar {fbar:g}), disk x max err {ex:.3e} "
        f"(bar 1e-4); contacts {int(g.state.n_contacts)} == "
        f"{int(c.state.n_contacts)}, live springs {springs}")
    assert int(g.state.overflow) == 0
    assert ef <= fbar and ex <= 1e-4
    if kt:
        assert int(g.state.n_contacts) == int(c.state.n_contacts) > 0
        assert springs > 0 and springs == int((c.state.disks.ct_j >= 0).sum())


def coupling_k_settling(ck: int = 4) -> None:
    """The couplingk leg of lbmdem_tpu_torch/tools/validate.py on the
    card: one disk settling in a closed 128x192 channel, f32,
    coupling_k=4, 3000 steps; over the second half of the rows (every
    100 steps), max |vy - vy_gold| / max |vy_gold| < 1 % against the f64
    per-step golden."""
    from lbmdem_tpu_torch.tools import validate

    t0 = time.perf_counter()
    res = validate.coupling_k("cuda", ck)
    log("couplingk", f"settling 128x192 f32 coupling_k={ck}, 3000 steps in "
        f"{time.perf_counter() - t0:.2f} s ({res['path']}): max |dvy| / "
        f"max |vy_gold| over the second half {100 * res['err']:.4f} % "
        f"(bar 1 %)")


# the lattice-option matrix of the JAX package's fluid-kernel tests
# (tests/test_pallas.py), Zou/He channels (wall and periodic y), bf16
# storage, and two domains smaller than one 16 x 32 tile; at 256x64
# unless overridden
FLUID_MATRIX = [
    ("periodic-x", {}),
    ("walls", dict(bc_west="wall", bc_east="wall")),
    ("periodic", dict(bc_south="periodic", bc_north="periodic")),
    ("forcing", dict(gx=1e-5, gy=-2e-5)),
    ("les", dict(smagorinsky=0.16, gx=2e-5)),
    ("lid", dict(bc_west="wall", bc_east="wall", uw_north=0.08)),
    ("trt", dict(collision="trt")),
    ("trt-les", dict(collision="trt", smagorinsky=0.16, gx=1e-5)),
    ("zou-he", dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                    inlet_profile="poiseuille")),
    ("zou-he-periodic-y", dict(bc_west="inlet", bc_east="outlet",
                               u_inlet=0.06, inlet_profile="poiseuille",
                               bc_south="periodic", bc_north="periodic")),
    ("bf16-forcing", dict(f_storage="bfloat16", gx=1e-5, gy=-1e-5)),
    ("bf16-zou-he", dict(f_storage="bfloat16", bc_west="inlet",
                         bc_east="outlet", u_inlet=0.06)),
    ("bf16-trt-les-lid", dict(f_storage="bfloat16", collision="trt",
                              smagorinsky=0.16, bc_west="wall",
                              bc_east="wall", uw_north=0.08)),
    ("small-channel", dict(nx=4, ny=32, gx=1e-5)),
    ("small-cavity", dict(nx=24, ny=6, bc_west="wall", bc_east="wall",
                          uw_north=0.05)),
]


def fluid_bar(cfg, k: int):
    """(atol, rtol) of K4/K5 against the plain version, the JAX package's
    bars: K4 1e-7/1e-6, K5 5e-7/1e-5 (2e-6 with Zou/He), bf16 3e-4."""
    if cfg.f_storage == "bfloat16":
        return 3e-4, 0.0
    if k == 1:
        return 1e-7, 1e-6
    return (2e-6 if cfg.bc_west == "inlet" else 5e-7), 1e-5


def fluid_check(cfg, k: int, seed: int, label: str, timed: bool = False,
                amp: float = 0.05):
    """K4 (k == 1) or K5 (k steps) against its plain version on the same
    card input, f = w_i (1 + amp N(0, 1)). Returns work(max_abs_err, ms,
    plain_ms, bytes, flops)."""
    from lbmdem_tpu_torch import lattice
    from lbmdem_tpu_torch.ops import fused_fluid, lbm

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.as_tensor(lattice.W, dtype=torch.float32, device="cuda")
    f = lbm.to_storage(w[:, None, None] * (1.0 + amp * torch.randn(
        (9, cfg.ny, cfg.nx), generator=g, device="cuda")), cfg)
    a, b = torch.empty_like(f), torch.empty_like(f)
    if k == 1:
        wrapper = fused_fluid.fused_step_fluid
        run = lambda: wrapper(f, cfg, a)  # noqa: E731
        plain = lambda: fused_fluid.fused_step_fluid_plain(f, cfg, b)  # noqa
    else:
        wrapper = fused_fluid.fused_step_fluid_multi
        run = lambda: wrapper(f, cfg, k, a)  # noqa: E731
        plain = lambda: fused_fluid.fused_step_fluid_multi_plain(  # noqa
            f, cfg, k, b)
    n0 = wrapper.launches
    run()
    assert wrapper.launches == n0 + 1, "the kernel did not launch"
    plain()
    torch.cuda.synchronize()
    ka, pb = a.float(), b.float()
    err = float((ka - pb).abs().max())
    atol, rtol = fluid_bar(cfg, k)
    excess = float(((ka - pb).abs() - rtol * pb.abs()).max())
    moved = float((pb - f.float()).abs().max())
    name = "K4" if k == 1 else f"K5 k={k}"
    log("fluid", f"{label} {name}: max err {err:.3e} (bar atol {atol:g} + "
        f"rtol {rtol:g}; f' equal {torch.equal(a, b)}); max |step| "
        f"{moved:.3e}")
    assert bool(torch.isfinite(ka).all()), f"{label} {name}: non-finite"
    assert excess <= atol, f"{label} {name}: err {err} over the bar"
    assert moved > 0.0, f"{label} {name}: the step changed nothing"
    t = (cuda_ms(run, 20), cuda_ms(plain, 2)) if timed else (None, None)
    return work(err, *t, 2 * nbytes(f),
                k * FLOPS_FLUID * cfg.nx * cfg.ny)


def fluid_kernels(n: int = 4096):
    """K4/K5 against the plain versions over FLUID_MATRIX, then at n^2
    with CUDA-event times. Returns {kernel: work(...)} of the
    f32 n^2 checks. At n^2 the input amplitude is 0.02, the timed input
    of every earlier run (with 0.05 some of the 151 M shifted bf16 values
    exceed |g| = 1/16, where one bf16 ulp, 4.9e-4, is over the 3e-4
    bar)."""
    from lbmdem_tpu_torch import SimConfig

    for i, (label, kw) in enumerate(FLUID_MATRIX):
        cfg = SimConfig(**{"nx": 256, "ny": 64, "tau": 0.8,
                           "dtype": "float32", **kw})
        ks = (1, 4, 8, 16) if cfg.f_storage == "bfloat16" else (1, 4, 8)
        for k in ks:
            fluid_check(cfg, k, 100 + i, f"{label} {cfg.nx}x{cfg.ny}")
    out = {}
    for storage in ("float32", "bfloat16"):
        cfg = SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, dtype="float32",
                        f_storage=storage)
        for k, key in ((1, "K4"), (4, "K5")):
            w = fluid_check(cfg, k, 7, f"{n}x{n} {storage}", timed=True,
                            amp=0.02)
            ms = w["ms"]
            bms, by = bound(w)
            log("fluid", f"{n}x{n} {storage} {key} (k={k}): kernel "
                f"{ms:.4f} ms per call ({ms / k:.4f} ms per step), plain "
                f"{w['plain_ms']:.4f} ms (CUDA events); bound {bms:.4f} ms "
                f"by {by}")
            if storage == "float32":
                out[key] = w
    return out


def fluid_slice(smi: str, storage: str, n: int = 4096):
    """The pure-fluid path through Simulation at n^2 (bench.py's
    fluid/4096 stages): run(400) to warm, run(400) timed, run(19), the
    checks on that 819-step state, then two more timed run(400) for the
    spread, then K5's CUDA-event time on the run's own state for the
    kernel share of the runs (the f32 kernel is slower on the smooth
    state of the run than on a random one). Returns (launch counts of
    the first timed run(400) + run(19), median MLUPS)."""
    from lbmdem_tpu_torch.ops import fused_fluid
    from lbmdem_tpu_torch import SimConfig, Simulation
    from lbmdem_tpu_torch.ops import lbm

    cfg = SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, dtype="float32",
                    out_interval=10**9, f_storage=storage)
    sim = Simulation(cfg, device="cuda")
    sim.run(400)
    reset_counts()
    rates = [sim.run(400)]
    c400 = launch_counts()
    sim.run(19)
    counts = launch_counts()
    steps = int(sim.state.step)
    f = lbm.from_storage(sim.state.f, cfg)
    finite = bool(torch.isfinite(f).all())
    mass_err = abs(float(f.double().sum()) / (cfg.nx * cfg.ny) - 1.0)
    ux = float(lbm.moments(f, cfg.gx, cfg.gy)[1].double().mean())
    bar = 1e-5 if storage == "float32" else 1e-4
    for _ in range(2):
        reset_counts()
        rates.append(sim.run(400))
        assert launch_counts() == {**c400, "K5": 100}, launch_counts()
    mlups = float(np.median(rates))
    k5_ms = cuda_ms(lambda: fused_fluid.fused_step_fluid_multi(
        sim.state.f, cfg, 4, sim._f_spare), 10)
    # 100 K5 launches per run(400): their device time over the wall time
    share = [100 * 100 * k5_ms * 1e-3 / (cfg.nx * cfg.ny * 400 / (r * 1e6))
             for r in rates]
    log("fluid-slice", f"{cfg.nx}x{cfg.ny} {storage}, tau 0.8, gx 1e-6: "
        f"{mlups:.1f} MLUPS median of 3 timed run(400) "
        f"({', '.join(f'{r:.1f}' for r in rates)}; wall clock; "
        f"{1e3 * cfg.nx * cfg.ny / (mlups * 1e6):.4f} ms per step) on {smi}; "
        f"K5 on this state {k5_ms:.4f} ms per call; 100 x K5 / run time "
        f"{', '.join(f'{x:.1f}' for x in share)} %")
    log("fluid-slice", f"launches run(400) {c400}; after run(19) {counts}; "
        f"steps {steps}; finite {finite}; |sum f/(nx ny) - 1| "
        f"{mass_err:.3e} (bar {bar:g}); mean ux {ux:.4e}")
    assert (counts["K5"] - 100, counts["K4"]) == (4, 3), counts
    assert all(counts[k] == 0 for k in ("K1", "K2", "K3", "K6", "K3w",
                                        "K7")), counts
    assert steps == 819
    assert finite, "non-finite f"
    assert mass_err < bar, f"mass drift {mass_err}"
    assert ux > 0.0, "the body force drove no flow"
    return counts, mlups


def poiseuille_check() -> None:
    """models.poiseuille (64^2, tau 0.9, g 1e-6, 20 ny^2 steps, f32) on
    the card against the analytic parabola. Bar: max |u - analytic| <=
    1 % of u_max. The f64 bars of test_lbm.py (rtol 2e-3, atol 3e-7)
    hold in f64 (the same run on CPU tensors: 1.4e-7); in f32 the
    rounding of the collide leaves a steady offset of 0.48 % of u_max,
    on the card and on CPU tensors alike."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import poiseuille

    cfg, _ = poiseuille()
    sim = Simulation(cfg, device="cuda")
    t0 = time.perf_counter()
    sim.run(cfg.steps)
    secs = time.perf_counter() - t0
    _, ux, _ = sim.macroscopic()
    prof = ux.mean(axis=1).astype(np.float64)
    y = np.arange(cfg.ny) + 0.5
    analytic = cfg.gx / (2.0 * cfg.nu) * y * (cfg.ny - y)
    err = np.abs(prof - analytic)
    umax = analytic.max()
    log("poiseuille", f"{cfg.nx}x{cfg.ny}, {cfg.steps} steps in {secs:.2f} s:"
        f" max |u - analytic| {err.max():.3e} of u_max {umax:.4e} "
        f"({100 * err.max() / umax:.3f} %; bar 1 %)")
    assert err.max() <= 1e-2 * umax, "Poiseuille profile off"


def fluid_vs_cpu() -> None:
    """19 steps (4 K5 passes + 3 K4 steps) on the card against the same
    run on CPU tensors (the plain versions)."""
    from lbmdem_tpu_torch import SimConfig, Simulation
    from lbmdem_tpu_torch.models import cavity

    chan = SimConfig(nx=256, ny=64, tau=0.7, dtype="float32",
                     bc_west="inlet", bc_east="outlet", u_inlet=0.05,
                     inlet_profile="poiseuille")
    for label, cfg in (("Zou/He channel", chan), ("cavity", cavity()[0])):
        g = Simulation(cfg, device="cuda")
        c = Simulation(cfg, device="cpu")
        g.run(19)
        c.run(19)
        err = float((g.state.f.cpu() - c.state.f).abs().max())
        log("fluid-vs-cpu", f"{label} {cfg.nx}x{cfg.ny}, 19 steps: f max err "
            f"{err:.3e} (bar 1e-5)")
        assert err <= 1e-5


def k4_step(cfg):
    """K4 as a step(src, dst) of `chained`."""
    from lbmdem_tpu_torch.ops import fused_fluid

    return lambda src, dst: fused_fluid.fused_step_fluid(src, cfg, dst)


def k5_identity(f, cfg, k: int, tag: str) -> None:
    """K5(k) against k chained K4 steps on the same f32 input: f' equal
    (torch.equal)."""
    from lbmdem_tpu_torch.ops import fused_fluid

    a, b, c = (torch.empty_like(f) for _ in range(3))
    k5 = fused_fluid.fused_step_fluid_multi
    n0 = k5.launches
    k5(f, cfg, k, c)
    assert k5.launches == n0 + 1, "K5 did not launch"
    last, _ = chained(k4_step(cfg), k, f, a, b)
    assert torch.equal(c, last), f"K5 k={k} {tag}: f' differs from {k} " \
        "chained K4 steps"
    assert float((c - f).abs().max()) > 0.0, f"K5 k={k} {tag}: no change"


def k5_identities() -> None:
    """The row-sweep K5 against K4 bit for bit: in f32 K5(k) == k chained
    K4 steps over the f32 cases of FLUID_MATRIX (Zou/He, moving lids,
    periodic y, TRT + LES, the 4 x 32 and 24 x 6 lattices smaller than a
    strip), k = 2, 4, 7, 8, at 256x64 and 240x80, then on 240x80 at every
    strip of IDENTITY_STRIPS; on bf16 K5 at k = 4, 12 and 16 (two sweeps
    past 8) within 3e-4 of its plain version on the card (one rounding
    per pass)."""
    from lbmdem_tpu_torch import SimConfig, lattice
    from lbmdem_tpu_torch.ops import fused_fluid, lbm

    rng = np.random.default_rng(47)
    n = 0

    def inputs(kw, nx, ny):
        cfg = SimConfig(**{"nx": nx, "ny": ny, "tau": 0.8, "dtype": "float32",
                           **kw})
        f = torch.as_tensor(lattice.W[:, None, None] * (
            1.0 + 0.05 * rng.standard_normal((9, cfg.ny, cfg.nx))),
            dtype=torch.float32, device="cuda")
        return cfg, f

    saved = fused_fluid.STRIP
    try:
        for nx, ny in ((256, 64), (240, 80)):
            errs = []
            for label, kw in FLUID_MATRIX:
                if "nx" in kw and nx != 256:
                    continue  # the small lattices once
                cfg, f = inputs(kw, nx, ny)
                if cfg.f_storage == "bfloat16":
                    g = lbm.to_storage(f, cfg)
                    for k in (4, 12, 16):
                        a, b = torch.empty_like(g), torch.empty_like(g)
                        fused_fluid.fused_step_fluid_multi(g, cfg, k, a)
                        fused_fluid.fused_step_fluid_multi_plain(g, cfg, k, b)
                        err = float((a.float() - b.float()).abs().max())
                        assert err <= 3e-4, f"K5 bf16 k={k} {label}: {err}"
                        errs.append(err)
                    continue
                for k in (2, 4, 7, 8):
                    k5_identity(f, cfg, k, f"{label} {cfg.nx}x{cfg.ny}")
                    n += 1
            log("k5", f"{nx}x{ny}: K5(k) == k x K4 over the f32 cases of "
                f"FLUID_MATRIX, k = 2, 4, 7, 8, bit for bit; bf16 k = 4, 12, "
                f"16 max err {max(errs):.3e} against the plain version")
        cases = dict(FLUID_MATRIX)
        for strip in IDENTITY_STRIPS:
            fused_fluid.STRIP = strip
            for label in ("walls", "zou-he", "periodic", "trt-les"):
                cfg, f = inputs(cases[label], 240, 80)
                for k in (2, 4, 7, 8):
                    k5_identity(f, cfg, k, f"{label} 240x80 strip {strip}")
                    n += 1
        log("k5", f"240x80 at strips (threads, rows) {IDENTITY_STRIPS}: K5 =="
            f" K4 chain bit for bit; {n} identities in all")
    finally:
        fused_fluid.STRIP = saved


def k5_timed(n: int = 4096) -> None:
    """K5 at n^2 on random input (tau 0.8, gx 1e-6, f = w_i (1 + 0.02
    N(0, 1))), f32 and bf16: K5(4) == 4 x K4 bit for bit (f32); K5 and 4
    chained K4 steps in turns (CUDA events), device ms per call
    (torch.profiler), K4 (on f32 its one-step body, on bf16 the row sweep
    at k = 1) beside the row sweep at k = 1 (f' equal), K5 at k = 8 (f32;
    16 on bf16, two sweeps) beside 8 (16) chained K4 steps, and the strip
    sweep (threads per level 64/128/256 x rows 32/64/128/256)."""
    from lbmdem_tpu_torch import SimConfig, kernels, lattice
    from lbmdem_tpu_torch.ops import fused_fluid, lbm

    lib = kernels.library()
    saved = fused_fluid.STRIP
    try:
        for storage in ("float32", "bfloat16"):
            cfg = SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, dtype="float32",
                            f_storage=storage)
            g = torch.Generator(device="cuda").manual_seed(7)
            w = torch.as_tensor(lattice.W, dtype=torch.float32, device="cuda")
            f = lbm.to_storage(w[:, None, None] * (1.0 + 0.02 * torch.randn(
                (9, n, n), generator=g, device="cuda")), cfg)
            a, b, c = (torch.empty_like(f) for _ in range(3))
            bms, by = bound(work(None, None, None, 2 * nbytes(f),
                                 4 * FLOPS_FLUID * n * n))

            def k5(k=4):
                return fused_fluid.fused_step_fluid_multi(f, cfg, k, c)

            def chain(k=4):
                return chained(k4_step(cfg), k, f, a, b)

            if storage == "float32":
                k5_identity(f, cfg, 4, f"{n}x{n}")
                log("k5", f"{n}x{n} f32: K5(4) == 4 x K4 bit for bit")
            t5, tc = [], []
            for fn, ts in ((chain, tc), (k5, t5), (k5, t5), (chain, tc)):
                ts.append(cuda_ms(fn, 10))
            dev5 = kernel_device_ms(k5)
            dev4 = kernel_device_ms(chain)
            log("k5", f"{n}x{n} {storage} k=4, ms per pass (CUDA events, in "
                f"turns: chain, K5, K5, chain): K5 {t5[0]:.4f}, {t5[1]:.4f}; "
                f"4 chained K4 {tc[0]:.4f}, {tc[1]:.4f}; bound {bms:.4f} ms "
                f"by {by}; device ms per call (torch.profiler) K5 "
                + dev_str(dev5)
                + "; 4 x K4 " + dev_str(dev4))
            bf16 = int(storage == "bfloat16")

            def sweep1():
                kernels.setting("lbm_fluid_strip", *fused_fluid.STRIP)
                kernels.check(lib.lbm_fluid_multi(
                    f.data_ptr(), c.data_ptr(), None, None, n, n, 1, bf16,
                    fused_fluid._params(cfg), fused_fluid._pair_params(cfg),
                    kernels.stream()), "K5 k=1")

            def k4():
                fused_fluid.fused_step_fluid(f, cfg, a)

            sweep1()
            k4()
            torch.cuda.synchronize()
            same1 = torch.equal(a, c)
            t1 = [cuda_ms(fn, 20) for fn in (k4, sweep1, sweep1, k4)]
            body = "one-step body" if storage == "float32" else "row sweep"
            log("k5", f"{n}x{n} {storage} one step: K4 ({body}) "
                f"{t1[0]:.4f}, {t1[3]:.4f} ms; the row sweep at k = 1 "
                f"{t1[1]:.4f}, {t1[2]:.4f} ms (CUDA events); f' equal {same1}")
            # f32: K4's one-step body and the sweep give the same f'
            assert same1, f"K4 {storage} differs from the row sweep at k = 1"
            kk = 8 if storage == "float32" else 16
            tk = [cuda_ms(fn, 5) for fn in (lambda: k5(kk),
                                            lambda: chain(kk))]
            log("k5", f"{n}x{n} {storage} k={kk}: K5 {tk[0]:.4f} ms per pass;"
                f" {kk} chained K4 {tk[1]:.4f} ms (CUDA events)")
            sweep = []
            for threads in (64, 128, 256):
                for rows in (32, 64, 128, 256):
                    fused_fluid.STRIP = (threads, rows)
                    sweep.append(f"({threads}, {rows}) "
                                 f"{cuda_ms(k5, 10):.4f}")
            fused_fluid.STRIP = saved
            log("k5", f"{n}x{n} {storage} k=4 strip sweep, ms per pass at "
                f"(threads, rows): " + ", ".join(sweep)
                + f" (chosen {saved})")
    finally:
        fused_fluid.STRIP = saved


def k3_timed(cfg, disks, label: str, seed: int = 3) -> None:
    """Every K3/K3w instantiation at the slice's shapes (4096^2, 10k disks
    packed into contact, seeded velocities and forces): K3, K3 with
    springs (kt = 25, live springs carried in), K3w, K3w with springs, K3
    on a periodic x axis. Each: one call against its plain version on the
    card (every slab channel; equal contacts), CUDA-event ms per call at
    the default cooperative grid and at grids capped to 132, 264 and 528
    blocks (the same result bit for bit), device ms per call
    (torch.profiler) and device operations per call (a CUDA graph capture
    of one call), beside its bound; K3 also at n_sub = 5, 10 and 20, for
    the cost of one phase."""
    from lbmdem_tpu_torch import DiskSpec, Simulation, kernels
    from lbmdem_tpu_torch.ops import dem, slab_dem

    rng = np.random.default_rng(seed)

    def rnd(shape, amp):
        return torch.as_tensor(rng.uniform(-amp, amp, shape),
                               dtype=torch.float32, device="cuda")

    cases = []
    for kt in (0.0, 25.0):
        sim = Simulation(cfg.replace(kt=kt), disks, device="cuda")
        c, grid, axis = sim.cfg, sim.grid, sim.dem_axis
        d = sim.state.disks
        m = d.x.shape[0]
        d = d._replace(v=rnd((m, 2), 0.02), omega=rnd((m,), 2e-3))
        F, T = rnd((m, 2), 1e-3), rnd((m,), 1e-4)
        if kt:
            for _ in range(2):
                d, _, _ = slab_dem.dem_subcycle(d, F, T, grid, c, axis)
        body = dem.body_forces(d, c)
        act = int(d.active.sum())
        tag = " kt" if kt else ""
        sl = slab_dem.build_slabs(d, F, T, body, grid, axis, kt=kt > 0)
        cases.append((f"K3{tag}", c, grid, axis, sl[0], sl[3:6], None, act))
        sw = slab_dem.build_slabs(d, None, None, body, grid, axis, kt=kt > 0,
                                  bake_forces=False)
        f3 = slab_dem._force_planes_window(sw[1], [(F, T)], body,
                                           sw[0].shape)[0]
        cases.append((f"K3w{tag}", c, grid, axis, sw[0], sw[3:6], f3, act))
    pcfg = cfg.replace(bc_west="periodic", bc_east="periodic")
    shift = 0.04 * cfg.nx
    psim = Simulation(pcfg, [DiskSpec((s.x - shift) % cfg.nx, s.y, s.r)
                             for s in disks], device="cuda")
    pd = psim.state.disks
    m = pd.x.shape[0]
    pd = pd._replace(v=rnd((m, 2), 0.02), omega=rnd((m,), 2e-3))
    F, T = rnd((m, 2), 1e-3), rnd((m,), 1e-4)
    sl = slab_dem.build_slabs(pd, F, T, dem.body_forces(pd, psim.cfg),
                              psim.grid, psim.dem_axis)
    cases.append(("K3 periodic", psim.cfg, psim.grid, psim.dem_axis, sl[0],
                  sl[3:6], None, int(pd.active.sum())))
    cap0 = slab_dem.GRID_CAP
    try:
        for name, c, grid, axis, slabs, (kmax, n_occ, bands), f3, act in \
                cases:
            if f3 is None:
                def call(s):
                    return slab_dem.subcycle_slabs(s, kmax, n_occ, bands,
                                                   grid, c, axis)[1]
                plain = slab_dem.subcycle_slabs_plain(slabs, kmax, c, grid,
                                                      axis)
            else:
                def call(s):
                    return slab_dem.subcycle_slabs_window(
                        s, f3, kmax, n_occ, bands, grid, c, axis)[1]
                plain = slab_dem.subcycle_slabs_plain(slabs, kmax, c, grid,
                                                      axis, f3)
            ref = slabs.clone()
            nc = call(ref)
            err = float((ref - plain[0]).abs().max())
            same = torch.equal(ref, plain[0])
            assert int(nc) == int(plain[1]) > 0, (name, int(nc),
                                                  int(plain[1]))
            assert err <= (3e-5 if c.kt > 0 else 2e-5), (name, err)
            scratch = slabs.clone()
            times = []
            for cap in (0, 132, 264, 528):
                slab_dem.GRID_CAP = cap
                s = slabs.clone()
                assert int(call(s)) == int(nc)
                assert torch.equal(s, ref), f"{name}: grid cap {cap}"
                times.append(f"{cap or 'occupancy'} "
                             f"{cuda_ms(lambda: call(scratch), 20):.4f}")
            slab_dem.GRID_CAP = cap0
            per = sum(kernels.captured_launches(
                lambda: call(scratch)).values())
            dev = kernel_device_ms(lambda: call(scratch))
            bms, by = bound(work(None, None, None, 2 * nbytes(slabs)
                                 + (nbytes(f3) if f3 is not None else 0),
                                 c.n_sub * act * 9 * int(kmax) * 60))
            log("k3", f"{label} {name} (kmax {int(kmax)}, {int(n_occ)} "
                f"occupied bands): against the plain version max err "
                f"{err:.3e}, equal {same}; contacts {int(nc)}; ms per call at"
                f" grid (blocks): " + ", ".join(times)
                + " (CUDA events); "
                f"{per} device operations per call (CUDA graph capture), "
                f"device ms per call "
                + dev_str(dev)
                + f" (torch.profiler); bound {bms:.4f} ms by {by}")
            assert per == 1, f"{name}: {per} device operations per call"
            # bit for bit where the 31-launch kernel was: without springs
            assert same or c.kt > 0, f"{name}: differs from the plain version"
            if name == "K3":  # the cost of one phase: n_sub + 1 phases
                ms = {n: cuda_ms(lambda: slab_dem.subcycle_slabs(
                    scratch, kmax, n_occ, bands, grid, c.replace(n_sub=n),
                    axis), 20) for n in (5, 10, 20)}
                log("k3", f"{label} K3 at n_sub 5, 10, 20: " + ", ".join(
                    f"{v:.4f}" for v in ms.values()) + " ms per call (CUDA "
                    f"events): {(ms[20] - ms[5]) / 15 * 1e3:.2f} us per "
                    f"phase, {(ms[5] - 6 * (ms[20] - ms[5]) / 15) * 1e3:.2f} "
                    "us besides")
    finally:
        slab_dem.GRID_CAP = cap0


# the lattice-option matrix of K7 at 256x64: walls with forcing, the
# Zou/He channel with the Poiseuille inlet, TRT, LES, the lambda blend
# (with LES: the per-cell form), a moving north wall, periodic on both
# axes
STATIC_MATRIX = [
    ("walls-gx", dict(bc_west="wall", bc_east="wall", gx=1e-5)),
    ("zou-he", dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                    inlet_profile="poiseuille")),
    ("trt", dict(collision="trt", gx=1e-5)),
    ("les", dict(smagorinsky=0.16, gx=2e-5)),
    ("lambda", dict(nt_mode="lambda", gx=1e-5)),
    ("trt-les-lambda", dict(collision="trt", smagorinsky=0.16,
                            nt_mode="lambda", gx=1e-5)),
    ("lid", dict(bc_west="wall", bc_east="wall", uw_north=0.08)),
    ("periodic", dict(bc_south="periodic", bc_north="periodic", gy=-1e-5)),
]


def static_bed(n: int = 4096, n_disks: int = 4096, storage="float32"):
    """bench.py's static scene (`_run_static`): n_disks fixed disks of
    r = 4 at rest on a jittered square grid from default_rng(0), tau 0.8,
    gx 1e-6, periodic x, walls in y. The same code, without importing
    bench.py."""
    from lbmdem_tpu_torch.config import DiskSpec, SimConfig

    rng = np.random.default_rng(0)
    r = 4.0
    side = int(np.ceil(np.sqrt(n_disks)))
    pitch = (n - 40.0) / side
    disks = []
    for i in range(n_disks):
        gy, gx = divmod(i, side)
        disks.append(DiskSpec(
            20.0 + (gx + 0.5) * pitch + rng.uniform(-2, 2),
            20.0 + (gy + 0.5) * pitch + rng.uniform(-2, 2),
            r, fixed=True,
        ))
    cfg = SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, dtype="float32",
                    max_disks=n_disks, out_interval=10**9, f_storage=storage)
    return cfg, disks


def static_check(cfg, solid, k: int, seed: int, label: str,
                 timed: bool = False, amp: float = 0.05):
    """K7 against its plain version on CPU copies of the same card
    inputs (the plain version on the card multiplies by 1/tau where the
    kernel divides), f = w_i (1 + amp N(0, 1)) in storage form. Bars:
    f32 rtol 1e-5 + atol 2e-6 (tests/test_pallas.py's static-kernel
    bar), bf16 3e-4. Returns work(max_abs_err, ms, plain_ms, bytes,
    flops); timed: the plain version's time on the card."""
    from lbmdem_tpu_torch import lattice
    from lbmdem_tpu_torch.ops import fused_static, lbm

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.as_tensor(lattice.W, dtype=torch.float32, device="cuda")
    f = lbm.to_storage(w[:, None, None] * (1.0 + amp * torch.randn(
        (9, cfg.ny, cfg.nx), generator=g, device="cuda")), cfg)
    a = torch.empty_like(f)
    wrapper = fused_static.fused_step_imb_static_multi
    n0 = wrapper.launches
    wrapper(f, solid, cfg, k, a)
    assert wrapper.launches == n0 + 1, "the kernel did not launch"
    fc = f.cpu()
    b = fused_static.fused_step_imb_static_multi_plain(
        fc, solid.cpu(), cfg, k, torch.empty_like(fc))
    ka, pb = a.float().cpu(), b.float()
    err = float((ka - pb).abs().max())
    atol, rtol = (3e-4, 0.0) if cfg.f_storage == "bfloat16" else (2e-6, 1e-5)
    excess = float(((ka - pb).abs() - rtol * pb.abs()).max())
    moved = float((pb - fc.float()).abs().max())
    log("static", f"{label} K7 k={k}: max err {err:.3e} (bar atol {atol:g} "
        f"+ rtol {rtol:g}; plain version on CPU tensors); max |step| "
        f"{moved:.3e}")
    assert bool(torch.isfinite(ka).all()), f"{label} K7 k={k}: non-finite"
    assert excess <= atol, f"{label} K7 k={k}: err {err} over the bar"
    assert moved > 0.0, f"{label} K7 k={k}: the pass changed nothing"
    t = (None, None)
    if timed:
        pc = torch.empty_like(f)
        t = (cuda_ms(lambda: wrapper(f, solid, cfg, k, a), 20),
             cuda_ms(lambda: fused_static.fused_step_imb_static_multi_plain(
                 f, solid, cfg, k, pc), 2))
    return work(err, *t, 2 * nbytes(f) + nbytes(solid),
                k * nt_flops(solid))


def static_kernels():
    """K7 over STATIC_MATRIX at 256x64 (k = 1, 4, 8; f32 and bf16) on a
    stamped row of obstacles, some across the periodic seams; then k = 4
    at 4096^2 on the static scene's solid stack, timed. Returns the
    4096^2 f32 work record."""
    from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    obstacles = [DiskSpec(x, y, r, fixed=True) for x, y, r in (
        (1.2, 20.3, 4.0), (64.3, 32.1, 4.0), (128.0, 40.0, 3.0),
        (200.5, 60.2, 5.0), (240.0, 12.7, 3.5))]
    for i, (label, kw) in enumerate(STATIC_MATRIX):
        for storage in ("float32", "bfloat16"):
            cfg = SimConfig(**{"nx": 256, "ny": 64, "tau": 0.8,
                               "dtype": "float32", "f_storage": storage,
                               **kw})
            sim = Simulation(cfg, obstacles, device="cuda")
            solid = sim._static_solid_operands()
            for k in (1, 4, 8):
                static_check(sim.cfg, solid, k, 200 + i,
                             f"{label} {storage} 256x64")
    out = {}
    for storage in ("float32", "bfloat16"):
        sim = Simulation(*static_bed(storage=storage), device="cuda")
        solid = sim._static_solid_operands()
        cfg = sim.cfg
        w = static_check(cfg, solid, 4, 9, f"4096x4096 {storage}",
                         timed=True, amp=0.02)
        bms, by = bound(w)
        log("static", f"4096x4096 {storage} K7 (k=4): kernel {w['ms']:.4f} "
            f"ms per pass ({w['ms'] / 4:.4f} ms per step), plain version on "
            f"the card {w['plain_ms']:.4f} ms (CUDA events); memory floor "
            f"{w['bytes'] / 1e9:.4f} GB = {w['bytes'] / HBM_BPS * 1e3:.4f} "
            f"ms, {w['flops'] / 1e9:.3f} GFLOP = "
            f"{w['flops'] / F32_FLOPS * 1e3:.4f} ms; bound {bms:.4f} ms by "
            f"{by}: kernel at "
            f"{100 * bms / w['ms']:.1f} % of it")
        if storage == "float32":
            out["K7"] = w
        del sim, solid
    return out


def device_profile(sim, steps: int = 40):
    """torch.profiler over run(steps): (device ms per step, wall ms per
    step of the profiled run, top kernels by device time)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sim.run(steps)
        wall = time.perf_counter() - t0
    kern = [(a.key, a.self_device_time_total) for a in prof.key_averages()
            if a.device_type == DeviceType.CUDA]
    dev_us = sum(t for _, t in kern)
    top = sorted(kern, key=lambda x: -x[1])[:3]
    return (dev_us / 1e3 / steps if kern else None), wall * 1e3 / steps, top


def idle_str(dev_ms, wall_ms: float, of: str) -> str:
    """Device ms per step and the idle share of `of`'s wall ms per step;
    "not measured" when torch.profiler kept no device records."""
    if dev_ms is None:
        return ("device time not measured (torch.profiler kept no device "
                "records)")
    return (f"device {dev_ms:.4f} ms per step, idle share "
            f"{100 * max(0.0, 1 - dev_ms / wall_ms):.1f} % of {of}")


def static_slice(smi: str, storage: str):
    """The static hoist through Simulation(*static_bed(), device="cuda"):
    run(400) to warm (K1 once, then K7), run(400) timed, the checks,
    then the profiler over run(40), then K7 (k = 4) and, on f32, 4
    chained K8 steps on the run's own state. Returns (launch counts of the
    warm run, MLUPS)."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import fused_static, lbm

    cfg, disks = static_bed(storage=storage)
    sim = Simulation(cfg, disks, device="cuda")
    assert sim.static_solid and sim.dem_mode == "drift"
    reset_counts()
    sim.run(400)
    first = launch_counts()
    reset_counts()
    mlups = sim.run(400)
    timed = launch_counts()
    cfg = sim.cfg
    f = lbm.from_storage(sim.state.f, cfg)
    finite = bool(torch.isfinite(f).all())
    mass_err = abs(float(f.double().sum()) / (cfg.nx * cfg.ny) - 1.0)
    ux = float(lbm.moments(f, cfg.gx, cfg.gy)[1].double().mean())
    bar = 1e-5 if storage == "float32" else 1e-4
    eps = float(sim._static_solid_operands()[0].double().sum())
    dev_ms, prof_ms, top = device_profile(sim)
    wall_ms = 1e3 * cfg.nx * cfg.ny / (mlups * 1e6)
    log("static-slice", f"{cfg.nx}x{cfg.ny} {storage}, {len(disks)} fixed "
        f"disks r=4 at rest, tau 0.8, gx 1e-6: {mlups:.1f} MLUPS (timed "
        f"run(400), wall clock; {wall_ms:.4f} ms per step) on {smi}; solid "
        f"fraction {eps / (cfg.nx * cfg.ny):.5f}")
    log("static-slice", f"launches warm run(400) {first}; timed run(400) "
        f"{timed}; steps {int(sim.state.step)}; overflow "
        f"{int(sim.state.overflow)}; finite {finite}; |sum f/(nx ny) - 1| "
        f"{mass_err:.3e} (bar {bar:g}); mean ux {ux:.4e}")
    log("static-slice", f"profiler run(40): {prof_ms:.4f} ms wall per step "
        f"(profiled), {wall_ms:.4f} ms (timed run); "
        + idle_str(dev_ms, wall_ms, "the timed run")
        + f"; top kernels {[(k[:40], round(t / 1e3, 3)) for k, t in top]} ms")
    zero = {k: 0 for k in first}
    assert first == {**zero, "K1": 1, "K7": 100}, first
    assert timed == {**zero, "K7": 100}, timed
    assert int(sim.state.step) == 840
    assert int(sim.state.overflow) == 0
    assert finite, "non-finite f"
    assert mass_err < bar, f"mass drift {mass_err}"
    assert ux > 0.0, "the body force drove no flow"
    f, o = sim.state.f, torch.empty_like(sim.state.f)
    solid = sim._static_solid_operands()
    t7 = cuda_ms(lambda: fused_static.fused_step_imb_static_multi(
        f, solid, cfg, 4, o), 10)
    msg = (f"K7 k=4 on the run's state after {int(sim.state.step)} steps: "
           f"{t7:.4f} ms per pass")
    if storage == "float32":
        a, b = torch.empty_like(f), torch.empty_like(f)
        t8 = cuda_ms(lambda: chained(k8_step(solid, cfg), 4, f, a, b), 10)
        msg += f"; 4 chained K8 {t8:.4f} ms"
    log("static-slice", msg + " (CUDA events)")
    return first, mlups


def offset_porous_bed(n: int = 256, pitch: int = 32):
    """models.porous_bed (fully periodic, r 6) shifted by half a pitch so
    that every disk sits on a seam or a corner; gx 1e-5 for a visible
    drag."""
    from lbmdem_tpu_torch.config import DiskSpec
    from lbmdem_tpu_torch.models import porous_bed

    cfg, disks = porous_bed(nx=n, ny=n, pitch=pitch)
    return cfg.replace(gx=1e-5), [
        DiskSpec(d.x - pitch / 2, d.y - pitch / 2, d.r, fixed=True)
        for d in disks]


def ghosts_vs_cpu() -> None:
    """The offset porous bed: its periodic ghost count, run(40) (10 K7
    passes after K1) on the card against the CPU run (f within 1e-5) and
    hydro_forces() on the card against the CPU's (1e-4 of max |F|)."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import imb

    cfg, disks = offset_porous_bed()
    g = Simulation(cfg, disks, device="cuda")
    c = Simulation(cfg, disks, device="cpu")
    d = g.state.disks
    _, _, parent, _, govf = imb.periodic_ghosts(d.x, d.v, d.omega, d.r,
                                                d.active, g.cfg)
    n_ghosts = int((parent >= 0).sum())
    reset_counts()
    g.run(40)
    counts = launch_counts()
    c.run(40)
    ef = float((g.state.f.cpu() - c.state.f).abs().max())
    Fg, Tg = g.hydro_forces()
    Fc, Tc = c.hydro_forces()
    scale = float(np.abs(Fc).max())
    eF = float(np.abs(Fg - Fc).max())
    log("ghosts", f"offset porous bed {cfg.nx}x{cfg.ny}, {len(disks)} fixed "
        f"disks on the seams, fully periodic: {n_ghosts} ghosts (cap "
        f"{g.cfg.ghost_cap} per block, overflow {int(govf)}); run(40) "
        f"launches {counts}; f max err {ef:.3e} (bar 1e-5); hydro_forces "
        f"max err {eF:.3e} of max |F| {scale:.3e} (bar 1e-4 relative); "
        f"torque err {float(np.abs(Tg - Tc).max()):.3e}")
    assert n_ghosts > 0 and int(govf) == 0
    assert counts["K7"] == 10 and counts["K1"] == 1, counts
    assert int(g.state.overflow) == 0
    assert ef <= 1e-5
    assert scale > 0 and eF <= 1e-4 * scale


def drift_vs_cpu() -> None:
    """Prescribed motion: a 256^2 periodic-x channel (gx 1e-5) with a
    fixed disk at rest and one moving at vx = 0.01; run(19) on the card
    (K1 + K2 per step, no K7, no DEM) against the CPU run."""
    from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation

    cfg = SimConfig(nx=256, ny=256, tau=0.8, gx=1e-5, dtype="float32",
                    out_interval=10**9)
    disks = [DiskSpec(64.0, 128.0, 6.0, fixed=True),
             DiskSpec(160.3, 120.0, 6.0, vx=0.01, fixed=True)]
    g = Simulation(cfg, disks, device="cuda")
    c = Simulation(cfg, disks, device="cpu")
    assert g.dem_mode == "drift" and not g.static_solid
    x0 = float(g.state.disks.x[1, 0])
    want = np.float32(x0)  # x0 + 19 vx, one f32 addition per step
    for _ in range(19):
        want = np.float32(want + np.float32(0.01))
    reset_counts()
    g.run(19)
    counts = launch_counts()
    c.run(19)
    ef = float((g.state.f.cpu() - c.state.f).abs().max())
    xg, xc = g.state.disks.x.cpu(), c.state.disks.x
    log("drift", f"{cfg.nx}x{cfg.ny} periodic x, one fixed disk at rest and "
        f"one at vx 0.01, 19 steps: launches {counts}; f max err {ef:.3e} "
        f"(bar 1e-5); moving disk x {float(xg[1, 0]):.6f} (x0 + 19 vx in "
        f"f32 steps {float(want):.6f}; CPU {float(xc[1, 0]):.6f})")
    zero = {k: 0 for k in counts}
    assert counts == {**zero, "K1": 19, "K2": 19}, counts
    assert int(g.state.overflow) == 0
    assert ef <= 1e-5
    assert torch.equal(xg, xc), "card and CPU positions differ"
    assert float(xg[1, 0]) == float(want), (float(xg[1, 0]), float(want))
    assert float(xg[0, 0]) == 64.0


# the lattice-option matrix of K8 at 256x64 (tests/test_pallas.py's
# coupled-kernel cases and more): BGK, TRT, LES, TRT + LES, the lambda
# blend, moving walls, the Zou/He channel with the Poiseuille inlet,
# periodic x (the default) and y
SPLIT_MATRIX = [
    ("bgk", dict(bc_west="wall", bc_east="wall", gy=-1e-5)),
    ("trt", dict(collision="trt", gy=-1e-5)),
    ("les", dict(smagorinsky=0.16, gx=2e-5, bc_west="wall", bc_east="wall")),
    ("trt-les", dict(collision="trt", smagorinsky=0.16, gx=1e-5)),
    ("lambda", dict(nt_mode="lambda", gy=-1e-5, bc_west="wall",
                    bc_east="wall")),
    ("moving-wall", dict(bc_west="wall", bc_east="wall", uw_north=0.05,
                         uw_south=-0.02)),
    ("zou-he", dict(bc_west="inlet", bc_east="outlet", u_inlet=0.05,
                    inlet_profile="poiseuille")),
    ("periodic", dict(bc_south="periodic", bc_north="periodic", gx=1e-5)),
]


def split_matrix() -> None:
    """K8 against its plain version on CPU copies of the same inputs over
    SPLIT_MATRIX at 256x64: five moving disks stamped by the oracle (Zou/He
    columns masked, as Simulation masks them), f = w_i (1 + 0.05 N(0,
    1)). Bars (tests/test_pallas.py): f' rtol 1e-6 + atol 1e-7, phi rtol
    1e-5 + atol 5e-8."""
    from lbmdem_tpu_torch import SimConfig, lattice
    from lbmdem_tpu_torch.config import window_for_radius
    from lbmdem_tpu_torch.ops import fused_lbm, imb

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    x = torch.tensor([[1.2, 20.3], [64.3, 32.1], [128.0, 40.0], [200.5, 60.2],
                      [240.0, 12.7]])
    v = torch.tensor([[0.01, -0.02], [0.0, 0.01], [-0.02, 0.0], [0.01, 0.01],
                      [0.0, -0.01]])
    om = torch.tensor([0.005, -0.003, 0.0, 0.002, 0.001])
    r = torch.tensor([4.0, 4.0, 3.0, 5.0, 3.5])
    act = torch.ones(5, dtype=torch.bool)
    rng = np.random.default_rng(31)
    f = torch.as_tensor(lattice.W[:, None, None] * (
        1.0 + 0.05 * rng.standard_normal((9, 64, 256))), dtype=torch.float32)
    wrapper = fused_lbm.fused_step_imb
    for label, kw in SPLIT_MATRIX:
        cfg = SimConfig(**{"nx": 256, "ny": 64, "tau": 0.8, "dtype": "float32",
                           "max_disks": 5, "window": window_for_radius(5.0),
                           **kw})
        fields = imb.stamp_solid_fraction(x, v, om, r, act, cfg)
        if cfg.bc_west == "inlet":
            fields = imb.mask_open_columns(*fields)
        dev_in = [t.cuda() for t in (f, *fields)]
        a = torch.empty_like(dev_in[0])
        n0 = wrapper.launches
        _, kx, ky = wrapper(*dev_in, cfg, a)
        assert wrapper.launches == n0 + 1, "the kernel did not launch"
        b, px, py = fused_lbm.fused_step_imb_plain(f, *fields, cfg,
                                                   torch.empty_like(f))
        ka = a.cpu()
        err = float((ka - b).abs().max())
        excess = float(((ka - b).abs() - 1e-6 * b.abs()).max())
        perr = max(float((k.cpu() - p).abs().max()) for k, p in ((kx, px),
                                                              (ky, py)))
        pex = max(float(((k.cpu() - p).abs() - 1e-5 * p.abs()).max())
                  for k, p in ((kx, px), (ky, py)))
        log("split", f"{label} 256x64 K8: f' max err {err:.3e} (bar atol "
            f"1e-7 + rtol 1e-6), phi max err {perr:.3e} (bar atol 5e-8 + "
            f"rtol 1e-5; plain version on CPU tensors); max |phi| "
            f"{float(px.abs().max()):.3e}")
        assert bool(torch.isfinite(ka).all()), f"K8 {label}: non-finite"
        assert excess <= 1e-7, f"K8 {label}: f' err {err} over the bar"
        assert pex <= 5e-8, f"K8 {label}: phi err {perr} over the bar"
        assert float(px.abs().max()) > 0.0


def split_checks(cfg, disks, label: str, timed: bool, seed: int = 1):
    """For eps_method sample, ramp, exact and sample with eps_r_shift on
    the packed scene: K1 against its plain version (bar 1e-6); K8 + K9
    against K2 on the same input (f' equal, forces atol 1e-6); K9 against
    its plain version on the same card inputs (F, T atol 1e-6); K2's
    reduce under ramp and exact against its plain version (forces 1e-6
    of max |F|). Timed: K8 and K9 (sample) with their plain versions on
    the card. Returns {"K8": work, "K9": work} when timed."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import fused_lbm, lbm, stamp

    sim = Simulation(cfg, disks, device="cuda")
    cfg = sim.cfg
    rng = np.random.default_rng(seed)
    d = sim.state.disks
    n = d.x.shape[0]
    dev = d.x.device
    d = d._replace(
        v=torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)), dtype=torch.float32,
                          device=dev),
        omega=torch.as_tensor(rng.uniform(-2e-3, 2e-3, n), dtype=torch.float32,
                              device=dev))
    tile_data, counts, es, ovf = stamp.bin_disks_to_tiles(
        d.x, d.v, d.omega, d.r, d.active, cfg)
    assert int(ovf) == 0, f"binning overflow {int(ovf)}"
    f = lbm.init_equilibrium(cfg, dev) * (1.0 + 0.02 * torch.as_tensor(
        rng.standard_normal((9, cfg.ny, cfg.nx)), dtype=torch.float32,
        device=dev))
    fa, fb = torch.empty_like(f), torch.empty_like(f)
    cells = cfg.nx * cfg.ny
    out = {}
    for method, shift in (("sample", 0.0), ("ramp", 0.0), ("exact", 0.0),
                          ("sample", -0.4)):
        mcfg = cfg.replace(eps_method=method, eps_r_shift=shift)
        tag = f"{label} {method}" + (f" r_shift {shift:g}" if shift else "")
        solid = stamp.stamp_fields(tile_data, counts, mcfg)
        e1 = float((solid - stamp.stamp_fields_plain(tile_data, counts,
                                                     mcfg)).abs().max())
        assert e1 <= 1e-6, f"K1 {tag}: max |kernel - plain| {e1} > 1e-6"
        eps, usx, usy = solid[0], solid[1], solid[2]
        _, phix, phiy = fused_lbm.fused_step_imb(f, eps, usx, usy, mcfg, fa)
        F9, T9 = stamp.reduce_hydro_forces(d.x, d.r, d.active, eps, phix,
                                           phiy, mcfg, tile_data, counts, es)
        _, parts = fused_lbm.fused_step_imb_reduce(f, solid, tile_data, counts,
                                                   mcfg, fb)
        F2, T2 = stamp.gather_partials(parts, es, torch.float32)
        same = torch.equal(fa, fb)
        e82 = max(float((F9 - F2).abs().max()), float((T9 - T2).abs().max()))
        Fp, Tp = stamp.gather_partials(stamp.hydro_partials_plain(
            eps, phix, phiy, tile_data, counts, mcfg), es, torch.float32)
        fmax = float(Fp.abs().max())
        tmax = float(Tp.abs().max())
        # K9 against its plain version: the JAX package's atol 1e-6 holds
        # for its |F| < 1; the f32 sums of larger forces and torques
        # differ in order by a few ulp of the largest, so the bar scales
        # with them above 1
        e9 = float((F9 - Fp).abs().max())
        e9t = float((T9 - Tp).abs().max())
        msg = (f"{tag}: K1 max err {e1:.3e} (bar 1e-6); K8 f' == K2 f' "
               f"{same}; K8 + K9 vs K2 forces/torques max err {e82:.3e} (bar "
               f"1e-6); K9 vs plain F {e9:.3e} of max |F| {fmax:.3e}, T "
               f"{e9t:.3e} of max |T| {tmax:.3e} (bars 1e-6 * max(1, max))")
        if method != "sample":
            _, pp = fused_lbm.fused_step_imb_reduce_plain(
                f, solid, tile_data, counts, mcfg, torch.empty_like(f))
            F2p, _ = stamp.gather_partials(pp, es, torch.float32)
            e2r = float((F2 - F2p).abs().max())
            msg += (f"; K2 {method} reduce vs plain {e2r:.3e} (bar 1e-6 * "
                    f"max|F|)")
            assert e2r <= 1e-6 * fmax, f"K2 {tag}: force err {e2r}"
        log("split", msg)
        assert same, f"K8 {tag}: f' differs from K2's"
        assert e82 <= 1e-6, f"K8 + K9 {tag}: forces differ from K2's by {e82}"
        assert e9 <= 1e-6 * max(1.0, fmax), f"K9 {tag}: F err {e9}"
        assert e9t <= 1e-6 * max(1.0, tmax), f"K9 {tag}: T err {e9t}"
        assert fmax > 0.0
        if timed and method != "sample":
            log("split", f"{tag} K1 kernel "
                f"{cuda_ms(lambda: stamp.stamp_fields(tile_data, counts, mcfg), 20):.4f}"
                f" ms (CUDA events)")
        if timed and method == "sample" and not shift:
            eps8 = (eps, usx, usy)
            phi8 = (phix, phiy)
            cov_cells = int(counts.sum()) * cfg.window ** 2
            w8 = work(float((fa - fused_lbm.fused_step_imb_plain(
                          f, *eps8, cfg, fb)[0]).abs().max()),
                      cuda_ms(lambda: fused_lbm.fused_step_imb(
                          f, *eps8, cfg, fa), 20),
                      cuda_ms(lambda: fused_lbm.fused_step_imb_plain(
                          f, *eps8, cfg, fb), 2),
                      nbytes(f, eps, usx, usy, fa, phix, phiy),
                      nt_flops(solid))
            w9 = work(e9,
                      cuda_ms(lambda: stamp.reduce_hydro_forces(
                          d.x, d.r, d.active, eps, *phi8, cfg, tile_data,
                          counts, es), 20),
                      cuda_ms(lambda: stamp.gather_partials(
                          stamp.hydro_partials_plain(eps, *phi8, tile_data,
                                                     counts, cfg),
                          es, torch.float32), 2),
                      nbytes(tile_data, counts, parts, F9, T9)
                      + 12 * min(cells, cov_cells),
                      cov_flops_of(cfg, counts))
            out = {"K8": w8, "K9": w9}
            for k, w in out.items():
                bms, by = bound(w)
                log("split", f"{label} {k}: kernel {w['ms']:.4f} ms, plain "
                    f"{w['plain_ms']:.4f} ms (CUDA events); bound {bms:.4f} "
                    f"ms by {by} ({w['bytes'] / 1e9:.4f} GB, "
                    f"{w['flops'] / 1e9:.3f} GFLOP)")
    return out


def cov_flops_of(cfg, counts) -> float:
    """Operations of the reduce over every binned window: the coverage
    and ~12 to weight and sum a force, per window cell."""
    return (int(counts.sum()) * cfg.window ** 2
            * (COV_OPS[cfg.eps_method](cfg.eps_samples) + 12))


def split_on_run_state(sim) -> None:
    """K8 (f32 storage only) and K2 (at the step kernel's block sizes) on
    a run's own (smooth) state, CUDA events: before the collide skipped
    the divide of a zero numerator, its slow path made the collides
    slower there than on random input."""
    from lbmdem_tpu_torch.ops import fused_lbm, stamp

    cfg = sim.cfg
    d = sim.state.disks
    tile_data, counts, _, _ = stamp.bin_disks_to_tiles(d.x, d.v, d.omega, d.r,
                                                       d.active, cfg)
    solid = stamp.stamp_fields(tile_data, counts, cfg)
    f, out = sim.state.f, torch.empty_like(sim.state.f)
    k8 = "" if cfg.f_storage != "float32" else "K8 %.4f ms, " % cuda_ms(
        lambda: fused_lbm.fused_step_imb(f, solid[0], solid[1], solid[2], cfg,
                                         out), 20)
    k2 = block_times(lambda: fused_lbm.fused_step_imb_reduce(
        f, solid, tile_data, counts, cfg, out))
    log("split", f"on the {cfg.eps_method} {cfg.f_storage} slice's state "
        f"after {int(sim.state.step)} steps: {k8}K2 {k2}")


# the lattice-option matrix of K2 and K6 at 256x64: SPLIT_MATRIX and
# every option at once on an open channel
BREADTH_MATRIX = SPLIT_MATRIX + [
    ("all", dict(collision="trt", smagorinsky=0.16, nt_mode="lambda",
                 gx=1e-5, gy=-1e-5, uw_north=0.03, bc_west="inlet",
                 bc_east="outlet", u_inlet=0.05,
                 inlet_profile="poiseuille")),
]


def breadth_matrix() -> None:
    """K2 and K6 (k = 2, 4) over BREADTH_MATRIX at 256x64 on f32 and
    shifted-bf16 storage against their plain versions on CPU copies of
    the same inputs (the plain version on the card multiplies by 1/tau):
    five moving disks binned across the tiles, Zou/He columns zeroed as
    Simulation zeroes them. Bars: f' 5e-6 (bf16 3e-4), every (inner)
    step's forces 1e-6 of the largest |F| (bf16: 5e-6, the kernel's
    shifted arithmetic rounds differently from the plain version's
    physical form). On f32, K8 + K9 against K2: f' and forces bit for
    bit."""
    from lbmdem_tpu_torch import SimConfig, lattice
    from lbmdem_tpu_torch.config import window_for_radius
    from lbmdem_tpu_torch.ops import fused_lbm, lbm, stamp

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    x = torch.tensor([[1.2, 20.3], [64.3, 32.1], [128.0, 40.0], [200.5, 60.2],
                      [240.0, 12.7]])
    v = torch.tensor([[0.01, -0.02], [0.0, 0.01], [-0.02, 0.0], [0.01, 0.01],
                      [0.0, -0.01]])
    om = torch.tensor([0.005, -0.003, 0.0, 0.002, 0.001])
    r = torch.tensor([4.0, 4.0, 3.0, 5.0, 3.5])
    act = torch.ones(5, dtype=torch.bool)
    rng = np.random.default_rng(37)
    f32 = torch.as_tensor(lattice.W[:, None, None] * (
        1.0 + 0.05 * rng.standard_normal((9, 64, 256))), dtype=torch.float32)
    k2, k6 = (fused_lbm.fused_step_imb_reduce,
              fused_lbm.fused_step_imb_reduce_multi)

    def forces_err(pk, pp, es):
        Fk, _ = stamp.gather_partials(pk.cpu(), es, torch.float32)
        Fp, _ = stamp.gather_partials(pp, es, torch.float32)
        fmax = float(Fp.abs().max())
        assert fmax > 0.0
        return float((Fk - Fp).abs().max()) / fmax

    for label, kw in BREADTH_MATRIX:
        for storage in ("float32", "bfloat16"):
            cfg = SimConfig(**{"nx": 256, "ny": 64, "tau": 0.8,
                               "dtype": "float32", "max_disks": 5,
                               "window": window_for_radius(5.0),
                               "tile_cap": 8, "f_storage": storage, **kw})
            td, cnt, es, ovf = stamp.bin_disks_to_tiles(x, v, om, r, act, cfg)
            assert int(ovf) == 0
            solid = stamp.stamp_fields(td, cnt, cfg)
            if cfg.bc_west == "inlet":
                solid[:, :, 0].zero_()
                solid[:, :, -1].zero_()
            f = lbm.to_storage(f32, cfg)
            cpu_in = (f, solid, td, cnt)
            dev_in = [t.cuda() for t in cpu_in]
            a = torch.empty_like(dev_in[0])
            fbar, rbar = (5e-6, 1e-6) if storage == "float32" else (3e-4, 5e-6)
            n0 = k2.launches
            _, pk = k2(*dev_in, cfg, a)
            assert k2.launches == n0 + 1, "K2 did not launch"
            b, pp = fused_lbm.fused_step_imb_reduce_plain(
                *cpu_in, cfg, torch.empty_like(f))
            errs = [float((a.float().cpu() - b.float()).abs().max())]
            rels = [forces_err(pk, pp, es)]
            for k in (2, 4):
                n0 = k6.launches
                _, pk = k6(*dev_in, cfg, k, a)
                assert k6.launches == n0 + 1, "K6 did not launch"
                b, pp = fused_lbm.fused_step_imb_reduce_multi_plain(
                    *cpu_in, cfg, k, torch.empty_like(f))
                errs.append(float((a.float().cpu() - b.float()).abs().max()))
                rels.append(max(forces_err(pk[t], pp[t], es)
                                for t in range(k)))
            msg = (f"{label} {storage} 256x64: f' max err K2 {errs[0]:.3e}, "
                   f"K6 k=2 {errs[1]:.3e}, k=4 {errs[2]:.3e} (bar {fbar:g}); "
                   f"forces of max |F| K2 {rels[0]:.3e}, K6 {rels[1]:.3e}, "
                   f"{rels[2]:.3e} (bar {rbar:g}; plain versions on CPU "
                   f"tensors)")
            assert bool(torch.isfinite(a.float()).all())
            assert max(errs) <= fbar, f"{label} {storage}: f' {errs}"
            assert max(rels) <= rbar, f"{label} {storage}: forces {rels}"
            if storage == "float32":
                # K8 + K9 against K2, bit for bit
                fa, fb = torch.empty_like(a), torch.empty_like(a)
                fd, sd, tdd, cd = dev_in
                _, p2 = k2(fd, sd, tdd, cd, cfg, fa)
                _, phx, phy = fused_lbm.fused_step_imb(fd, sd[0], sd[1],
                                                       sd[2], cfg, fb)
                esd = es.cuda()
                F9, T9 = stamp.reduce_hydro_forces(
                    x.cuda(), r.cuda(), act.cuda(), sd[0], phx, phy, cfg, tdd,
                    cd, esd)
                F2, T2 = stamp.gather_partials(p2, esd, torch.float32)
                same = (torch.equal(fa, fb), torch.equal(F2, F9),
                        torch.equal(T2, T9))
                msg += f"; K8 + K9 == K2 bitwise (f', F, T) {same}"
                assert all(same), f"{label}: K8 + K9 differ from K2 {same}"
            log("breadth", msg)


def breadth_timed(cfg, disks, label: str, seed: int = 5):
    """K2 and K6 (k = 4) at the slice's shapes on the packed scene for
    the new instantiations - shifted-bf16 storage, and TRT + LES on f32
    - against their plain versions on the same card inputs (f' 3e-4 for
    bf16; TRT + LES 5e-6, K6 2e-5: the plain version on the card
    multiplies by 1/tau), with CUDA-event times beside the f32 BGK
    instantiation's in this call and each one's bound. Returns {name:
    work}."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import fused_lbm, lbm, stamp

    sim = Simulation(cfg, disks, device="cuda")
    base = sim.cfg
    rng = np.random.default_rng(seed)
    d = sim.state.disks
    n = d.x.shape[0]
    dev = d.x.device
    vel = torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)), dtype=torch.float32,
                          device=dev)
    td, cnt, es, ovf = stamp.bin_disks_to_tiles(d.x, vel, d.omega, d.r,
                                                d.active, base)
    assert int(ovf) == 0
    solid = stamp.stamp_fields(td, cnt, base)
    f32 = lbm.init_equilibrium(base, dev) * (1.0 + 0.02 * torch.as_tensor(
        rng.standard_normal((9, base.ny, base.nx)), dtype=torch.float32,
        device=dev))
    cov = cov_flops_of(base, cnt)
    out = {}
    variants = (("f32 bgk", {}, 5e-6, 5e-6),
                ("bf16", dict(f_storage="bfloat16"), 3e-4, 3e-4),
                ("f32 trt+les", dict(collision="trt", smagorinsky=0.16),
                 5e-6, 2e-5))
    for name, kw, bar2, bar6 in variants:
        c = base.replace(**kw)
        f = lbm.to_storage(f32, c)
        a, b = torch.empty_like(f), torch.empty_like(f)
        for key, k, bar in (("K2", None, bar2), ("K6", 4, bar6)):
            if k is None:
                run = lambda: fused_lbm.fused_step_imb_reduce(  # noqa: E731
                    f, solid, td, cnt, c, a)
                plain = lambda: fused_lbm.fused_step_imb_reduce_plain(  # noqa
                    f, solid, td, cnt, c, b)
            else:
                run = lambda: fused_lbm.fused_step_imb_reduce_multi(  # noqa
                    f, solid, td, cnt, c, k, a)
                plain = lambda: fused_lbm.fused_step_imb_reduce_multi_plain(
                    f, solid, td, cnt, c, k, b)  # noqa: E731
            _, parts = run()
            plain()
            err = float((a.float() - b.float()).abs().max())
            assert err <= bar, f"{key} {name} {label}: f' err {err} > {bar}"
            nk = k or 1
            w = work(err, cuda_ms(run, 10), cuda_ms(plain, 1),
                     nbytes(f, solid, td, cnt, a, parts),
                     nk * (nt_flops(solid) + cov))
            out[f"{key} {name}"] = w
            bms, by = bound(w)
            chain = ""
            if k:
                fa, fb = torch.empty_like(f), torch.empty_like(f)
                t2 = cuda_ms(lambda: chained(k2_step(solid, td, cnt, c), 4,
                                             f, fa, fb), 10)
                chain = f"; 4 chained K2 {t2:.4f} ms"
            log("breadth", f"{label} {key} {name}: f' max err {err:.3e} (bar "
                f"{bar:g}); kernel {w['ms']:.4f} ms, plain {w['plain_ms']:.4f}"
                f" ms (CUDA events); bound {bms:.4f} ms by {by} "
                f"({w['bytes'] / 1e9:.4f} GB){chain}")
    return out


# the coverage sweep's eps_method cases: sample at five sample counts,
# ramp and exact; each with and without eps_r_shift
SWEEP_METHODS = [("sample", ns) for ns in (2, 3, 4, 5, 8)] + [("ramp", 4),
                                                               ("exact", 4)]


def sweep_scene(nx: int = 512, ny: int = 512, n: int = 240, seed: int = 11):
    """Disks (x, v, omega, r, active) on CPU tensors for the coverage
    sweep: centres on a 1/8 sub-cell grid (integers, half-integers, cell
    corners), half the radii chosen so the rim passes exactly through a
    sample point of ns 3 or 4, windows clipped by the domain (corner
    disks) and by the tiles (disks on tile corners); the stamp tile at
    the top right is left empty."""
    rng = np.random.default_rng(seed)
    x = rng.integers(16, 8 * (nx - 140), n) / 8.0
    y = rng.integers(16, 8 * (ny - 16), n) / 8.0
    x[:6] = [0.3, nx - 0.4, 0.0, 128.0, 256.5, 383.5]
    y[:6] = [0.2, 0.3, ny - 1.0, 256.0, 255.5, 100.0]
    r = rng.uniform(1.5, 6.0, n)
    for j in range(0, n, 2):  # a rim through a sample point
        ns = 3 + (j // 2) % 2
        s = (np.arange(ns) + 0.5) / ns - 0.5
        a = np.floor(x[j]) + rng.integers(-4, 5) + rng.choice(s) - x[j]
        b = np.floor(y[j]) + rng.integers(-4, 5) + rng.choice(s) - y[j]
        r[j] = np.float32(np.hypot(np.float32(a), np.float32(b)))
    r = np.clip(r, 1.5, 6.0)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa
    v = t(rng.uniform(-0.02, 0.02, (n, 2)))
    om = t(rng.uniform(-2e-3, 2e-3, n))
    return (t(np.stack([x, y], 1)), v, om, t(r),
            torch.ones(n, dtype=torch.bool))


def plain_stamp_cpu(td, cnt, cfg):
    """K1's plain version on CPU copies, single-threaded: its per-cell
    sums run in slot order (on the card index_add_ adds in the order its
    atomics land, and the CPU at 8 threads gave a ramp or exact call that
    differed from the next ones, PERF.md section 7)."""
    from lbmdem_tpu_torch.ops import stamp

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return stamp.stamp_fields_plain(td.cpu(), cnt.cpu(), cfg)
    finally:
        torch.set_num_threads(n)


def coverage_sweep() -> None:
    """K1 against its plain version bit for bit over SWEEP_METHODS with
    eps_r_shift 0 and -0.4 on sweep_scene (the kernel on the card against
    the plain version on CPU copies, plain_stamp_cpu; the plain version
    on the card, whose index_add_ sums in atomic order, within 1e-6 as a
    second witness), at a tile capacity equal to the fullest tile's
    count, so one tile has count == cap and one has count 0. On the same
    scenes the reduces: K2's partials (launch (b)) and K9's against
    hydro_partials_plain of K8's phi within 1e-6 of max(1, max |F|) (and
    of max(1, max |T|) for torques), K8 + K9 == K2 bit for bit, and every
    partial row past its tile's count exactly 0."""
    from lbmdem_tpu_torch import SimConfig
    from lbmdem_tpu_torch.config import window_for_radius
    from lbmdem_tpu_torch.ops import fused_lbm, lbm, stamp

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    x, v, om, r, act = sweep_scene()
    base = SimConfig(nx=512, ny=512, tau=0.8, dtype="float32",
                     bc_west="wall", bc_east="wall", max_disks=x.shape[0],
                     window=window_for_radius(float(r.max())), tile_cap=4096)
    _, cnt, _, ovf = stamp.build_tile_lists(x, act, base)
    cap = int(cnt.max())
    assert int(ovf) == 0 and int(cnt.min()) == 0, (int(ovf), int(cnt.min()))
    base = base.replace(tile_cap=cap)
    td, cnt, es, ovf = stamp.bin_disks_to_tiles(x, v, om, r, act, base)
    assert int(ovf) == 0 and int(cnt.max()) == cap
    dev = [t.cuda() for t in (td, cnt, es, x, r, act)]
    tdd, cd, esd, xd, rd, actd = dev
    rng = np.random.default_rng(13)
    f = lbm.init_equilibrium(base, "cuda") * (1.0 + 0.02 * torch.as_tensor(
        rng.standard_normal((9, base.ny, base.nx)), dtype=torch.float32,
        device="cuda"))
    fa, fb = torch.empty_like(f), torch.empty_like(f)
    n_tiles = td.shape[0]
    worst = 0.0
    for method, ns in SWEEP_METHODS:
        for shift in (0.0, -0.4):
            cfg = base.replace(eps_method=method, eps_samples=ns,
                               eps_r_shift=shift)
            tag = f"{method} ns={ns} r_shift={shift:g}"
            k = stamp.stamp_fields(tdd, cd, cfg)
            same = torch.equal(k.cpu(), plain_stamp_cpu(td, cnt, cfg))
            card_err = float((k - stamp.stamp_fields_plain(
                tdd, cd, cfg)).abs().max())
            assert same, f"K1 sweep {tag}: kernel != plain version"
            assert card_err <= 1e-6, f"K1 sweep {tag}: {card_err}"
            solid = k
            _, p2 = fused_lbm.fused_step_imb_reduce(f, solid, tdd, cd, cfg, fa)
            _, phx, phy = fused_lbm.fused_step_imb(f, solid[0], solid[1],
                                                   solid[2], cfg, fb)
            F9, T9 = stamp.reduce_hydro_forces(xd, rd, actd, solid[0], phx,
                                               phy, cfg, tdd, cd, esd)
            F2, T2 = stamp.gather_partials(p2, esd, torch.float32)
            Fp, Tp = stamp.gather_partials(stamp.hydro_partials_plain(
                solid[0], phx, phy, tdd, cd, cfg), esd, torch.float32)
            fs = max(1.0, float(Fp.abs().max()))
            ts = max(1.0, float(Tp.abs().max()))
            e2 = max(float((F2 - Fp).abs().max()) / fs,
                     float((T2 - Tp).abs().max()) / ts)
            bit = (torch.equal(fa, fb), torch.equal(F2, F9),
                   torch.equal(T2, T9))
            rows = p2.view(n_tiles, cap, 4)
            past = torch.arange(cap, device="cuda")[None, :] >= cd.view(-1, 1)
            zeros = bool((rows[past] == 0).all())
            worst = max(worst, e2)
            log("coverage-sweep", f"{tag}: K1 == plain (CPU) bitwise {same}"
                f" (card plain max err {card_err:.3e}); eps sum "
                f"{float(k[0].sum()):.6e}; K2/K9 reduce vs plain "
                f"{e2:.3e} of max(1, max) (bar 1e-6); K8 + K9 == K2 (f', F, "
                f"T) {bit}; rows past the count zero {zeros}")
            assert e2 <= 1e-6, f"reduce {tag}: err {e2}"
            assert all(bit), f"K8 + K9 != K2 {tag}: {bit}"
            assert zeros, f"reduce {tag}: rows past the count not zero"
            assert float(Fp.abs().max()) > 0
    log("coverage-sweep", f"{len(SWEEP_METHODS) * 2} cases on {base.nx}x"
        f"{base.ny}, {x.shape[0]} disks, {n_tiles} tiles (counts "
        f"{cnt.view(-1).tolist()}, cap {cap}): K1 bitwise in all; worst "
        f"reduce err {worst:.3e}")


# the K2 boundary matrix: four walls with a moving lid, fully periodic,
# periodic x with walls on y, Zou/He with walls on y
BOUNDARY_MATRIX = [
    ("walls-lid", dict(bc_west="wall", bc_east="wall", uw_north=0.05,
                       uw_west=0.01)),
    ("periodic-xy", dict(bc_south="periodic", bc_north="periodic", gx=1e-5)),
    ("periodic-x-walls-y", dict(uw_south=-0.02)),
    ("zou-he-walls", dict(bc_west="inlet", bc_east="outlet", u_inlet=0.05,
                          inlet_profile="poiseuille")),
]


def boundary_matrix(nx: int = 240, ny: int = 80) -> None:
    """K2 over BOUNDARY_MATRIX on f32 and shifted-bf16 storage at nx x ny
    (no multiple of the step kernel's 32-wide blocks in x; a stamp tile
    must hold a window, so ny stays a multiple of 16), for each block size
    128, 256 and 512, against its plain version on CPU copies (bars f'
    5e-6 / 3e-4, forces 1e-6 / 5e-6 of the largest |F|); on f32 K8 + K9
    against K2 bit for bit; and K8 alone on a 250 x 70 lattice (ragged in
    both axes; K8 needs no stamp tiling) against its plain version on CPU
    copies (f' atol 1e-7 + rtol 1e-6, phi atol 5e-8 + rtol 1e-5)."""
    from lbmdem_tpu_torch import SimConfig, lattice
    from lbmdem_tpu_torch.config import window_for_radius
    from lbmdem_tpu_torch.ops import fused_lbm, imb, lbm, stamp

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    x = torch.tensor([[1.2, 20.3], [64.3, 32.1], [128.0, 40.0],
                      [200.5, 60.2], [238.6, 2.7]])
    v = torch.tensor([[0.01, -0.02], [0.0, 0.01], [-0.02, 0.0], [0.01, 0.01],
                      [0.0, -0.01]])
    om = torch.tensor([0.005, -0.003, 0.0, 0.002, 0.001])
    r = torch.tensor([4.0, 4.0, 3.0, 5.0, 3.5])
    act = torch.ones(5, dtype=torch.bool)
    rng = np.random.default_rng(41)
    f32 = torch.as_tensor(lattice.W[:, None, None] * (
        1.0 + 0.05 * rng.standard_normal((9, ny, nx))), dtype=torch.float32)
    k2 = fused_lbm.fused_step_imb_reduce
    default = fused_lbm.STEP_THREADS
    try:
        for label, kw in BOUNDARY_MATRIX:
            for storage in ("float32", "bfloat16"):
                cfg = SimConfig(nx=nx, ny=ny, tau=0.8, dtype="float32",
                                max_disks=5, window=window_for_radius(5.0),
                                tile_cap=8, f_storage=storage, **kw)
                td, cnt, es, ovf = stamp.bin_disks_to_tiles(x, v, om, r, act,
                                                            cfg)
                assert int(ovf) == 0
                solid = stamp.stamp_fields(td, cnt, cfg)
                if cfg.bc_west == "inlet":
                    solid[:, :, 0].zero_()
                    solid[:, :, -1].zero_()
                f = lbm.to_storage(f32, cfg)
                cpu_in = (f, solid, td, cnt)
                dev_in = [t.cuda() for t in cpu_in]
                b, pp = fused_lbm.fused_step_imb_reduce_plain(
                    *cpu_in, cfg, torch.empty_like(f))
                Fp, _ = stamp.gather_partials(pp, es, torch.float32)
                fmax = float(Fp.abs().max())
                assert fmax > 0.0
                fbar, rbar = ((5e-6, 1e-6) if storage == "float32"
                              else (3e-4, 5e-6))
                errs = []
                for threads in (128, 256, 512):
                    fused_lbm.STEP_THREADS = threads
                    a = torch.empty_like(dev_in[0])
                    n0 = k2.launches
                    _, pk = k2(*dev_in, cfg, a)
                    assert k2.launches == n0 + 1, "K2 did not launch"
                    F, _ = stamp.gather_partials(pk.cpu(), es, torch.float32)
                    errs.append((float((a.float().cpu() - b.float()).abs()
                                       .max()),
                                 float((F - Fp).abs().max()) / fmax))
                    assert bool(torch.isfinite(a.float()).all())
                fused_lbm.STEP_THREADS = default
                msg = (f"{label} {storage} {nx}x{ny}: (f' max err, forces of "
                       f"max |F|) at 128/256/512 threads "
                       + ", ".join(f"({e:.3e}, {q:.3e})" for e, q in errs)
                       + f" (bars {fbar:g}, {rbar:g}; plain version on CPU "
                       f"tensors)")
                assert max(e for e, _ in errs) <= fbar, msg
                assert max(q for _, q in errs) <= rbar, msg
                if storage == "float32":
                    fd, sd, tdd, cd = dev_in
                    fa, fb = torch.empty_like(fd), torch.empty_like(fd)
                    _, p2 = k2(fd, sd, tdd, cd, cfg, fa)
                    _, phx, phy = fused_lbm.fused_step_imb(
                        fd, sd[0], sd[1], sd[2], cfg, fb)
                    esd = es.cuda()
                    F9, T9 = stamp.reduce_hydro_forces(
                        x.cuda(), r.cuda(), act.cuda(), sd[0], phx, phy, cfg,
                        tdd, cd, esd)
                    F2, T2 = stamp.gather_partials(p2, esd, torch.float32)
                    same = (torch.equal(fa, fb), torch.equal(F2, F9),
                            torch.equal(T2, T9))
                    msg += f"; K8 + K9 == K2 bitwise (f', F, T) {same}"
                    assert all(same), msg
                log("boundary", msg)
            # K8 alone on a lattice no stamp tiling takes
            cfg = SimConfig(nx=250, ny=70, tau=0.8, dtype="float32",
                            max_disks=5, window=window_for_radius(5.0), **kw)
            fields = imb.stamp_solid_fraction(x, v, om, r, act, cfg)
            if cfg.bc_west == "inlet":
                fields = imb.mask_open_columns(*fields)
            g = torch.as_tensor(lattice.W[:, None, None] * (
                1.0 + 0.05 * rng.standard_normal((9, 70, 250))),
                dtype=torch.float32)
            bp, px, py = fused_lbm.fused_step_imb_plain(g, *fields, cfg,
                                                        torch.empty_like(g))
            ex8 = []
            for threads in (128, 256, 512):
                fused_lbm.STEP_THREADS = threads
                a = torch.empty_like(g, device="cuda")
                _, kx, ky = fused_lbm.fused_step_imb(
                    g.cuda(), *(t.cuda() for t in fields), cfg, a)
                ex8.append((float(((a.cpu() - bp).abs() - 1e-6 * bp.abs())
                                  .max()),
                            max(float(((k.cpu() - p).abs() - 1e-5 * p.abs())
                                      .max()) for k, p in ((kx, px),
                                                           (ky, py)))))
            fused_lbm.STEP_THREADS = default
            log("boundary", f"{label} K8 250x70: (f' excess over rtol 1e-6,"
                f" phi excess over rtol 1e-5) at 128/256/512 threads "
                + ", ".join(f"({e:.3e}, {q:.3e})" for e, q in ex8)
                + " (bars 1e-7, 5e-8)")
            assert max(e for e, _ in ex8) <= 1e-7, ex8
            assert max(q for _, q in ex8) <= 5e-8, ex8
    finally:
        fused_lbm.STEP_THREADS = default


def kernel_device_ms(fn, calls: int = 10) -> dict:
    """torch.profiler over `calls` calls of fn(): device ms per call of
    each CUDA kernel, by a short name (the template's name before "<")."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for a in prof.key_averages():
        if a.device_type == DeviceType.CUDA:
            name = a.key.replace("void ", "").replace(
                "(anonymous namespace)::", "").split("<")[0].split("(")[0]
            out[name] = out.get(name, 0.0) + a.self_device_time_total / 1e3
    return {k: v / calls for k, v in out.items()}


def dev_str(dev: dict) -> str:
    """kernel_device_ms's result as "kernel ms, ..."; "not measured" when
    torch.profiler kept no device records."""
    return (", ".join(f"{k} {v:.4f}" for k, v in sorted(dev.items()))
            or "not measured (torch.profiler kept no device records)")


def block_times(fn) -> str:
    """CUDA-event times of fn() at the step kernel's block sizes 128, 256
    and 512 threads, in one string."""
    from lbmdem_tpu_torch.ops import fused_lbm

    default = fused_lbm.STEP_THREADS
    times = {}
    try:
        for threads in (128, 256, 512):
            fused_lbm.STEP_THREADS = threads
            times[threads] = cuda_ms(fn, 20)
    finally:
        fused_lbm.STEP_THREADS = default
    return (", ".join(f"{t} threads {ms:.4f} ms" for t, ms in times.items())
            + f" (CUDA events; default {default})")


def redesign_timed(cfg, disks, label: str):
    """The redesigned kernels at the slice's shapes with CUDA events, on
    the same card inputs as kernel_checks (random f): K1 under sample,
    ramp and exact (against the plain version on the card, 1e-6, with its
    time), K2 f32 BGK, bf16 and TRT + LES at the step kernel's
    block sizes 128, 256 and 512, and the reduce alone (K9, launch (b)'s
    kernel with phi for w). Returns {"K1 ramp": work, "K1 exact": work}
    for the kernel JSON line."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import fused_lbm, lbm, stamp

    sim = Simulation(cfg, disks, device="cuda")
    base = sim.cfg
    rng = np.random.default_rng(0)
    d = sim.state.disks
    n = d.x.shape[0]
    d = d._replace(
        v=torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)),
                          dtype=torch.float32, device="cuda"),
        omega=torch.as_tensor(rng.uniform(-2e-3, 2e-3, n),
                              dtype=torch.float32, device="cuda"))
    td, cnt, es, ovf = stamp.bin_disks_to_tiles(d.x, d.v, d.omega, d.r,
                                                d.active, base)
    assert int(ovf) == 0
    cells = base.nx * base.ny
    out = {}
    for method in ("sample", "ramp", "exact"):
        c = base.replace(eps_method=method)
        solid = stamp.stamp_fields(td, cnt, c)
        k1_dev = kernel_device_ms(lambda: stamp.stamp_fields(td, cnt, c))
        e1 = float((solid - stamp.stamp_fields_plain(td, cnt, c)).abs().max())
        assert e1 <= 1e-6, f"K1 {method} {label}: max err {e1}"
        w = work(e1, cuda_ms(lambda: stamp.stamp_fields(td, cnt, c), 20),
                 cuda_ms(lambda: stamp.stamp_fields_plain(td, cnt, c), 2),
                 nbytes(td, cnt, solid), cov_flops_of(c, cnt))
        if method != "sample":
            out[f"K1 {method}"] = w
        bms, by = bound(w)
        log("redesign", f"{label} K1 {method}: max err {e1:.3e} against "
            f"the plain version (bar 1e-6); kernel {w['ms']:.4f} ms (device "
            f"{dev_str(k1_dev)}, torch.profiler), "
            f"plain {w['plain_ms']:.4f} ms (CUDA events); bound {bms:.4f} ms "
            f"by {by}")
    solid = stamp.stamp_fields(td, cnt, base)
    f32 = lbm.init_equilibrium(base, "cuda") * (1.0 + 0.02 * torch.as_tensor(
        rng.standard_normal((9, base.ny, base.nx)), dtype=torch.float32,
        device="cuda"))
    for name, kw in (("f32 bgk", {}), ("bf16", dict(f_storage="bfloat16")),
                     ("f32 trt+les", dict(collision="trt", smagorinsky=0.16))):
        c = base.replace(**kw)
        f = lbm.to_storage(f32, c)
        a = torch.empty_like(f)
        _, parts = fused_lbm.fused_step_imb_reduce(f, solid, td, cnt, c, a)
        bms, by = bound(work(None, None, None,
                             nbytes(f, solid, td, cnt, a, parts),
                             nt_flops(solid) + cov_flops_of(c, cnt)))
        run = lambda: fused_lbm.fused_step_imb_reduce(  # noqa: E731
            f, solid, td, cnt, c, a)
        dev = kernel_device_ms(run)
        log("redesign", f"{label} K2 {name}: " + block_times(run)
            + f"; bound {bms:.4f} ms by {by}; device ms per call by kernel "
            "(torch.profiler): "
            + dev_str(dev))
    fo = torch.empty_like(f32)
    _, phx, phy = fused_lbm.fused_step_imb(f32, solid[0], solid[1], solid[2],
                                           base, fo)
    dev8 = kernel_device_ms(lambda: fused_lbm.fused_step_imb(
        f32, solid[0], solid[1], solid[2], base, fo))
    dev9 = kernel_device_ms(lambda: stamp.reduce_hydro_forces(
        d.x, d.r, d.active, solid[0], phx, phy, base, td, cnt, es))
    log("redesign", f"{label} device ms per call by kernel (torch.profiler): "
        f"K8 (launch (a) with a phi sink) "
        + dev_str(dev8)
        + "; K9 (launch (b)'s kernels with phi for w, and its gather) "
        + dev_str(dev9)
        + f"; {int(cnt.sum())} occupied slots in {cnt.numel()} tiles, "
        f"{int((solid[0] > 0).sum())} covered cells of {cells}")
    return out


def chained(step, k: int, f, a, b):
    """k chained one-step calls step(src, dst) from f, alternating the
    buffers a and b: (the buffer holding the last step, [each call's
    result])."""
    src, res = f, []
    for s in range(k):
        dst = (a, b)[s % 2]
        res.append(step(src, dst))
        src = dst
    return src, res


def k2_step(solid, td, cnt, cfg):
    """K2 as a step(src, dst) of `chained`, returning its partials."""
    from lbmdem_tpu_torch.ops import fused_lbm

    return lambda src, dst: fused_lbm.fused_step_imb_reduce(
        src, solid, td, cnt, cfg, dst)[1]


def k8_step(solid, cfg):
    """K8 as a step(src, dst) of `chained`."""
    from lbmdem_tpu_torch.ops import fused_lbm

    return lambda src, dst: fused_lbm.fused_step_imb(
        src, solid[0], solid[1], solid[2], cfg, dst)


def k6_identity(f, solid, td, cnt, cfg, k: int, tag: str) -> None:
    """K6(k) against k chained K2 steps on the same f32 input: f' and
    every inner step's partials equal (torch.equal)."""
    from lbmdem_tpu_torch.ops import fused_lbm

    a, b, c = (torch.empty_like(f) for _ in range(3))
    k6 = fused_lbm.fused_step_imb_reduce_multi
    n0 = k6.launches
    _, pk = k6(f, solid, td, cnt, cfg, k, c)
    assert k6.launches == n0 + 1, "K6 did not launch"
    last, p2 = chained(k2_step(solid, td, cnt, cfg), k, f, a, b)
    same = (torch.equal(c, last),
            all(torch.equal(pk[t], p2[t]) for t in range(k)))
    assert all(same), f"K6 k={k} {tag}: (f', partials) equal {same}"
    assert float((c - f).abs().max()) > 0.0, f"K6 k={k} {tag}: no change"


def k7_identity(f, solid, cfg, k: int, tag: str) -> None:
    """K7(k) against k chained K8 steps on the same f32 input: f' equal
    (torch.equal)."""
    from lbmdem_tpu_torch.ops import fused_static

    a, b, c = (torch.empty_like(f) for _ in range(3))
    k7 = fused_static.fused_step_imb_static_multi
    n0 = k7.launches
    k7(f, solid, cfg, k, c)
    assert k7.launches == n0 + 1, "K7 did not launch"
    last, _ = chained(k8_step(solid, cfg), k, f, a, b)
    assert torch.equal(c, last), f"K7 k={k} {tag}: f' differs from K8's"
    assert float((c - f).abs().max()) > 0.0, f"K7 k={k} {tag}: no change"


# the strips (threads per level, rows per block) of the identity sweep on
# 240x80
IDENTITY_STRIPS = [(128, 128), (128, 64), (64, 128), (256, 128), (128, 1),
                   (128, 5), (64, 7), (256, 33)]


def tblock_identities() -> None:
    """The row-sweep temporal block against the one-step kernels bit for
    bit, f32: K6(k) == k chained K2 steps (f' and every inner step's
    partials) over BREADTH_MATRIX, and K7(k) == k chained K8 steps over
    STATIC_MATRIX, for k = 1, 2, 4, 8, at 256x64, at 240x80 (no multiple
    of a strip) and at 96x32 (smaller than one strip), five moving disks
    scaled to the lattice; on 240x80 again at every strip of
    IDENTITY_STRIPS for the BGK, Zou/He, periodic and all-options cases."""
    from lbmdem_tpu_torch import SimConfig, lattice
    from lbmdem_tpu_torch.config import window_for_radius
    from lbmdem_tpu_torch.ops import fused_lbm, fused_static, stamp

    x0 = np.array([[1.2, 20.3], [64.3, 32.1], [128.0, 40.0], [200.5, 60.2],
                   [238.6, 2.7]])
    v = torch.tensor([[0.01, -0.02], [0.0, 0.01], [-0.02, 0.0], [0.01, 0.01],
                      [0.0, -0.01]])
    om = torch.tensor([0.005, -0.003, 0.0, 0.002, 0.001])
    r = torch.tensor([4.0, 4.0, 3.0, 5.0, 3.5])
    act = torch.ones(5, dtype=torch.bool)
    rng = np.random.default_rng(43)
    strips = (fused_lbm.MULTI_STRIP, fused_static.STRIP)
    n = 0

    def inputs(nx, ny, kw):
        cfg = SimConfig(**{"nx": nx, "ny": ny, "tau": 0.8, "dtype": "float32",
                           "max_disks": 5, "window": window_for_radius(5.0),
                           "tile_cap": 8, **kw})
        x = torch.as_tensor(x0 * [nx / 256, ny / 64], dtype=torch.float32)
        td, cnt, _, ovf = stamp.bin_disks_to_tiles(x, v, om, r, act, cfg)
        assert int(ovf) == 0
        td, cnt = td.cuda(), cnt.cuda()
        solid = stamp.stamp_fields(td, cnt, cfg)
        if cfg.bc_west == "inlet":
            solid[:, :, 0].zero_()
            solid[:, :, -1].zero_()
        f = torch.as_tensor(lattice.W[:, None, None] * (
            1.0 + 0.05 * rng.standard_normal((9, ny, nx))),
            dtype=torch.float32, device="cuda")
        assert float(solid[0].max()) > 0.0
        return cfg, f, solid, td, cnt

    try:
        for nx, ny in ((256, 64), (240, 80), (96, 32)):
            for label, kw in BREADTH_MATRIX:
                cfg, f, solid, td, cnt = inputs(nx, ny, kw)
                for k in (1, 2, 4, 8):
                    k6_identity(f, solid, td, cnt, cfg, k,
                                f"{label} {nx}x{ny}")
                    n += 1
            for label, kw in STATIC_MATRIX:
                cfg, f, solid, _, _ = inputs(nx, ny, kw)
                for k in (1, 2, 4, 8):
                    k7_identity(f, solid, cfg, k, f"{label} {nx}x{ny}")
                    n += 1
            log("tblock", f"{nx}x{ny}: K6(k) == k x K2 (f', partials) over "
                f"{len(BREADTH_MATRIX)} option sets and K7(k) == k x K8 over "
                f"{len(STATIC_MATRIX)}, k = 1, 2, 4, 8, bit for bit")
        cases = dict(BREADTH_MATRIX)
        for strip in IDENTITY_STRIPS:
            fused_lbm.MULTI_STRIP = fused_static.STRIP = strip
            for label in ("bgk", "zou-he", "periodic", "all"):
                cfg, f, solid, td, cnt = inputs(240, 80, cases[label])
                for k in (1, 4, 8):
                    tag = f"{label} 240x80 strip {strip}"
                    k6_identity(f, solid, td, cnt, cfg, k, tag)
                    k7_identity(f, solid, cfg, k, tag)
                    n += 2
        log("tblock", f"240x80 at strips (threads, rows) {IDENTITY_STRIPS}: "
            f"K6 == K2 chain and K7 == K8 chain bit for bit; {n} identities "
            f"in all")
    finally:
        fused_lbm.MULTI_STRIP, fused_static.STRIP = strips


def strip_times(run, k: int, attr) -> str:
    """CUDA-event times of run() (a K6 or K7 pass of k steps) at each
    strip (threads, rows) of the sweep, setting the module constant
    `attr` = (module, name); restores it."""
    mod, name = attr
    default = getattr(mod, name)
    times = []
    try:
        for threads in (64, 128):
            for rows in (32, 64, 128, 256):
                setattr(mod, name, (threads, rows))
                times.append(f"({threads}, {rows}) {cuda_ms(run, 10):.4f}")
    finally:
        setattr(mod, name, default)
    return f"k={k} ms per pass at (threads, rows): " + ", ".join(times)


def tblock_timed(cfg, disks, label: str):
    """The row-sweep K6 and K7 at the slice's shapes, on random input,
    CUDA events and torch.profiler: K6 k = 4 (f32, bf16, TRT + LES) on
    phase 3's inputs beside 4 chained K2 steps, the f32 identity K6 == 4 x
    K2 at 4096^2 (f', partials); K7 k = 4 (f32, bf16) on the static
    scene's solid stack beside 4 chained K8 steps and K7 == 4 x K8 at
    4096^2; the strip sweep of both."""
    from lbmdem_tpu_torch import Simulation, lattice
    from lbmdem_tpu_torch.ops import fused_lbm, fused_static, lbm, stamp

    sim = Simulation(cfg, disks, device="cuda")
    base = sim.cfg
    rng = np.random.default_rng(0)
    d = sim.state.disks
    n = d.x.shape[0]
    d = d._replace(
        v=torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)),
                          dtype=torch.float32, device="cuda"),
        omega=torch.as_tensor(rng.uniform(-2e-3, 2e-3, n),
                              dtype=torch.float32, device="cuda"))
    td, cnt, _, ovf = stamp.bin_disks_to_tiles(d.x, d.v, d.omega, d.r,
                                               d.active, base)
    assert int(ovf) == 0
    solid = stamp.stamp_fields(td, cnt, base)
    f32 = lbm.init_equilibrium(base, "cuda") * (1.0 + 0.02 * torch.as_tensor(
        rng.standard_normal((9, base.ny, base.nx)), dtype=torch.float32,
        device="cuda"))
    k6_identity(f32, solid, td, cnt, base, 4, label)
    log("tblock", f"{label}: K6(4) == 4 x K2 bit for bit (f', partials)")
    cov = cov_flops_of(base, cnt)
    for name, kw in (("f32", {}), ("bf16", dict(f_storage="bfloat16")),
                     ("trt+les", dict(collision="trt", smagorinsky=0.16))):
        c = base.replace(**kw)
        f = lbm.to_storage(f32, c)
        a, b, o = (torch.empty_like(f) for _ in range(3))
        run6 = lambda: fused_lbm.fused_step_imb_reduce_multi(  # noqa: E731
            f, solid, td, cnt, c, 4, o)
        run2 = lambda: chained(k2_step(solid, td, cnt, c), 4, f, a, b)  # noqa
        _, parts = run6()
        t6, t2 = cuda_ms(run6, 10), cuda_ms(run2, 10)
        t6b, t2b = cuda_ms(run6, 10), cuda_ms(run2, 10)
        dev6, dev2 = kernel_device_ms(run6), kernel_device_ms(run2)
        bms, by = bound(work(None, None, None,
                             nbytes(f, solid, td, cnt, o, parts),
                             4 * (nt_flops(solid) + cov)))
        log("tblock", f"{label} K6 {name} k=4: {t6:.4f}, {t6b:.4f} ms per "
            f"pass; 4 chained K2 {t2:.4f}, {t2b:.4f} ms (CUDA events, "
            f"alternating); bound {bms:.4f} ms by {by}; device ms by kernel "
            f"(torch.profiler) K6 "
            + dev_str(dev6)
            + "; 4 x K2 "
            + dev_str(dev2))
        if name == "f32":
            log("tblock", f"{label} K6 f32 strip sweep: " + strip_times(
                run6, 4, (fused_lbm, "MULTI_STRIP")))
            run68 = lambda: fused_lbm.fused_step_imb_reduce_multi(  # noqa
                f, solid, td, cnt, c, 8, o)
            t8 = cuda_ms(lambda: chained(k2_step(solid, td, cnt, c), 8, f, a,
                                         b), 5)
            log("tblock", f"{label} K6 f32 k=8: {cuda_ms(run68, 5):.4f} ms "
                f"per pass; 8 chained K2 {t8:.4f} ms (CUDA events)")
    del sim
    ssim = Simulation(*static_bed(), device="cuda")
    scfg = ssim.cfg
    ssolid = ssim._static_solid_operands()
    g = torch.Generator(device="cuda").manual_seed(9)
    w = torch.as_tensor(lattice.W, dtype=torch.float32, device="cuda")
    s32 = w[:, None, None] * (1.0 + 0.02 * torch.randn(
        (9, scfg.ny, scfg.nx), generator=g, device="cuda"))
    k7_identity(s32, ssolid, scfg, 4, "4096x4096 static")
    log("tblock", "4096x4096 static: K7(4) == 4 x K8 bit for bit")
    for name, kw in (("f32", {}), ("bf16", dict(f_storage="bfloat16"))):
        c = scfg.replace(**kw)
        f = lbm.to_storage(s32, c)
        o = torch.empty_like(f)
        run7 = lambda: fused_static.fused_step_imb_static_multi(  # noqa
            f, ssolid, c, 4, o)
        bms, by = bound(work(None, None, None, 2 * nbytes(f)
                             + nbytes(ssolid), 4 * nt_flops(ssolid)))
        line = (f"4096x4096 static K7 {name} k=4: {cuda_ms(run7, 10):.4f} ms "
                f"per pass (CUDA events); bound {bms:.4f} ms by {by}")
        if name == "f32":
            a, b = torch.empty_like(f), torch.empty_like(f)
            run8 = lambda: chained(k8_step(ssolid, c), 4, f, a, b)  # noqa
            t8, t7b, t8b = (cuda_ms(fn, 10) for fn in (run8, run7, run8))
            line += (f"; again {t7b:.4f}; 4 chained K8 {t8:.4f}, {t8b:.4f} "
                     f"ms (alternating); device ms (torch.profiler) K7 "
                     + dev_str(kernel_device_ms(run7))
                     + "; 4 x K8 " + dev_str(kernel_device_ms(run8)))
        log("tblock", line)
        if name == "f32":
            log("tblock", "4096x4096 static K7 f32 strip sweep: "
                + strip_times(run7, 4, (fused_static, "STRIP")))


def tblock_on_run_state(sim) -> None:
    """A coupling_k = 4 run (bf16 or f32) continued under torch.profiler
    for 40 steps (device ms per step, idle share), then K6 (k = 4) against
    4 chained K2 steps on its own state, CUDA events, as
    split_on_run_state does for K2."""
    from lbmdem_tpu_torch.ops import fused_lbm, stamp

    dev_ms, wall_ms, top = device_profile(sim)
    log("tblock", f"window slice ({sim.cfg.f_storage}) profiler run(40): "
        f"{wall_ms:.4f} ms wall per step (profiled); "
        + idle_str(dev_ms, wall_ms, "the profiled run")
        + f"; top kernels {[(k[:40], round(t / 1e3, 3)) for k, t in top]} ms")
    cfg = sim.cfg
    d = sim.state.disks
    td, cnt, _, _ = stamp.bin_disks_to_tiles(d.x, d.v, d.omega, d.r,
                                             d.active, cfg)
    solid = stamp.stamp_fields(td, cnt, cfg)
    f = sim.state.f
    a, b, o = (torch.empty_like(f) for _ in range(3))
    run6 = lambda: fused_lbm.fused_step_imb_reduce_multi(  # noqa: E731
        f, solid, td, cnt, cfg, 4, o)
    run2 = lambda: chained(k2_step(solid, td, cnt, cfg), 4, f, a, b)  # noqa
    times = [cuda_ms(fn, 10) for fn in (run6, run2, run2, run6)]
    log("tblock", f"on the {cfg.f_storage} window slice's state after "
        f"{int(sim.state.step)} steps: K6 k=4 {times[0]:.4f}, {times[3]:.4f}"
        f" ms per pass; 4 chained K2 {times[1]:.4f}, {times[2]:.4f} ms (CUDA "
        f"events); {int((solid[0] > 0).sum())} covered cells of "
        f"{cfg.nx * cfg.ny}")
def open_channel_vs_cpu(nx: int = 512, ny: int = 256, steps: int = 48):
    """A coupled Zou/He channel under TRT + LES (the coupled scene of the
    JAX package's open-boundary tests, at 512x256): a mobile disk next
    to the outlet that leaves and is culled, a fixed obstacle and a
    mobile disk mid-channel; the card against CPU tensors. Bars: f 1e-5,
    disk x 1e-4, the culled disk inactive on both."""
    from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cfg = SimConfig(nx=nx, ny=ny, tau=0.7, dtype="float32", bc_west="inlet",
                    bc_east="outlet", u_inlet=0.1, inlet_profile="uniform",
                    rho_s=1.0, n_sub=2, u0x=0.1, collision="trt",
                    smagorinsky=0.1, out_interval=10**9)
    disks = [DiskSpec(nx - 3.0, 0.5 * ny, 3.0, vx=0.2),
             DiskSpec(0.25 * nx, 0.4 * ny, 12.0, fixed=True),
             DiskSpec(0.6 * nx, 0.55 * ny, 6.0, vx=0.1)]
    g = Simulation(cfg, disks, device="cuda")
    c = Simulation(cfg, disks, device="cpu")
    reset_counts()
    g.run(steps)
    counts = launch_counts()
    c.run(steps)
    ef = float((g.state.f.cpu() - c.state.f).abs().max())
    ex = float((g.state.disks.x.cpu() - c.state.disks.x).abs().max())
    act_g = g.state.disks.active.cpu().tolist()
    act_c = c.state.disks.active.tolist()
    _, ux, _ = g.macroscopic()
    log("open-channel", f"{nx}x{ny} Zou/He channel, TRT + LES, {steps} steps:"
        f" launches K1 {counts['K1']}, K2 {counts['K2']}, K3 {counts['K3']}; "
        f"f max err {ef:.3e} (bar 1e-5), disk x max err {ex:.3e} (bar 1e-4); "
        f"active card {act_g} CPU {act_c}; inlet ux "
        f"{float(ux[:, 0].min()):.6f}..{float(ux[:, 0].max()):.6f}; overflow "
        f"{int(g.state.overflow)}")
    assert counts["K2"] == steps and counts["K3"] == steps, counts
    assert act_g == act_c == [False, True, True], (act_g, act_c)
    assert float(g.state.disks.x[0, 0]) == -1.0e6
    assert int(g.state.overflow) == 0
    assert ef <= 1e-5 and ex <= 1e-4
    assert abs(float(ux[:, 0].mean()) - 0.1) < 1e-6
    return counts


def dem_breadth_checks(cfg, disks, label: str, timed: bool, seed: int = 3):
    """K3 and K3w with history springs on the packed scene (two
    subcycles first, so the carry holds live springs to re-match), and
    K3 on the same scene made periodic in x and shifted across the seam,
    under both slab orientations, each against its plain version on the
    same card inputs. Bars: every slab channel 3e-5 with kt (springs
    included), 2e-5 on periodic axes, contacts equal. Returns {name:
    work} when timed."""
    from lbmdem_tpu_torch import DiskSpec, Simulation
    from lbmdem_tpu_torch.ops import dem, slab_dem

    out = {}
    sim = Simulation(cfg.replace(kt=25.0), disks, device="cuda")
    c, grid, axis = sim.cfg, sim.grid, sim.dem_axis
    assert slab_dem.slab_supported(grid, axis, kt=True, device="cuda"), \
        "the slab gate rejects this scene"
    rng = np.random.default_rng(seed)
    d = sim.state.disks
    n = d.x.shape[0]
    dev = d.x.device

    def rnd(shape, amp):
        return torch.as_tensor(rng.uniform(-amp, amp, shape),
                               dtype=torch.float32, device=dev)

    d = d._replace(v=rnd((n, 2), 0.02), omega=rnd((n,), 2e-3))
    F, T = rnd((n, 2), 1e-3), rnd((n,), 1e-4)
    for _ in range(2):
        d, ovf, nc0 = slab_dem.dem_subcycle(d, F, T, grid, c, axis)
    live = int((d.ct_j >= 0).sum())
    assert int(ovf) == 0 and int(nc0) > 0 and live > 0
    body = dem.body_forces(d, c)
    act = int(d.active.sum())

    # K3 with springs
    slabs, slot, sovf, kmax, n_occ, bands, j36 = slab_dem.build_slabs(
        d, F, T, body, grid, axis, kt=True)
    s_k, nc_k = slab_dem.subcycle_slabs(slabs.clone(), kmax, n_occ, bands,
                                        grid, c, axis)
    s_p, nc_p = slab_dem.subcycle_slabs_plain(slabs, kmax, c, grid, axis)
    e3 = float((s_k - s_p).abs().max())
    exi = float((s_k[11:] - s_p[11:]).abs().max())
    new, ovf2 = slab_dem._unslab(s_k, slot, d, c, j36, sovf)
    log("dem-breadth", f"{label} K3 kt={c.kt:g}: all 51 channels max err "
        f"{e3:.3e} (springs {exi:.3e}, max |xi| "
        f"{float(s_p[11:47].abs().max()):.3e}; bar 3e-5); contacts "
        f"{int(nc_k)} == {int(nc_p)}; carried springs {live} -> "
        f"{int((new.ct_j >= 0).sum())}; overflow {int(ovf2)}")
    assert e3 <= 3e-5, f"K3 kt {label}: {e3}"
    assert int(nc_k) == int(nc_p) > 0 and int(ovf2) == 0
    assert float(s_p[11:47].abs().max()) > 0 and int((new.ct_j >= 0).sum()) > 0
    dem_flops = c.n_sub * act * 9 * int(kmax) * 75
    if timed:
        scratch = slabs.clone()
        out["K3 kt"] = work(
            e3, cuda_ms(lambda: slab_dem.subcycle_slabs(
                scratch, kmax, n_occ, bands, grid, c, axis), 20),
            cuda_ms(lambda: slab_dem.subcycle_slabs_plain(
                slabs, kmax, c, grid, axis), 2), 2 * nbytes(slabs), dem_flops)

    # K3w with springs: 3 chained calls on the slim layout
    slabs_w, slot_w, sovf, kmax_w, nocc_w, bands_w, j36 = slab_dem.build_slabs(
        d, None, None, body, grid, axis, kt=True, bake_forces=False)
    forces = [(rnd((n, 2), 1e-3), rnd((n,), 1e-4)) for _ in range(3)]
    f3 = slab_dem._force_planes_window(slot_w, forces, body, slabs_w.shape)
    s_k, s_p = slabs_w.clone(), slabs_w
    for t in range(3):
        s_k, nc_k = slab_dem.subcycle_slabs_window(
            s_k, f3[t], kmax_w, nocc_w, bands_w, grid, c, axis)
        s_p, nc_p = slab_dem.subcycle_slabs_plain(s_p, kmax_w, c, grid, axis,
                                                  f3[t])
        assert int(nc_k) == int(nc_p) > 0, (t, int(nc_k), int(nc_p))
    e3w = float((s_k - s_p).abs().max())
    log("dem-breadth", f"{label} K3w kt={c.kt:g}, 3 chained calls: all 48 "
        f"channels max err {e3w:.3e} (bar 3e-5); contacts {int(nc_k)} == "
        f"{int(nc_p)} at the last")
    assert e3w <= 3e-5, f"K3w kt {label}: {e3w}"
    if timed:
        scratch = slabs_w.clone()
        out["K3w kt"] = work(
            e3w, cuda_ms(lambda: slab_dem.subcycle_slabs_window(
                scratch, f3[0], kmax_w, nocc_w, bands_w, grid, c, axis), 20),
            cuda_ms(lambda: slab_dem.subcycle_slabs_plain(
                slabs_w, kmax_w, c, grid, axis, f3[0]), 2),
            2 * nbytes(slabs_w) + nbytes(f3[0]), dem_flops)

    # K3 on a periodic x axis: the packed column shifted across the seam
    pcfg = cfg.replace(bc_west="periodic", bc_east="periodic")
    shift = 0.04 * cfg.nx
    pdisks = [DiskSpec((s.x - shift) % cfg.nx, s.y, s.r) for s in disks]
    psim = Simulation(pcfg, pdisks, device="cuda")
    pc, pgrid = psim.cfg, psim.grid
    pd = psim.state.disks._replace(v=rnd((n, 2), 0.02), omega=rnd((n,), 2e-3))
    seam = int(((pd.x[:, 0] > cfg.nx - 20.0) & pd.active).sum())
    assert seam > 0, "no disk beyond the seam"
    pbody = dem.body_forces(pd, pc)
    for ax in ("x", "y"):
        if not slab_dem.slab_supported(pgrid, ax, device="cuda"):
            log("dem-breadth", f"{label} periodic-x axis={ax}: past the slab "
                f"gate, not run")
            continue
        slabs, slot, sovf, kmax, n_occ, bands, _ = slab_dem.build_slabs(
            pd, F, T, pbody, pgrid, ax)
        assert int(sovf) == 0
        s_k, nc_k = slab_dem.subcycle_slabs(slabs.clone(), kmax, n_occ, bands,
                                            pgrid, pc, ax)
        s_p, nc_p = slab_dem.subcycle_slabs_plain(slabs, kmax, pc, pgrid, ax)
        ep = float((s_k - s_p).abs().max())
        log("dem-breadth", f"{label} K3 periodic x, slab axis {ax} ("
            f"{'rows' if ax == 'x' else 'lanes'} wrap), {seam} disks beyond "
            f"the seam: all channels max err {ep:.3e} (bar 2e-5); contacts "
            f"{int(nc_k)} == {int(nc_p)}")
        assert ep <= 2e-5, f"K3 periodic {label} axis {ax}: {ep}"
        assert int(nc_k) == int(nc_p) > 0
        if timed and ax == psim.dem_axis:
            scratch = slabs.clone()
            out["K3 periodic"] = work(
                ep, cuda_ms(lambda: slab_dem.subcycle_slabs(
                    scratch, kmax, n_occ, bands, pgrid, pc, ax), 20),
                cuda_ms(lambda: slab_dem.subcycle_slabs_plain(
                    slabs, kmax, pc, pgrid, ax), 2), 2 * nbytes(slabs),
                pc.n_sub * act * 9 * int(kmax) * 65)
    # the contacts through the seam: the slab step against the cell-list
    # DEM on the CPU
    a, _, nca = slab_dem.dem_subcycle(pd, F, T, pgrid, pc, psim.dem_axis)
    pdc = type(pd)(*(t.cpu() for t in pd))
    b, _, ncb = dem.dem_subcycle(pdc, F.cpu(), T.cpu(), pgrid, pc)
    on = pdc.active  # unused slots keep the seeded v in the slab step
    err = torch.stack([(getattr(a, k).cpu() - getattr(b, k)).abs().reshape(
        n, -1).max(1).values for k in ("x", "v", "omega")]).max(0).values
    ecl = float(err[on].max())
    over = int((err[on] > 1e-4).sum())
    flips = abs(int(nca) - int(ncb))
    log("dem-breadth", f"{label} periodic x: slab step on the card vs the "
        f"cell-list DEM on the CPU x/v/omega max err {ecl:.3e} (bar 1e-4; "
        f"{over} disks over it); contacts {int(nca)} vs {int(ncb)}")
    # the two DEMs sum in other orders: among tens of thousands of
    # contacts a grazing pair may touch in one and not in the other, and
    # only the disks around it may then miss the bar
    assert flips <= 1e-4 * int(ncb) and over <= 8 * flips, (ecl, over, flips)
    for k, w in out.items():
        bms, by = bound(w)
        log("dem-breadth", f"{label} {k}: kernel {w['ms']:.4f} ms, plain "
            f"{w['plain_ms']:.4f} ms (CUDA events); bound {bms:.4f} ms by {by}"
            f" ({w['bytes'] / 1e9:.4f} GB, {w['flops'] / 1e9:.3f} GFLOP)")
    return out


def kt_slice(smi: str):
    """The coupled slice at full width with history springs: the packed
    4096^2 / 10k-disk column with kt = 25, per step (K2 + K3) and through
    coupling_k = 4 windows (K6 + K3w). The CPU's plane budget would send
    this DEM grid to the cell-list DEM; on the card the slab DEM takes
    it. run(8) to warm, run(16) timed; contacts and live springs form,
    overflow 0, finite f, mass 1e-5. Returns {coupling_k: launch
    counts}."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import column_collapse
    from lbmdem_tpu_torch.ops import slab_dem

    cfg, disks = column_collapse(kt=25.0)
    packed = compressed(disks, 0.94)
    out = {}
    for ck in (1, 4):
        sim = Simulation(cfg.replace(coupling_k=ck, out_interval=10**9),
                         packed, device="cuda")
        assert not slab_dem.slab_supported(sim.grid, sim.dem_axis, kt=True)
        assert slab_dem.slab_supported(sim.grid, sim.dem_axis, kt=True,
                                       device="cuda")
        reset_counts()
        sim.run(8)
        mlups = sim.run(16)
        counts = out[ck] = launch_counts()
        st = sim.state
        springs = int((st.disks.ct_j >= 0).sum())
        mass_err = abs(float(st.f.double().sum()) / (cfg.nx * cfg.ny) - 1.0)
        log("kt-slice", f"column_collapse {cfg.nx}x{cfg.ny}, {len(disks)} "
            f"disks packed, kt {cfg.kt:g}, coupling_k={ck}, 24 steps: "
            f"{mlups:.1f} MLUPS (timed run(16), wall clock) on {smi}; "
            f"launches K2 {counts['K2']}, K3 {counts['K3']}, K6 "
            f"{counts['K6']}, K3w {counts['K3w']}; contacts "
            f"{int(st.n_contacts)}; live springs {springs}; overflow "
            f"{int(st.overflow)}; |sum f/(nx ny) - 1| {mass_err:.3e}")
        want = (24, 24, 0, 0) if ck == 1 else (0, 0, 6, 24)
        assert tuple(counts[k] for k in ("K2", "K3", "K6", "K3w")) == want, \
            counts
        assert int(st.overflow) == 0 and int(st.n_contacts) > 0
        assert springs > 0 and bool(torch.isfinite(st.f).all())
        assert mass_err < 1e-5, mass_err
    return out


def _deck(name: str):
    """(cfg, disks) of examples/<name>.par, read beside this script."""
    from lbmdem_tpu_torch import load_param_file, load_particle_file

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "examples")
    cfg, pf = load_param_file(os.path.join(root, name + ".par"))
    return cfg.replace(out_interval=10**9), load_particle_file(pf)


def decks_vs_cpu(smi: str):
    """examples/column_collapse_friction.par at its deck's size (2048^2,
    2 500 disks, kt = 25; the column packed into contact so springs
    form) and examples/periodic_channel.par (128x256, a disk straddling
    the seam), the card against CPU tensors at the slice's bars (f 1e-5,
    disk x 1e-4), overflow 0; then the friction deck through coupling_k
    = 4 windows on the card (K6 + K3w with springs). Returns the launch
    counts of the friction run, of its window run and of the periodic
    channel's."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import slab_dem

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cfg, disks = _deck("column_collapse_friction")
    assert (cfg.nx, cfg.ny, len(disks), cfg.kt) == (2048, 2048, 2500, 25.0)
    packed = compressed(disks, 0.94)
    g = Simulation(cfg, packed, device="cuda")
    c = Simulation(cfg, packed, device="cpu")
    # inside the CPU's gate too: both runs take the slab DEM
    assert slab_dem.slab_supported(g.grid, g.dem_axis, kt=True)
    reset_counts()
    g.run(4)
    t0 = time.perf_counter()
    mlups = g.run(8)
    secs = time.perf_counter() - t0
    counts = launch_counts()
    c.run(12)
    ef = float((g.state.f.cpu() - c.state.f).abs().max())
    ex = float((g.state.disks.x.cpu() - c.state.disks.x).abs().max())
    springs = int((g.state.disks.ct_j >= 0).sum())
    log("decks", f"column_collapse_friction {cfg.nx}x{cfg.ny}, {len(disks)} "
        f"disks packed, kt {cfg.kt:g}, 12 steps: f max err {ef:.3e} (bar "
        f"1e-5), disk x max err {ex:.3e} (bar 1e-4); contacts "
        f"{int(g.state.n_contacts)} == {int(c.state.n_contacts)}; live "
        f"springs {springs}; overflow {int(g.state.overflow)}; launches "
        f"K2 {counts['K2']}, K3 {counts['K3']}; {mlups:.1f} MLUPS over "
        f"run(8) ({secs:.3f} s, wall) on {smi}")
    assert counts["K2"] == counts["K3"] == 12, counts
    assert int(g.state.overflow) == int(c.state.overflow) == 0
    assert ef <= 1e-5 and ex <= 1e-4
    assert int(g.state.n_contacts) == int(c.state.n_contacts) > 0
    assert springs > 0
    w = Simulation(cfg.replace(coupling_k=4), packed, device="cuda")
    reset_counts()
    w.run(16)
    wcounts = launch_counts()
    wf = w.state.f
    log("decks", f"column_collapse_friction coupling_k=4, 16 steps on the "
        f"card: launches K6 {wcounts['K6']}, K3w {wcounts['K3w']}; contacts "
        f"{int(w.state.n_contacts)}; live springs "
        f"{int((w.state.disks.ct_j >= 0).sum())}; overflow "
        f"{int(w.state.overflow)}; |sum f/(nx ny) - 1| "
        f"{abs(float(wf.double().sum()) / (cfg.nx * cfg.ny) - 1.0):.3e}")
    assert (wcounts["K6"], wcounts["K3w"]) == (4, 16), wcounts
    assert int(w.state.overflow) == 0 and int(w.state.n_contacts) > 0
    assert bool(torch.isfinite(wf).all())
    assert int((w.state.disks.ct_j >= 0).sum()) > 0
    del g, c, w

    cfg, disks = _deck("periodic_channel")
    g = Simulation(cfg, disks, device="cuda")
    c = Simulation(cfg, disks, device="cpu")
    assert slab_dem.slab_supported(g.grid, g.dem_axis)
    reset_counts()
    g.run(200)
    pcounts = launch_counts()
    c.run(200)
    ef = float((g.state.f.cpu() - c.state.f).abs().max())
    ex = float((g.state.disks.x.cpu() - c.state.disks.x).abs().max())
    xs = g.state.disks.x[:, 0]
    log("decks", f"periodic_channel {cfg.nx}x{cfg.ny}, {len(disks)} mobile "
        f"disks on a periodic x axis, 200 steps: f max err {ef:.3e} (bar "
        f"1e-5), disk x max err {ex:.3e} (bar 1e-4); launches K1 "
        f"{pcounts['K1']}, K2 {pcounts['K2']}, K3 {pcounts['K3']}; seam disk "
        f"x {float(xs[0]):.4f}; overflow {int(g.state.overflow)}")
    assert pcounts["K2"] == pcounts["K3"] == 200, pcounts
    assert int(g.state.overflow) == int(c.state.overflow) == 0
    assert ef <= 1e-5 and ex <= 1e-4
    assert -0.5 <= float(xs[0]) < cfg.nx - 0.5
    return counts, wcounts, pcounts


def ablation(coupling_k: int, chunk: int = 20, storage: str = "float32"):
    """lbmdem_tpu_torch.tools.ablate at 4096^2/10k disks: each variant's
    row and the marginals (bf16 storage: every variant on the K2 step).
    Returns the launch counts of the whole run."""
    from lbmdem_tpu_torch.tools import ablate

    sim = ablate.make_sim(4096, 10000, device="cuda",
                          env={"ABLATE_COUPLING_K": str(coupling_k),
                               "ABLATE_F_STORAGE": storage})
    reset_counts()
    tag = f"ablate k={coupling_k}" + ("" if storage == "float32"
                                      else f" {storage}")
    res = ablate.run_variants(sim, chunk, log=lambda s: log(tag, s))
    counts = launch_counts()
    assert all(r["ms"] > 0 for r in res.values())
    if storage != "float32":
        assert res["full"]["launches"].get("K2") == 1.0, res["full"]
        assert counts["K8"] == counts["K9"] == 0, counts
    elif coupling_k == 1:
        per = res["full"]["launches"]
        assert per.get("K8") == per.get("K9") == per.get("K1") == 1.0, per
        assert res["fused"]["launches"].get("K2") == 1.0
        assert counts["K8"] > 0 and counts["K9"] > 0, counts
    return counts


def _cli(argv):
    """cli.main(argv) in this process: (exit code, stdout, stderr, wall
    seconds), the output echoed to the log."""
    import contextlib
    import io

    from lbmdem_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    secs = time.perf_counter() - t0
    for line in (out.getvalue() + err.getvalue()).splitlines():
        log("cli", f"  | {line}")
    return rc, out.getvalue(), err.getvalue(), secs


def _done_mlups(text: str) -> float:
    """The MLUPS of the CLI's closing line "done: N steps, M MLUPS
    overall"."""
    line = [s for s in text.splitlines() if s.startswith("done:")][-1]
    return float(line.split(",")[1].split()[0])


def cli_full_width(smi: str):
    """The user's entry point at full width: `python -m
    lbmdem_tpu_torch.cli examples/column_collapse.par --steps 200 --out
    <tmp>` in this process (auto path: the kernels), with the launch
    counts zeroed before and read after (K1, K2, K3 and KL 200 each,
    nothing else), the files it writes (metrics.csv, the fluid and particle VTK of
    step 200, trajectories.csv), mass drift < 1e-5 from its metrics row,
    and its step-200 disk state (from trajectories.csv) against an
    in-process Simulation.run(200) of the deck, bit for bit. MLUPS of
    both runs: the CLI's includes the snapshot. Returns the counts."""
    import shutil
    import tempfile

    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.utils.metrics import read_diagnostics

    deck = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "column_collapse.par")
    out = tempfile.mkdtemp(prefix="lbmdem_cli_")
    try:
        reset_counts()
        rc, text, err, secs = _cli([deck, "--steps", "200", "--out", out])
        counts = launch_counts()
        assert rc == 0 and "note:" not in err, (rc, err)
        assert counts == {**_NONE, "K1": 200, "K2": 200, "K3": 200,
                          "KL": 200}, counts
        names = sorted(os.listdir(out))
        want = ["fluid_00000200.vtk", "metrics.csv",
                "particles_00000200.vtk", "trajectories.csv"]
        assert names == want, names
        sizes = {n: os.path.getsize(os.path.join(out, n)) for n in names}
        assert sizes["fluid_00000200.vtk"] > 4096 * 4096 * 4 * 5, sizes
        m = open(os.path.join(out, "metrics.csv")).read().splitlines()
        row = dict(zip(m[0].split(","), m[-1].split(",")))
        mass_err = abs(float(row["mass"]) / 4096 ** 2 - 1.0)
        rows = np.loadtxt(os.path.join(out, "trajectories.csv"),
                          delimiter=",", skiprows=1, ndmin=2)
        cli_mlups = _done_mlups(text)
        cfg, disks = _deck("column_collapse")
        sim = Simulation(cfg, disks, device="cuda")
        sim_mlups = sim.run(200)
        # the host side of one snapshot: what the CLI's callback reads
        t0 = time.perf_counter()
        read_diagnostics(sim.state, sim.cfg)
        sim.macroscopic()
        sim.solid_fraction()
        d = sim.disk_arrays()
        snap_s = time.perf_counter() - t0
        ids = rows[:, 1].astype(np.int64)
        assert (rows[:, 0] == 200).all() and len(ids) == len(disks)
        got = rows[:, 2:].astype(np.float32)
        ref = np.column_stack([d["x"][ids], d["v"][ids], d["theta"][ids],
                               d["omega"][ids]]).astype(np.float32)
        err_d = float(np.abs(got - ref).max())
        log("cli", f"column_collapse.par through the CLI: {rc=}, 200 steps "
            f"in {secs:.2f} s, {cli_mlups:.1f} MLUPS (its run, snapshot "
            f"included) vs Simulation.run(200) of the deck {sim_mlups:.1f} "
            f"MLUPS in this call on {smi} (one snapshot's reads: "
            f"{snap_s:.3f} s); launches {counts}; files "
            f"{sizes}; |mass/(nx ny) - 1| {mass_err:.3e} (bar 1e-5); "
            f"overflow {row['overflow']}, nan {row['nan']}; step-200 disk "
            f"state (x, v, theta, omega of {len(ids)} disks) vs the "
            f"in-process run: max |diff| {err_d:.3e} (bit for bit: "
            f"{bool(np.array_equal(got, ref))})")
        assert mass_err < 1e-5 and int(row["overflow"]) == 0
        assert int(row["nan"]) == 0
        assert np.array_equal(got, ref), f"CLI != in-process run ({err_d})"
        return counts, cli_mlups, sim_mlups
    finally:
        shutil.rmtree(out, ignore_errors=True)


def checkpoint_on_card():
    """examples/settling_column.par on the card: run(100), save_state,
    run(100) more; a fresh Simulation restored from the checkpoint and
    run(100) equals the continuing run, and both equal one run(200) with
    out_interval 100 (the same chunks), bit for bit on every leaf."""
    import tempfile

    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.utils import checkpoint as ckpt

    cfg, disks = _deck("settling_column")
    cfg = cfg.replace(out_interval=100)
    a = Simulation(cfg, disks, device="cuda")
    a.run(100)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "restart.npz")
        ckpt.save_state(path, ckpt.to_host(a.state), a.cfg)
        a.run(100)
        b = Simulation(cfg, disks, device="cuda")
        b.state = ckpt.load_state(path, b.state)
        mb = os.path.getsize(path) / 2**20
    step0 = int(b.state.step)
    b.run(100)
    c = Simulation(cfg, disks, device="cuda")
    c.run(200)
    la, lb, lc = (ckpt._leaves(s.state) for s in (a, b, c))
    same_ab = all(torch.equal(x, y) for x, y in zip(la, lb))
    same_ac = all(torch.equal(x, y) for x, y in zip(la, lc))
    ex = float((b.state.disks.x - c.state.disks.x).abs().max())
    log("checkpoint", f"settling_column {cfg.nx}x{cfg.ny}, {len(disks)} "
        f"disks: restored at step {step0} from a {mb:.1f} MiB checkpoint, "
        f"run(100): equal to the continuing run bit for bit {same_ab}, to "
        f"run(200) {same_ac} (disk x max |diff| {ex:.3e}); overflow "
        f"{int(b.state.overflow)}")
    assert step0 == 100 and int(b.state.step) == 200
    assert same_ab and same_ac


def plain_path_on_card(smi: str):
    """The plain path (use_kernels=False) on the card: the Schafer-Turek
    deck (440 x 82, no stamp tile takes its window) through the CLI's
    auto path, which prints the plain-path note, launches no kernel and
    runs 200 steps, finite with overflow 0; --kernels on that deck is an
    error; examples/settling_column.par in float64 on the card against
    the CPU (20 steps, f and disk x within 1e-9), then its MLUPS; the
    column_collapse deck (4096^2, 10k disks, f32) on the plain path:
    MLUPS over run(4) after run(2). Returns the MLUPS."""
    import tempfile

    from lbmdem_tpu_torch import Simulation

    deck = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples", "schafer_turek.par")
    with tempfile.TemporaryDirectory() as out:
        reset_counts()
        rc, text, err, secs = _cli([deck, "--steps", "200", "--out", out])
        counts = launch_counts()
        m = open(os.path.join(out, "metrics.csv")).read().splitlines()
        row = dict(zip(m[0].split(","), m[-1].split(",")))
        try:
            _cli([deck, "--kernels", "--steps", "2", "--out", out])
            refused = None
        except SystemExit as e:
            refused = e.code
    st_mlups = _done_mlups(text)
    log("plain", f"schafer_turek.par through the CLI's auto path: {rc=}, "
        f"note {'note: ' in err and 'plain path' in err}, 200 steps in "
        f"{secs:.2f} s ({st_mlups:.2f} MLUPS), launches {counts}; step "
        f"{row['step']}, nan {row['nan']}, overflow {row['overflow']}, "
        f"max_u {float(row['max_u']):.4f}; --kernels on it exits "
        f"{refused}")
    assert rc == 0 and "note: " in err and "plain path" in err
    assert counts == _NONE, counts
    assert int(row["step"]) == 200 and int(row["nan"]) == 0
    assert int(row["overflow"]) == 0 and 0 < float(row["max_u"]) < 0.3
    assert refused == 2

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    cfg, disks = _deck("settling_column")
    cfg = cfg.replace(dtype="float64")
    g = Simulation(cfg, disks, device="cuda", use_kernels=False)
    c = Simulation(cfg, disks, device="cpu", use_kernels=False)
    reset_counts()
    g.run(20)
    c.run(20)
    assert launch_counts() == _NONE
    ef = float((g.state.f.cpu() - c.state.f).abs().max())
    ex = float((g.state.disks.x.cpu() - c.state.disks.x).abs().max())
    nc = (int(g.state.n_contacts), int(c.state.n_contacts))
    f64_mlups = g.run(20)
    log("plain", f"settling_column {cfg.nx}x{cfg.ny}, {len(disks)} disks, "
        f"float64, plain path, 20 steps: card vs CPU f max err {ef:.3e}, "
        f"disk x max err {ex:.3e} (bar 1e-9); contacts {nc[0]} == {nc[1]};"
        f" then {f64_mlups:.2f} MLUPS over run(20) on {smi}")
    assert g.state.f.dtype == torch.float64
    assert ef <= 1e-9 and ex <= 1e-9
    assert nc[0] == nc[1] and int(g.state.overflow) == 0
    del g, c

    cfg, disks = _deck("column_collapse")
    p = Simulation(cfg, disks, device="cuda", use_kernels=False)
    p.run(2)
    torch.cuda.reset_peak_memory_stats()
    big_mlups = p.run(4)
    f = p.state.f
    mass_err = abs(float(f.double().sum()) / (cfg.nx * cfg.ny) - 1.0)
    log("plain", f"column_collapse {cfg.nx}x{cfg.ny}, {len(disks)} disks, "
        f"f32, plain path: {big_mlups:.2f} MLUPS over run(4) on {smi}; "
        f"peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"|sum f/(nx ny) - 1| {mass_err:.3e}; overflow "
        f"{int(p.state.overflow)}")
    assert bool(torch.isfinite(f).all()) and mass_err < 1e-5
    assert int(p.state.overflow) == 0
    return st_mlups, f64_mlups, big_mlups


def paranoia_on_card():
    """Paranoid mode on the card against the CPU: a 128x32 channel with
    a fixed disk at rest, a NaN injected into f after step 4, run(8):
    "step" (the per-step cadence path, K1 + K2) reports step 5, "chunk"
    (the static hoist, K7 passes of 4) step 8, each with the state frozen
    there, the same on both devices."""
    from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation
    from lbmdem_tpu_torch.simulation import SimulationDiverged

    for mode, want, kern in ((True, 5, "K2"), ("chunk", 8, "K7")):
        cfg = SimConfig(nx=128, ny=32, tau=0.8, gx=1e-5, paranoia=mode,
                        bc_west="wall", bc_east="wall", out_interval=100)
        got = {}
        for dev in ("cuda", "cpu"):
            sim = Simulation(cfg, [DiskSpec(40.0, 16.0, 3.0, fixed=True)],
                             device=dev)
            sim.run(4)
            assert int(sim.state.fail_step) == -1
            sim.state.f[0, 5, 7] = float("nan")
            reset_counts()
            try:
                sim.run(8)
                got[dev] = None
            except SimulationDiverged as e:
                got[dev] = (e.step, int(sim.state.step),
                            int(sim.state.fail_step))
            if dev == "cuda":
                counts = launch_counts()
        log("paranoia", f"paranoia={mode!r}: card {got['cuda']}, CPU "
            f"{got['cpu']} (fail step, frozen step, fail_step; want "
            f"{want}); card launches {counts}")
        assert got["cuda"] == got["cpu"] == (want, want, want), got
        assert counts[kern] > 0, counts




# --- the lattice mesh (parallel/): K2, K4 and K5 pre-haloed -------------

# lattice options of the pre-haloed checks at a 256 x 128 shard
MESH_MATRIX = [
    ("walls+lid", dict(bc_west="wall", bc_east="wall", uw_north=0.05,
                       gy=-1e-5)),
    ("periodic", dict(bc_south="periodic", bc_north="periodic", gx=1e-5)),
    ("zou-he", dict(bc_west="inlet", bc_east="outlet", u_inlet=0.06,
                    inlet_profile="poiseuille")),
    ("trt+les", dict(collision="trt", smagorinsky=0.16, gx=1e-5,
                     bc_west="wall", bc_east="wall")),
]
# K5's edge flags (south, north, west, east, global row offset) of a
# shard of a 4 x 4 mesh of 256-row shards: corner, edge, interior (a
# "y" shard spans the width: both x flags set)
MESH_EDGES = [(1, 1, 1, 1, 0), (1, 0, 1, 0, 0), (0, 1, 0, 1, 768),
              (0, 0, 0, 0, 512)]


def mesh_frame(cfg, mode: str, seed: int, amp: float = 0.05):
    """A shard's pre-haloed frame f = w_i (1 + amp N(0, 1)) on the card,
    in cfg's storage form (bf16: the shifted populations, 16 halo
    rows)."""
    from lbmdem_tpu_torch import lattice
    from lbmdem_tpu_torch.ops import fused_fluid, lbm

    g = torch.Generator(device="cuda").manual_seed(seed)
    w = torch.as_tensor(lattice.W, dtype=torch.float32, device="cuda")
    shape = fused_fluid.frame_shape(cfg, mode)
    return lbm.to_storage(w[:, None, None] * (1.0 + amp * torch.randn(
        shape, generator=g, device="cuda")), cfg)


def storage_empty(cfg, *shape):
    """An empty (9, ny, nx)-like buffer of cfg's f storage on the card."""
    from lbmdem_tpu_torch.ops import fused_fluid

    return torch.empty(shape, dtype=fused_fluid.storage_dtype(cfg),
                       device="cuda")


def mesh_fluid_check(cfg, mode: str, k: int, edges, seed: int, label: str,
                     timed: bool = False, amp: float = 0.05,
                     k5: bool = False, nyg: int = 0):
    """K4 (k == 1 and not k5) or K5 (k steps, `edges`; the inlet profile
    of nyg global rows, default 4 shards) on a pre-haloed frame against
    its plain version on the same card input, at fluid_bar's bars.
    Returns work(max_abs_err, ms, plain_ms, bytes, flops): the bytes are
    the frame's cells the k steps need read once (frame_bytes: a ring of
    k around the interior) and the interior, and K4's edge populations,
    written once."""
    from lbmdem_tpu_torch.ops import fused_fluid

    f = mesh_frame(cfg, mode, seed, amp)
    a = storage_empty(cfg, 9, cfg.ny, cfg.nx)
    b = torch.empty_like(a)
    nyg = nyg or 4 * cfg.ny
    ea = (torch.empty((9, 2, cfg.nx), device="cuda"),
          torch.empty((9, cfg.ny, 2), device="cuda"))
    eb = tuple(torch.empty_like(t) for t in ea)
    k4 = k == 1 and not k5
    if k4:
        wrapper = fused_fluid.fused_step_fluid
        run = lambda: wrapper(f, cfg, a, prehalo=mode,  # noqa: E731
                              edge_post=ea)
        plain = lambda: fused_fluid.fused_step_fluid_prehalo_plain(  # noqa
            f, cfg, mode, b, eb)
    else:
        wrapper = fused_fluid.fused_step_fluid_multi
        run = lambda: wrapper(f, cfg, k, a, prehalo=mode,  # noqa: E731
                              edges=edges, ny_glob=nyg)
        plain = lambda: fused_fluid.fused_step_fluid_multi_prehalo_plain(  # noqa
            f, cfg, k, mode, edges, nyg, b)
    n0 = wrapper.launches
    run()
    assert wrapper.launches == n0 + 1, "the kernel did not launch"
    plain()
    torch.cuda.synchronize()
    d = (a.float() - b.float()).abs()
    err = float(d.max())
    atol, rtol = fluid_bar(cfg, k)
    excess = float((d - rtol * b.float().abs()).max())
    if k4:  # the edge rows' and columns' post-collision populations
        for x, y in zip(ea, eb):
            err = max(err, float((x - y).abs().max()))
            excess = max(excess, float(((x - y).abs() - rtol * y.abs()).max()))
    name = "K4" if k4 else f"K5 k={k} edges={edges}"
    log("mesh-kernels", f"{label} prehalo={mode} {cfg.f_storage} {name}: max "
        f"err {err:.3e} (bar atol {atol:g} + rtol {rtol:g})")
    assert bool(torch.isfinite(a).all()), f"{label} {name}: non-finite"
    assert excess <= atol, f"{label} {name}: err {err} over the bar"
    t = (cuda_ms(run, 20), cuda_ms(plain, 2)) if timed else (None, None)
    moved = frame_bytes(f, cfg.ny, cfg.nx, mode, k) + nbytes(a)
    if k4:
        moved += nbytes(*ea)
    return work(err, *t, moved, k * FLOPS_FLUID * cfg.nx * cfg.ny)


def perturbed(f, cfg, g):
    """f (storage form) with its physical populations times 1 + 0.02 N(0,
    1) from generator g, back in storage form (bf16 at rest stores 0)."""
    from lbmdem_tpu_torch.ops import lbm

    ph = lbm.from_storage(f, cfg)
    return lbm.to_storage(ph * (1.0 + 0.02 * torch.randn(
        f.shape, generator=g, device=f.device)), cfg)


def coupled_bars(cfg):
    """(f' atol, force bar relative to the largest |F|) of a coupled
    kernel against its plain version: 5e-6 and 1e-6 on f32; 3e-4 and
    5e-6 on bf16 (ROADMAP.md section 3; the kernel's shifted arithmetic
    rounds otherwise than the plain version's physical form)."""
    return (3e-4, 5e-6) if cfg.f_storage == "bfloat16" else (5e-6, 1e-6)


def mesh_coupled_inputs(cfg, disks, dims, seed: int):
    """A coupled scene on a mesh of one card: the sharded kernel path's
    pieces (parallel/_kernel_step._Sharded), pre-collision frames of
    perturbed f, and every shard's K2 inputs from disks with random
    velocities. Returns (parts, frames, [(entries, solid, td, cnt, s_k,
    K2's origin)])."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.parallel import make_mesh
    from lbmdem_tpu_torch.parallel._kernel_step import _Sharded, exchange

    mesh = make_mesh(["cuda"] * (dims[0] * dims[1]), dims)
    sim = Simulation(cfg, disks, mesh=mesh)
    parts = _Sharded(sim.cfg, sim.grid, mesh, sim.dem_axis, sim.dem_mode)
    rng = np.random.default_rng(seed)
    d = sim._state.disks[0]
    n = d.x.shape[0]
    v = torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)), dtype=torch.float32,
                        device="cuda")
    om = torch.as_tensor(rng.uniform(-2e-3, 2e-3, n), dtype=torch.float32,
                         device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed)
    fs = [perturbed(f, sim.cfg, g) for f in sim._state.f]
    frames = exchange(fs, mesh)
    ins = []
    for p, iy, ix in mesh.positions():
        entries, solid, td, cnt, s_k, bovf = parts.shard_inputs(
            iy, ix, (d.x, v, om, d.r, d.active))
        assert int(bovf) == 0, f"binning overflow {int(bovf)}"
        ins.append((entries, solid, td, cnt, s_k,
                    parts.interior_origin(iy, ix)))
    return parts, frames, ins


def mesh_k2_check(parts, frame, inp, label: str, timed: bool = False):
    """K2 on a shard's frame against its plain version on the same card
    input: f' atol 5e-6, forces (gather_partials over the interior entry
    slots) 1e-6 of the largest |F| (phase 3's K2 bars; bf16 coupled_bars).
    Its bytes: f and
    the solid window over the interior and its ring of one cell
    (frame_bytes), the binning, and f', the partials and the edge
    populations written."""
    from lbmdem_tpu_torch.ops import fused_lbm, stamp

    cfg, mode = parts.local_cfg, parts.mode
    entries, _, td, cnt, s_k, origin = inp
    a = storage_empty(cfg, 9, cfg.ny, cfg.nx)
    b = torch.empty_like(a)
    ea = (torch.empty((9, 2, cfg.nx), device="cuda"),
          torch.empty((9, cfg.ny, 2), device="cuda"))
    eb = tuple(torch.empty_like(t) for t in ea)
    fbar, rbar = coupled_bars(cfg)
    run = lambda: fused_lbm.fused_step_imb_reduce(  # noqa: E731
        frame, s_k, td, cnt, cfg, a, prehalo=mode, origin=origin,
        edge_post=ea)
    plain = lambda: fused_lbm.fused_step_imb_reduce_prehalo_plain(  # noqa
        frame, s_k, td, cnt, cfg, mode, origin, b, eb)
    n0 = fused_lbm.fused_step_imb_reduce.launches
    _, pk = run()
    assert fused_lbm.fused_step_imb_reduce.launches == n0 + 1
    _, pp = plain()
    torch.cuda.synchronize()
    e2 = max(float((x.float() - y.float()).abs().max()) for x, y in
             zip((a,) + ea, (b,) + eb))
    F, T = stamp.gather_partials(pk, entries, torch.float32)
    Fp, Tp = stamp.gather_partials(pp, entries, torch.float32)
    fmax = float(Fp.abs().max())
    e2f = float((F - Fp).abs().max())
    log("mesh-kernels", f"{label} prehalo={mode} {cfg.f_storage} origin="
        f"{origin} K2: f' (and edge post-collision populations) max "
        f"err {e2:.3e} (bar {fbar:g}); force err {e2f:.3e} vs max|F| "
        f"{fmax:.3e} (bar {rbar:g} relative); torque err "
        f"{float((T - Tp).abs().max()):.3e}; binned disks "
        f"{int((entries >= 0).any(1).sum())}")
    assert e2 <= fbar, f"K2 {label}: f' max err {e2}"
    assert e2f <= rbar * max(fmax, 1e-30), f"K2 {label}: force err {e2f}"
    assert bool(torch.isfinite(a).all())
    cov = cov_flops_of(cfg, cnt)
    t = (cuda_ms(run, 20), cuda_ms(plain, 2)) if timed else (None, None)
    moved = (frame_bytes(frame, cfg.ny, cfg.nx, mode, 1)
             + frame_bytes(s_k, cfg.ny, cfg.nx, mode, 1)
             + nbytes(td, cnt, a, pk, *ea))
    return work(e2, *t, moved,
                nt_flops(s_k[:, 8:8 + cfg.ny, parts.padx:parts.padx + cfg.nx])
                + cov)


def mesh_kernels(n: int = 4096):
    """K4, K5 and K2 in each pre-haloed mode against their plain versions
    on the card: over MESH_MATRIX (and K5 over MESH_EDGES) at a 256 x 128
    shard, K2 on every shard of a 512^2 column collapse on 2 x 2 ("yx")
    and 4 x 1 ("y") meshes; then at the 2 x 2 shard of the n^2 slice
    (n/2 square, plus halos) and the 4 x 1 one, timed with CUDA events
    beside the same kernel on an n/2-square lattice without a halo.
    Returns {record: work(...)} of the timed n/2 "yx" checks."""
    from lbmdem_tpu_torch import SimConfig
    from lbmdem_tpu_torch.models import column_collapse
    from lbmdem_tpu_torch.ops import fused_fluid, fused_lbm

    for i, (label, kw) in enumerate(MESH_MATRIX):
        cfg = SimConfig(**{"nx": 128, "ny": 256, "tau": 0.8,
                           "dtype": "float32", **kw})
        for mode in ("y", "yx"):
            mesh_fluid_check(cfg, mode, 1, None, 300 + i,
                             f"{label} {cfg.ny}x{cfg.nx}")
            for j, e in enumerate(MESH_EDGES):
                if mode == "y":  # a "y" shard spans the width
                    e = e[:2] + (1, 1) + e[4:]
                mesh_fluid_check(cfg, mode, 4, e, 310 + i + j,
                                 f"{label} {cfg.ny}x{cfg.nx}")
    cfg, disks = column_collapse(nx=512, ny=512, n_disks=240)
    for dims in ((2, 2), (4, 1)):
        parts, frames, ins = mesh_coupled_inputs(cfg, compressed(disks, 0.94),
                                                 dims, 7)
        for p, inp in enumerate(ins):
            mesh_k2_check(parts, frames[p], inp,
                          f"512^2/{len(disks)} disks {dims} shard {p}")
    out = {}
    h = n // 2
    for mode, shape in (("yx", (h, h)), ("y", (n // 4, n))):
        cfg = SimConfig(nx=shape[1], ny=shape[0], tau=0.8, gx=1e-6,
                        dtype="float32")
        w4 = mesh_fluid_check(cfg, mode, 1, None, 21, f"{shape}", timed=True,
                              amp=0.02)
        w5 = mesh_fluid_check(cfg, mode, 4, (1, 0, 1, int(mode == "y"), 0),
                              22, f"{shape}", timed=True, amp=0.02)
        f = mesh_frame(cfg, "", 23, 0.02)
        a = torch.empty_like(f)
        t4 = cuda_ms(lambda: fused_fluid.fused_step_fluid(f, cfg, a), 20)
        t5 = cuda_ms(lambda: fused_fluid.fused_step_fluid_multi(f, cfg, 4, a),
                     20)
        for key, w, t in (("K4", w4, t4), ("K5", w5, t5)):
            bms, by = bound(w)
            log("mesh-kernels", f"{shape[0]}x{shape[1]} shard prehalo={mode} "
                f"{key}: kernel {w['ms']:.4f} ms, plain {w['plain_ms']:.4f} ms"
                f", the same kernel without a halo on {shape[0]}x{shape[1]} "
                f"{t:.4f} ms (CUDA events); bound {bms:.4f} ms by {by} "
                f"({w['bytes'] / 1e9:.4f} GB, the halo cells it reads "
                f"included)")
            if mode == "yx":
                out[key] = w
    cfg, disks = column_collapse()
    for dims in ((2, 2), (4, 1)):
        parts, frames, ins = mesh_coupled_inputs(cfg, compressed(disks, 0.94),
                                                 dims, 8)
        w2 = mesh_k2_check(parts, frames[0], ins[0],
                           f"{n}^2/{len(disks)} disks {dims} shard 0",
                           timed=True)
        # the same step without a halo on shard 0's interior, whose
        # global origin is (0, 0): the same cells, tiles and windows of
        # the same records, so the same partials
        lc, hx = parts.local_cfg, parts.padx
        assert ins[0][5] == (0, 0)
        f = frames[0][:, 8:8 + lc.ny, hx:hx + lc.nx].contiguous()
        solid = ins[0][4][:, 8:8 + lc.ny, hx:hx + lc.nx].contiguous()
        td = ins[0][2]
        a, b = torch.empty_like(f), torch.empty((9, lc.ny, lc.nx),
                                                device="cuda")
        _, p0 = fused_lbm.fused_step_imb_reduce(f, solid, td, ins[0][3], lc,
                                                a)
        _, p1 = fused_lbm.fused_step_imb_reduce(
            frames[0], ins[0][4], td, ins[0][3], lc, b, prehalo=parts.mode,
            origin=(0, 0))
        perr = float((p0 - p1).abs().max())
        pmax = float(p1.abs().max())
        t2 = cuda_ms(lambda: fused_lbm.fused_step_imb_reduce(
            f, solid, td, ins[0][3], lc, a), 20)
        bms, by = bound(w2)
        log("mesh-kernels", f"{lc.ny}x{lc.nx} shard of {n}^2 prehalo="
            f"{parts.mode} K2: kernel {w2['ms']:.4f} ms, plain "
            f"{w2['plain_ms']:.4f} ms, the step without a halo on "
            f"{lc.ny}x{lc.nx} {t2:.4f} ms (CUDA events); bound {bms:.4f} ms "
            f"by {by} ({w2['bytes'] / 1e9:.4f} GB, its ring included); "
            f"partials against the halo-free step's {perr:.3e} of max "
            f"{pmax:.3e}")
        assert perr <= 1e-6 * max(pmax, 1e-30), perr
        if parts.mode == "yx":
            out["K2"] = w2
    return out


def paired_runs(sh, one, steps: int):
    """MLUPS of sh.run(steps) (the mesh) and one.run(steps) (one device)
    in alternating pairs, mesh, one, one, mesh, mesh, one: the host-bound
    wall clock swings within a call, so the ratio is read per pair.
    Returns (launch counts of the first mesh run, the mesh's readings,
    one device's, the per-pair ratios)."""
    reset_counts()
    reads = {"mesh": [sh.run(steps)], "one": []}
    counts = launch_counts()
    for who in ("one", "one", "mesh", "mesh", "one"):
        reads[who].append((sh if who == "mesh" else one).run(steps))
    ratios = [m / o for m, o in zip(reads["mesh"], reads["one"])]
    return counts, reads["mesh"], reads["one"], ratios


def paired_line(mesh, m, o, r, steps: int, smi: str) -> str:
    return (f"{mesh_cards(mesh)}: timed run({steps}) in pairs (mesh, one, "
            f"one, mesh, mesh, one), wall clock: mesh {m} MLUPS, one device "
            f"{o} MLUPS, ratio per pair {[round(x, 4) for x in r]} "
            f"(median {float(np.median(r)):.4f}x) on {smi}")


def mesh_cards(mesh) -> str:
    return (f"{mesh.shape['y']}x{mesh.shape['x']} mesh, shards on "
            f"{len(mesh.replicas)} card(s) {[str(d) for d in mesh.replicas]}")


def mesh_slice(smi: str, dims, devices=None, storage: str = "float32",
               eps_method: str = "sample", coupling_k: int = 1):
    """BASELINE config 5, the column collapse at 4096^2 with 10 000 disks
    (BGK, walls; f32 or bf16 storage, sample or ramp, coupling_k: the
    bench.py stages 4096x4096/{storage}/{eps}[/k{ck}]) through
    Simulation(..., mesh=...): run(16) against the single-device run(16)
    at tests/test_sharding.py's chunk bars (f 5e-6, bf16 3e-4; x 1e-5; v
    1e-6), then run(100) timed in pairs with the single-device run(100)
    (paired_runs): MLUPS, launches (mesh_chunk_counts), overflow 0 and
    mass drift < 1e-5 (bf16 1e-4). Returns (launch counts of the first
    timed run, median MLUPS, single-device median MLUPS)."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import column_collapse
    from lbmdem_tpu_torch.ops import lbm
    from lbmdem_tpu_torch.parallel import make_mesh

    cfg, disks = column_collapse()
    cfg = cfg.replace(out_interval=10**9, f_storage=storage,
                      eps_method=eps_method, coupling_k=coupling_k)
    bf16 = storage == "bfloat16"
    fbar, mbar = (3e-4, 1e-4) if bf16 else (5e-6, 1e-5)
    n = dims[0] * dims[1]
    mesh = make_mesh(devices or ["cuda"] * n, dims)
    one = Simulation(cfg, disks, device="cuda")
    sh = Simulation(cfg, disks, mesh=mesh)
    one.run(16)
    sh.run(16)
    a, b = one.state, sh.state
    bf, bx, bv = (t.to(a.f.device) for t in (b.f, b.disks.x, b.disks.v))
    assert bf.dtype == a.f.dtype
    ef = float((a.f.float() - bf.float()).abs().max())
    ex = float((a.disks.x - bx).abs().max())
    ev = float((a.disks.v - bv).abs().max())
    tag = f"{storage}/{eps_method}/k{coupling_k}"
    log("mesh-slice", f"{cfg.nx}x{cfg.ny}, {len(disks)} disks, {tag}, "
        f"{mesh_cards(mesh)}: run(16) against one device: f max err "
        f"{ef:.3e} (bar {fbar:g}; f equal {torch.equal(a.f, bf)}), x "
        f"{ex:.3e} (bar 1e-5), v {ev:.3e} (bar 1e-6)")
    assert ef <= fbar and ex <= 1e-5 and ev <= 1e-6, (ef, ex, ev)
    del a, b, bf
    counts, m, o, r = paired_runs(sh, one, 100)
    st = sh.state
    f = lbm.from_storage(st.f, cfg)
    mass_err = abs(float(f.double().sum()) / (cfg.nx * cfg.ny) - 1.0)
    log("mesh-slice", f"{tag}: " + paired_line(mesh, m, o, r, 100, smi))
    log("mesh-slice", f"{tag}: launches of the first timed run(100) "
        f"{ {k: v for k, v in counts.items() if v} }; overflow "
        f"{int(st.overflow)}; n_contacts {int(st.n_contacts)}; "
        f"|sum f/(nx ny) - 1| {mass_err:.3e} (bar {mbar:g})")
    assert counts == mesh_chunk_counts(100, coupling_k, n,
                                       len(mesh.replicas)), counts
    assert int(st.overflow) == 0, f"overflow {int(st.overflow)}"
    assert bool(torch.isfinite(f).all()), "non-finite f"
    assert mass_err < mbar, f"mass drift {mass_err}"
    return counts, float(np.median(m)), float(np.median(o))


def mesh_chunk_counts(n: int, ck: int, shards: int, replicas: int) -> dict:
    """The launches of a mesh's coupled run(n): Verlet-cadence blocks of
    BIN_CADENCE steps, each b // ck windows (K1 and K6 per shard, K3w per
    inner step and replica, KL per replica) and b % ck single steps (K1
    and K2 per shard, K3 and KL per replica)."""
    from lbmdem_tpu_torch.simulation import BIN_CADENCE

    wins = singles = 0
    for b in [BIN_CADENCE] * (n // BIN_CADENCE) + [n % BIN_CADENCE]:
        nw, r = divmod(b, ck) if ck > 1 else (0, b)
        wins, singles = wins + nw, singles + r
    return {**_NONE, "K1": (wins + singles) * shards, "K2": singles * shards,
            "K6": wins * shards, "K3": singles * replicas,
            "K3w": wins * ck * replicas, "KL": (wins + singles) * replicas}


def mesh_fluid(smi: str, dims=(2, 2), devices=None, n: int = 4096,
               storage: str = "float32"):
    """n^2 pure fluid (bench.py's fluid/4096 stages: tau 0.8, gx 1e-6,
    periodic x, walls in y) on a mesh: run(19) (4 K5 blocks, 3 K4 steps)
    against the single-device run(19) within 1e-7 (bf16: one bf16 ulp,
    rtol 1e-2 with atol 1e-6, and whether f is equal), then run(400)
    timed in pairs with the single-device run(400) (paired_runs).
    Returns (launch counts of the mesh's run(19), median MLUPS)."""
    from lbmdem_tpu_torch import SimConfig, Simulation
    from lbmdem_tpu_torch.parallel import make_mesh

    cfg = SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, dtype="float32",
                    out_interval=10**9, f_storage=storage)
    mesh = make_mesh(devices or ["cuda"] * (dims[0] * dims[1]), dims)
    one = Simulation(cfg, device="cuda")
    sh = Simulation(cfg, mesh=mesh)
    one.run(19)
    reset_counts()
    sh.run(19)
    c19 = launch_counts()
    a, b = one.state.f.float(), sh.state.f.to(one.device).float()
    err = float((a - b).abs().max())
    atol, rtol = (1e-6, 1e-2) if storage == "bfloat16" else (1e-7, 0.0)
    excess = float(((a - b).abs() - rtol * a.abs()).max())
    log("mesh-fluid", f"{n}x{n} {storage}, {mesh_cards(mesh)}: run(19) "
        f"against one device: f max err {err:.3e} (bar atol {atol:g} + rtol "
        f"{rtol:g}; f equal {torch.equal(a, b)}); launches of the mesh's "
        f"run(19) {c19}")
    assert excess <= atol, err
    assert c19 == {**_NONE, "K5": 4 * mesh.size, "K4": 3 * mesh.size}, c19
    counts, m, o, r = paired_runs(sh, one, 400)
    log("mesh-fluid", f"{storage}: " + paired_line(mesh, m, o, r, 400, smi)
        + f"; launches of the first mesh run {counts}")
    assert counts == {**_NONE, "K5": 100 * mesh.size}, counts
    return c19, float(np.median(m))


# --- the lattice mesh II: K6, K7 and K8 pre-haloed, the window and static
# mesh paths, paranoia on a mesh -------------------------------------------

def mesh_grid_disks(ny: int, nx: int, pitch: int = 40, r: float = 3.0,
                    fixed: bool = False, seed: int = 0):
    """Disks on a jittered square grid over the whole lattice, so every
    shard and seam holds some; seeded velocities unless fixed (at rest)."""
    from lbmdem_tpu_torch import DiskSpec

    rng = np.random.default_rng(seed)
    out = []
    for y in range(pitch // 2, ny, pitch):
        for x in range(pitch // 2, nx, pitch):
            jx, jy = rng.uniform(-pitch / 4, pitch / 4, 2)
            vx, vy = (0.0, 0.0) if fixed else rng.uniform(-0.02, 0.02, 2)
            out.append(DiskSpec(x + jx, y + jy, r, vx, vy, fixed=fixed))
    return out


def mesh_k6_check(parts, frame, inp, p: int, k: int, label: str,
                  timed: bool = False):
    """K6 pre-haloed on shard p's frame against its plain version on CPU
    copies of the same inputs (the plain version on the card multiplies
    by 1/tau): f' 5e-6, every inner step's forces 1e-6 of the largest |F|
    (K6's bars). On bf16 (coupled_bars) the plain version runs on the
    card, to keep phase 41 short; its multiply by 1/tau adds its own
    rounding to the difference. Its bytes: f and the
    solid window over the interior and its ring of k cells
    (frame_bytes), the binning, f' and the partials written; its
    operations k NT collides and reduces."""
    from lbmdem_tpu_torch.ops import fused_lbm, stamp

    cfg, mode = parts.local_cfg, parts.mode
    entries, _, td, cnt, s_k, origin = inp
    edges, nyg = parts.edges[p], parts.cfg.ny
    fbar, rbar = coupled_bars(cfg)
    a = storage_empty(cfg, 9, cfg.ny, cfg.nx)
    k6 = fused_lbm.fused_step_imb_reduce_multi
    run = lambda: k6(frame, s_k, td, cnt, cfg, k, a,  # noqa: E731
                     prehalo=mode, origin=origin, edges=edges, ny_glob=nyg)
    n0 = k6.launches
    _, pk = run()
    assert k6.launches == n0 + 1, "K6 did not launch"
    on = "cuda" if cfg.f_storage == "bfloat16" else "cpu"
    c = [t.to(on) for t in (frame, s_k, td, cnt)]
    b, pp = fused_lbm.fused_step_imb_reduce_multi_prehalo_plain(
        *c, cfg, k, mode, origin, edges, nyg, torch.empty_like(a, device=on))
    b, pp = b.cpu().float(), pp.cpu()
    err = float((a.cpu().float() - b).abs().max())
    ef, fmax = 0.0, 0.0
    es = entries.cpu()
    for t in range(k):
        F, _ = stamp.gather_partials(pk[t].cpu(), es, torch.float32)
        Fp, _ = stamp.gather_partials(pp[t], es, torch.float32)
        m = max(float(Fp.abs().max()), 1e-30)
        fmax = max(fmax, m)
        ef = max(ef, float((F - Fp).abs().max()) / m)
    assert bool(torch.isfinite(a).all()), f"K6 {label}: non-finite"
    assert err <= fbar, f"K6 k={k} {label}: f' err {err}"
    assert ef <= rbar, f"K6 k={k} {label}: force err {ef} relative"
    t = (None, None)
    if timed:
        bb = torch.empty_like(a)
        t = (cuda_ms(run, 10), cuda_ms(
            lambda: fused_lbm.fused_step_imb_reduce_multi_prehalo_plain(
                frame, s_k, td, cnt, cfg, k, mode, origin, edges, nyg, bb),
            1))
    inner = s_k[:, 8:8 + cfg.ny, parts.padx:parts.padx + cfg.nx]
    moved = (frame_bytes(frame, cfg.ny, cfg.nx, mode, k)
             + frame_bytes(s_k, cfg.ny, cfg.nx, mode, k)
             + nbytes(td, cnt, a, pk))
    return work(err, *t, moved, k * (nt_flops(inner) + cov_flops_of(cfg, cnt))
                ), ef, fmax


def mesh_k7_check(parts, frame, s_k, p: int, k: int, label: str,
                  timed: bool = False):
    """K7 pre-haloed on shard p's frame against its plain version on CPU
    copies of the same inputs: rtol 1e-5 with atol 2e-6 (K7's bar; bf16:
    atol 3e-4 against the plain version on the card). Its bytes: f and
    the solid window over the interior and its ring of k cells, f'
    written."""
    from lbmdem_tpu_torch.ops import fused_static

    cfg, mode = parts.local_cfg, parts.mode
    edges, nyg = parts.edges[p], parts.cfg.ny
    bf16 = cfg.f_storage == "bfloat16"
    a = storage_empty(cfg, 9, cfg.ny, cfg.nx)
    k7 = fused_static.fused_step_imb_static_multi
    run = lambda: k7(frame, s_k, cfg, k, a, prehalo=mode,  # noqa: E731
                     edges=edges, ny_glob=nyg)
    n0 = k7.launches
    run()
    assert k7.launches == n0 + 1, "K7 did not launch"
    on = "cuda" if bf16 else "cpu"
    b = fused_static.fused_step_imb_static_multi_prehalo_plain(
        frame.to(on), s_k.to(on), cfg, k, mode, edges, nyg,
        torch.empty_like(a, device=on)).cpu().float()
    d = (a.cpu().float() - b).abs()
    err = float(d.max())
    atol, rtol = (3e-4, 0.0) if bf16 else (2e-6, 1e-5)
    assert bool(torch.isfinite(a).all()), f"K7 {label}: non-finite"
    assert float((d - rtol * b.abs()).max()) <= atol, \
        f"K7 k={k} {label}: err {err} over the bar"
    t = (None, None)
    if timed:
        bb = torch.empty_like(a)
        t = (cuda_ms(run, 10), cuda_ms(
            lambda: fused_static.fused_step_imb_static_multi_prehalo_plain(
                frame, s_k, cfg, k, mode, edges, nyg, bb), 1))
    inner = s_k[:, 8:8 + cfg.ny, parts.padx:parts.padx + cfg.nx]
    moved = (frame_bytes(frame, cfg.ny, cfg.nx, mode, k)
             + frame_bytes(s_k, cfg.ny, cfg.nx, mode, k) + nbytes(a))
    return work(err, *t, moved, k * nt_flops(inner))


def mesh_k8_check(parts, frame, s_k, label: str, timed: bool = False):
    """K8 pre-haloed on a shard's frame against its plain version on CPU
    copies: f' 5e-6, phi 1e-6. Its bytes: f and the solid fields over the
    interior and its ring of one cell, f' and phi written."""
    from lbmdem_tpu_torch.ops import fused_lbm

    cfg, mode = parts.local_cfg, parts.mode
    a = torch.empty((9, cfg.ny, cfg.nx), device="cuda")
    k8 = fused_lbm.fused_step_imb
    run = lambda: k8(frame, s_k[0], s_k[1], s_k[2], cfg, a,  # noqa: E731
                     prehalo=mode)
    n0 = k8.launches
    _, px, py = run()
    assert k8.launches == n0 + 1, "K8 did not launch"
    c, s = frame.cpu(), s_k.cpu()
    b, qx, qy = k8(c, s[0], s[1], s[2], cfg, torch.empty((9, cfg.ny, cfg.nx)),
                   prehalo=mode)
    err = float((a.cpu() - b).abs().max())
    ephi = max(float((px.cpu() - qx).abs().max()),
               float((py.cpu() - qy).abs().max()))
    assert err <= 5e-6 and ephi <= 1e-6, f"K8 {label}: {err}, phi {ephi}"
    t = (None, None)
    if timed:
        bb = torch.empty_like(a)
        t = (cuda_ms(run, 20), cuda_ms(
            lambda: fused_lbm.fused_step_imb_prehalo_plain(
                frame, s_k[0], s_k[1], s_k[2], cfg, mode, bb), 2))
    inner = s_k[:, 8:8 + cfg.ny, parts.padx:parts.padx + cfg.nx]
    moved = (frame_bytes(frame, cfg.ny, cfg.nx, mode, 1)
             + frame_bytes(s_k, cfg.ny, cfg.nx, mode, 1)
             + nbytes(a, px, py))
    return work(max(err, ephi), *t, moved, nt_flops(inner)), ephi


# the shards of the matrix checks: corner, edge, interior and the far
# corner of a 3 x 3 mesh ("yx"); every shard of a 3 x 1 mesh ("y")
MESH2_SHARDS = {"yx": ((3, 3), (0, 1, 4, 8)), "y": ((3, 1), (0, 1, 2))}


def mesh_tblock_matrix() -> None:
    """K6 over phase 18's matrix (BREADTH_MATRIX) and K7 over phase 10's
    (STATIC_MATRIX), k = 1, 2, 4, 8, and K8 over phase 18's, on the
    pre-haloed 256 x 128 shards of MESH2_SHARDS (corner, edge and
    interior flags, Zou/He among the options) against their plain
    versions on CPU copies."""
    from lbmdem_tpu_torch import SimConfig

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    opts = ([("K6", lb, kw) for lb, kw in BREADTH_MATRIX]
            + [("K7", lb, kw) for lb, kw in STATIC_MATRIX])
    for mode, (dims, shards) in MESH2_SHARDS.items():
        ny, nx = 256 * dims[0], 128 * dims[1]
        disks = mesh_grid_disks(ny, nx, seed=len(mode))
        worst = {"K6": [0.0, 0.0], "K7": [0.0], "K8": [0.0, 0.0]}
        for i, (kern, label, kw) in enumerate(opts):
            cfg = SimConfig(**{"nx": nx, "ny": ny, "tau": 0.8,
                               "dtype": "float32", **kw})
            parts, frames, ins = mesh_coupled_inputs(cfg, disks, dims,
                                                     400 + i)
            for p in shards:
                tag = f"{label} {mode} shard {p} edges {parts.edges[p]}"
                if kern == "K7":
                    for k in (1, 2, 4, 8):
                        w = mesh_k7_check(parts, frames[p], ins[p][4], p, k,
                                          tag)
                        worst["K7"][0] = max(worst["K7"][0], w["err"])
                    continue
                for k in (1, 2, 4, 8):
                    w, ef, _ = mesh_k6_check(parts, frames[p], ins[p], p, k,
                                             tag)
                    worst["K6"] = [max(worst["K6"][0], w["err"]),
                                   max(worst["K6"][1], ef)]
                w, ephi = mesh_k8_check(parts, frames[p], ins[p][4], tag)
                worst["K8"] = [max(worst["K8"][0], w["err"]),
                               max(worst["K8"][1], ephi)]
        log("mesh-kernels-2", f"prehalo={mode} {dims} mesh of 256x128 shards"
            f" {list(shards)}: K6 k=1,2,4,8 over {len(BREADTH_MATRIX)} "
            f"options, worst f' err {worst['K6'][0]:.3e} (bar 5e-6), worst "
            f"force err {worst['K6'][1]:.3e} of max|F| (bar 1e-6); K7 k=1,2,"
            f"4,8 over {len(STATIC_MATRIX)} options, worst err "
            f"{worst['K7'][0]:.3e} (bar atol 2e-6 + rtol 1e-5); K8 worst f' "
            f"err {worst['K8'][0]:.3e} (bar 5e-6), phi {worst['K8'][1]:.3e}"
            f" (bar 1e-6); plain versions on CPU tensors")


def mesh_tblock_timed(n: int = 4096):
    """At the 2 x 2 (n/2 square) and 4 x 1 shards of the n^2 window and
    static scenes: K6 (k = 4) and K8 on shard 0 of the column collapse
    (10 000 disks), K7 (k = 4) on shard 0 of the static bed (4096 fixed
    disks), each against its plain version, timed with CUDA events beside
    the same kernel without a halo on the shard's interior (whose global
    origin is (0, 0): K6's partials equal the halo-free pass's on the
    same tiles) and their bounds (the cells each reads: a ring of k for
    K6 and K7, of 1 for K8). Returns {"K6"|"K7"|"K8": work} of the 2 x 2
    shards."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.models import column_collapse
    from lbmdem_tpu_torch.ops import fused_lbm, fused_static
    from lbmdem_tpu_torch.parallel import make_mesh
    from lbmdem_tpu_torch.parallel._kernel_step import (
        _Sharded, exchange, sharded_static_solid,
    )

    out = {}
    cfg, disks = column_collapse()
    cfg = cfg.replace(coupling_k=4)
    for dims in ((2, 2), (4, 1)):
        parts, frames, ins = mesh_coupled_inputs(cfg, compressed(disks, 0.94),
                                                 dims, 9)
        lc, hx, mode = parts.local_cfg, parts.padx, parts.mode
        w6, ef, fmax = mesh_k6_check(parts, frames[0], ins[0], 0, 4,
                                     f"{n}^2 {dims} shard 0", timed=True)
        w8, _ = mesh_k8_check(parts, frames[0], ins[0][4],
                              f"{n}^2 {dims} shard 0", timed=True)
        _, _, td, cnt, s_k, origin = ins[0]
        assert origin == (0, 0)
        f = frames[0][:, 8:8 + lc.ny, hx:hx + lc.nx].contiguous()
        solid = s_k[:, 8:8 + lc.ny, hx:hx + lc.nx].contiguous()
        a = torch.empty_like(f)
        t6 = cuda_ms(lambda: fused_lbm.fused_step_imb_reduce_multi(
            f, solid, td, cnt, lc, 4, a), 10)
        t8 = cuda_ms(lambda: fused_lbm.fused_step_imb(
            f, solid[0], solid[1], solid[2], lc, a), 20)
        for key, wk, t in (("K6 k=4", w6, t6), ("K8", w8, t8)):
            bms, by = bound(wk)
            log("mesh-kernels-2", f"{lc.ny}x{lc.nx} shard of {n}^2/"
                f"{len(disks)} disks prehalo={mode} {key}: kernel "
                f"{wk['ms']:.4f} ms, plain {wk['plain_ms']:.4f} ms, the same "
                f"kernel without a halo on {lc.ny}x{lc.nx} {t:.4f} ms (CUDA "
                f"events); bound {bms:.4f} ms by {by} ({wk['bytes'] / 1e9:.4f}"
                f" GB, the ring it reads included)")
        log("mesh-kernels-2", f"{dims} shard 0 K6 k=4: force err {ef:.3e} "
            f"of max|F| {fmax:.3e} against the plain version on CPU tensors")
        if dims == (2, 2):
            out["K6"], out["K8"] = w6, w8
    scfg, sdisks = static_bed()
    for dims in ((2, 2), (4, 1)):
        mesh = make_mesh(["cuda"] * (dims[0] * dims[1]), dims)
        sim = Simulation(scfg, sdisks, mesh=mesh)
        wins = sharded_static_solid(sim.cfg, mesh, sim._state)
        parts = _Sharded(sim.cfg, None, mesh, "y", "drift")
        g = torch.Generator(device="cuda").manual_seed(10)
        fs = [f * (1.0 + 0.02 * torch.randn(f.shape, generator=g,
                                             device="cuda"))
              for f in sim._state.f]
        frames = exchange(fs, mesh)
        lc, hx = parts.local_cfg, parts.padx
        w7 = mesh_k7_check(parts, frames[0], wins[0], 0, 4,
                           f"static {n}^2 {dims} shard 0", timed=True)
        f = frames[0][:, 8:8 + lc.ny, hx:hx + lc.nx].contiguous()
        solid = wins[0][:, 8:8 + lc.ny, hx:hx + lc.nx].contiguous()
        a = torch.empty_like(f)
        t7 = cuda_ms(lambda: fused_static.fused_step_imb_static_multi(
            f, solid, lc, 4, a), 10)
        bms, by = bound(w7)
        log("mesh-kernels-2", f"{lc.ny}x{lc.nx} shard of the static {n}^2 "
            f"bed prehalo={parts.mode} K7 k=4: kernel {w7['ms']:.4f} ms, "
            f"plain {w7['plain_ms']:.4f} ms, the same kernel without a halo "
            f"on {lc.ny}x{lc.nx} {t7:.4f} ms (CUDA events); bound "
            f"{bms:.4f} ms by {by} ({w7['bytes'] / 1e9:.4f} GB)")
        if dims == (2, 2):
            out["K7"] = w7
        del sim, wins, frames, fs
    return out


def mesh_kernels_2():
    """Phase 37: the matrix, the identity, the timed shards."""
    mesh_tblock_matrix()
    mesh_identity("float32")
    return mesh_tblock_timed()


def mesh_static_slice(smi: str, dims, steps: int = 400,
                      storage: str = "float32"):
    """The static/4096 scene (4096^2, 4096 fixed disks at rest) through
    Simulation(..., mesh=...) on one card: run(19) against the
    single-device run(19) (f 2e-6, disk x equal; bf16 f within one bf16
    ulp, rtol 1e-2 with atol 1e-6) with its launches (K1 once per shard
    for the solid windows, K7 4 passes of 4 and 3 of 1 per shard), then
    run(steps) in pairs with one device. Returns (launch counts of the
    first timed run, median MLUPS, one device's)."""
    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import lbm
    from lbmdem_tpu_torch.parallel import make_mesh

    cfg, disks = static_bed(storage=storage)
    n = dims[0] * dims[1]
    mesh = make_mesh(["cuda"] * n, dims)
    one = Simulation(cfg, disks, device="cuda")
    sh = Simulation(cfg, disks, mesh=mesh)
    assert sh.static_solid
    one.run(19)
    reset_counts()
    sh.run(19)
    c19 = launch_counts()
    a, b = one.state, sh.state
    d = (a.f.float() - b.f.float()).abs()
    ef = float(d.max())
    atol, rtol = (1e-6, 1e-2) if storage == "bfloat16" else (2e-6, 0.0)
    excess = float((d - rtol * a.f.float().abs()).max())
    xeq = torch.equal(a.disks.x, b.disks.x)
    log("mesh-static", f"{cfg.nx}x{cfg.ny} {storage}, {len(disks)} fixed "
        f"disks, {mesh_cards(mesh)}: run(19) against one device: f max err "
        f"{ef:.3e} (bar atol {atol:g} + rtol {rtol:g}; f equal "
        f"{torch.equal(a.f, b.f)}), disk x equal {xeq}; launches {c19}")
    assert excess <= atol and xeq, (ef, xeq)
    assert c19 == {**_NONE, "K1": n, "K7": 7 * n}, c19
    del a, b
    counts, m, o, r = paired_runs(sh, one, steps)
    st = sh.state
    f = lbm.from_storage(st.f, cfg)
    mass_err = abs(float(f.double().sum()) / (cfg.nx * cfg.ny) - 1.0)
    log("mesh-static", f"{storage}: " + paired_line(mesh, m, o, r, steps,
                                                    smi))
    mbar = 1e-4 if storage == "bfloat16" else 1e-5
    log("mesh-static", f"launches of the first timed run({steps}) {counts}; "
        f"overflow {int(st.overflow)}; |sum f/(nx ny) - 1| {mass_err:.3e} "
        f"(bar {mbar:g})")
    assert counts == {**_NONE, "K7": steps // 4 * n}, counts
    assert int(st.overflow) == 0 and bool(torch.isfinite(f).all())
    assert mass_err < mbar, f"mass drift {mass_err}"
    return counts, float(np.median(m)), float(np.median(o))


def mesh_paranoia() -> None:
    """Paranoid mode on a 2 x 2 mesh of one card against one device: a
    128 x 256 channel with a fixed disk at rest, a NaN injected into f
    after step 4 (in shard (1, 1)), run(8): "step" (the per-step sharded
    step, K1 + K2 per shard) reports step 5, "chunk" (the static chunk's
    K7 passes of 4) step 8, each with the state frozen there, as one
    device does."""
    from lbmdem_tpu_torch import DiskSpec, SimConfig, Simulation
    from lbmdem_tpu_torch.parallel import make_mesh
    from lbmdem_tpu_torch.simulation import SimulationDiverged

    for mode, want, kern in ((True, 5, "K2"), ("chunk", 8, "K7")):
        cfg = SimConfig(nx=256, ny=128, tau=0.8, gx=1e-5, paranoia=mode,
                        bc_west="wall", bc_east="wall", out_interval=100)
        got = {}
        for where in ("one", "mesh"):
            kw = (dict(device="cuda") if where == "one" else
                  dict(mesh=make_mesh(["cuda"] * 4, (2, 2))))
            sim = Simulation(cfg, [DiskSpec(40.0, 64.0, 3.0, fixed=True)],
                             **kw)
            sim.run(4)
            assert int(sim.state.fail_step) == -1
            st = sim.state
            st.f[0, 70, 150] = float("nan")
            sim.state = st
            reset_counts()
            try:
                sim.run(8)
                got[where] = None
            except SimulationDiverged as e:
                got[where] = (e.step, int(sim.state.step),
                              int(sim.state.fail_step))
            if where == "mesh":
                counts = launch_counts()
        log("mesh-paranoia", f"paranoia={mode!r}: 2x2 mesh {got['mesh']}, "
            f"one device {got['one']} (fail step, frozen step, fail_step; "
            f"want {want}); mesh launches {counts}")
        assert got["mesh"] == got["one"] == (want, want, want), got
        assert counts[kern] > 0, counts


# --- the lattice mesh III: bf16 storage (16-row frames) -----------------

# the shards of the bf16 matrix checks: corner, edge and interior of a
# 3 x 3 mesh ("yx"); the corner and the middle of a 3 x 1 mesh ("y")
MESH_BF16_SHARDS = {"yx": ((3, 3), (0, 1, 4)), "y": ((3, 1), (0, 1))}
BF16 = dict(f_storage="bfloat16")


def mesh_bf16_matrix() -> None:
    """The five kernels on bf16 frames (16 halo rows, the solid window
    8) against their plain versions: K4 and K5 (k = 1, 2, 4; MESH_EDGES)
    over MESH_MATRIX at a 256 x 128 shard in "y" and "yx" modes; K2 and
    K6 (k = 1, 2, 4, 8) over phase 18's BREADTH_MATRIX and K7 (k = 1, 2,
    4, 8) over phase 10's STATIC_MATRIX on the 256 x 128 shards of
    MESH_BF16_SHARDS. Bars: f' 3e-4, forces 5e-6 of the largest |F|
    (coupled_bars); the plain versions on the card."""
    from lbmdem_tpu_torch import SimConfig

    worst = {"K4": 0.0, "K5": 0.0, "K2": [0.0, 0.0], "K6": [0.0, 0.0],
             "K7": 0.0}
    for i, (label, kw) in enumerate(MESH_MATRIX):
        cfg = SimConfig(**{"nx": 128, "ny": 256, "tau": 0.8,
                           "dtype": "float32", **BF16, **kw})
        for mode in ("y", "yx"):
            w = mesh_fluid_check(cfg, mode, 1, None, 500 + i,
                                 f"{label} {cfg.ny}x{cfg.nx}")
            worst["K4"] = max(worst["K4"], w["err"])
            for j, e in enumerate(MESH_EDGES):
                if mode == "y":  # a "y" shard spans the width
                    e = e[:2] + (1, 1) + e[4:]
                for k in (1, 2, 4):
                    w = mesh_fluid_check(cfg, mode, k, e, 510 + i + j,
                                         f"{label} {cfg.ny}x{cfg.nx}",
                                         k5=True)
                    worst["K5"] = max(worst["K5"], w["err"])
    opts = ([("K6", lb, kw) for lb, kw in BREADTH_MATRIX]
            + [("K7", lb, kw) for lb, kw in STATIC_MATRIX])
    for mode, (dims, shards) in MESH_BF16_SHARDS.items():
        ny, nx = 256 * dims[0], 128 * dims[1]
        disks = mesh_grid_disks(ny, nx, seed=len(mode))
        for i, (kern, label, kw) in enumerate(opts):
            cfg = SimConfig(**{"nx": nx, "ny": ny, "tau": 0.8,
                               "dtype": "float32", **BF16, **kw})
            parts, frames, ins = mesh_coupled_inputs(cfg, disks, dims,
                                                     600 + i)
            assert frames[0].dtype == torch.bfloat16
            for p in shards:
                tag = f"bf16 {label} {mode} shard {p} edges {parts.edges[p]}"
                if kern == "K7":
                    for k in (1, 2, 4, 8):
                        w = mesh_k7_check(parts, frames[p], ins[p][4], p, k,
                                          tag)
                        worst["K7"] = max(worst["K7"], w["err"])
                    continue
                w = mesh_k2_check(parts, frames[p], ins[p], tag)
                worst["K2"][0] = max(worst["K2"][0], w["err"])
                for k in (1, 2, 4, 8):
                    w, ef, _ = mesh_k6_check(parts, frames[p], ins[p], p, k,
                                             tag)
                    worst["K6"] = [max(worst["K6"][0], w["err"]),
                                   max(worst["K6"][1], ef)]
    log("mesh-bf16", f"bf16 frames, plain versions on the card: K4 over "
        f"{len(MESH_MATRIX)} options worst f' err {worst['K4']:.3e}, K5 k=1,"
        f"2,4 x {len(MESH_EDGES)} edge flags {worst['K5']:.3e}; on shards "
        f"{ {m: list(s) for m, (_, s) in MESH_BF16_SHARDS.items()} }: K2 "
        f"{worst['K2'][0]:.3e}, K6 k=1,2,4,8 over {len(BREADTH_MATRIX)} "
        f"options {worst['K6'][0]:.3e} (force err {worst['K6'][1]:.3e} of "
        f"max|F|), K7 k=1,2,4,8 over {len(STATIC_MATRIX)} options "
        f"{worst['K7']:.3e} (bars f' 3e-4, forces 5e-6)")


def mesh_identity(storage: str) -> None:
    """Each pre-haloed kernel against its halo-free kernel on a fully
    periodic lattice whose shard frames are filled from the lattice
    itself (f rows -hy .. h + hy - 1, hy = 8 on f32 and 16 on bf16; the
    solid window's -8 .. h + 7), no edge flags, on a 2 x 2 ("yx") and a
    2 x 1 ("y") mesh of 256 x 128 shards: K4 (on bf16 the one-step body
    on the frame, K5's sweep at k = 1 on the lattice), K5 (k = 1, 2, 4),
    K2 (f' and the shard's partials), K6 (k = 1, 2, 4, 8: f' and
    partials) and K7 (k = 1, 2, 4, 8). The same arithmetic, one rounding
    per pass on bf16: torch.equal, every difference printed and held to
    the bars (f' 5e-6 f32, 3e-4 bf16; partials 1e-6, 5e-6)."""
    from lbmdem_tpu_torch import SimConfig, Simulation
    from lbmdem_tpu_torch.ops import (fused_fluid, fused_lbm, fused_static,
                                      imb, stamp)
    from lbmdem_tpu_torch.ops.fused_fluid import HX, HY

    same, diffs = [], []
    for mode, dims in (("yx", (2, 2)), ("y", (2, 1))):
        ny, nx = 256 * dims[0], 128 * dims[1]
        cfg = SimConfig(nx=nx, ny=ny, tau=0.8, dtype="float32", gx=1e-5,
                        bc_west="periodic", bc_east="periodic",
                        bc_south="periodic", bc_north="periodic",
                        f_storage=storage)
        disks = mesh_grid_disks(ny, nx, seed=8)
        sim = Simulation(cfg, disks, device="cuda")
        cfg, d = sim.cfg, sim.state.disks
        _, aug, _, _, govf = imb.periodic_ghosts(d.x, d.v, d.omega, d.r,
                                                 d.active, cfg)
        td, cnt, _, bovf = stamp.bin_disks_to_tiles(*aug, cfg)
        assert int(govf) == int(bovf) == 0
        solid = stamp.stamp_fields(td, cnt, cfg)
        f = mesh_frame(cfg, "", 41, 0.05)
        h, w = ny // dims[0], nx // dims[1]
        lc = cfg.replace(ny=h, nx=w)
        hy = fused_fluid.frame_hy(lc)
        th, tw = stamp.tile_dims(cfg)
        assert stamp.tile_dims(lc) == (th, tw)
        cap = cfg.tile_cap
        nty, ntx = ny // th, nx // tw
        hx = HX if mode == "yx" else 0
        fcfg = cfg.replace(max_disks=0)
        lfc = fcfg.replace(ny=h, nx=w)
        outs = {}
        for kern, k in ([("K4", 1)] + [("K5", k) for k in (1, 2, 4)]
                        + [("K2", 1)] + [("K6", k) for k in (1, 2, 4, 8)]
                        + [("K7", k) for k in (1, 2, 4, 8)]):
            a = torch.empty_like(f)
            pa = None
            if kern == "K4":
                fused_fluid.fused_step_fluid(f, fcfg, a)
            elif kern == "K5":
                fused_fluid.fused_step_fluid_multi(f, fcfg, k, a)
            elif kern == "K2":
                _, pa = fused_lbm.fused_step_imb_reduce(f, solid, td, cnt,
                                                        cfg, a)
                pa = pa[None]
            elif kern == "K6":
                _, pa = fused_lbm.fused_step_imb_reduce_multi(
                    f, solid, td, cnt, cfg, k, a)
            else:
                fused_static.fused_step_imb_static_multi(f, solid, cfg, k, a)
            outs[kern, k] = (a, None if pa is None
                             else pa.reshape(-1, nty, ntx, cap, 4))
        for iy in range(dims[0]):
            for ix in range(dims[1]):
                cols = (torch.arange(-hx, w + hx, device="cuda") + ix * w) % nx
                frows = (torch.arange(-hy, h + hy, device="cuda") + iy * h) % ny
                srows = (torch.arange(-HY, h + HY, device="cuda") + iy * h) % ny
                fr = f[:, frows][:, :, cols].contiguous()
                sw = solid[:, srows][:, :, cols].contiguous()
                ty, tx = iy * h // th, ix * w // tw
                tiles = (slice(ty, ty + h // th), slice(tx, tx + w // tw))
                td_i = td.reshape(nty, ntx, -1)[tiles].reshape(
                    -1, 1, cap * 8).contiguous()
                cnt_i = cnt.reshape(nty, ntx)[tiles].reshape(
                    -1, 1, 1).contiguous()
                edges = (0, 0, int(mode == "y"), int(mode == "y"), iy * h)
                origin = (iy * h, ix * w)
                for (kern, k), (ref, pa) in outs.items():
                    b = storage_empty(lc, 9, h, w)
                    pb = None
                    if kern == "K4":
                        fused_fluid.fused_step_fluid(fr, lfc, b, prehalo=mode)
                    elif kern == "K5":
                        fused_fluid.fused_step_fluid_multi(
                            fr, lfc, k, b, prehalo=mode, edges=edges,
                            ny_glob=ny)
                    elif kern == "K2":
                        _, pb = fused_lbm.fused_step_imb_reduce(
                            fr, sw, td_i, cnt_i, lc, b, prehalo=mode,
                            origin=origin)
                        pb = pb[None]
                    elif kern == "K6":
                        _, pb = fused_lbm.fused_step_imb_reduce_multi(
                            fr, sw, td_i, cnt_i, lc, k, b, prehalo=mode,
                            origin=origin, edges=edges, ny_glob=ny)
                    else:
                        fused_static.fused_step_imb_static_multi(
                            fr, sw, lc, k, b, prehalo=mode, edges=edges,
                            ny_glob=ny)
                    pairs = [("f'", b, ref[:, iy * h:(iy + 1) * h,
                                           ix * w:(ix + 1) * w])]
                    if pb is not None:
                        pairs.append(("partials", pb, pa[:, tiles[0],
                                                         tiles[1]].reshape(
                                                             pb.shape)))
                    for what, x, y in pairs:
                        eq = torch.equal(x, y)
                        same.append(eq)
                        if not eq:
                            diffs.append((kern, k, what, mode, (iy, ix), float(
                                (x.float() - y.float()).abs().max())))
    log("mesh-identity", f"identity on {storage} frames (fully periodic "
        f"512x256 and 512x128, no edge flags, frames filled from the "
        f"lattice): K4, K5 k=1,2,4, K2, K6 and K7 k=1,2,4,8 against the "
        f"halo-free kernels on the shards' rows: {sum(same)} of "
        f"{len(same)} torch.equal; differences {diffs}")
    fbar, rbar = coupled_bars(cfg)
    for kern, k, what, mode, pos, dmax in diffs:
        assert dmax <= (fbar if what == "f'" else rbar), (kern, k, what,
                                                          mode, pos, dmax)


def mesh_bf16_timed(n: int = 4096):
    """At the 2 x 2 (n/2 square) and 4 x 1 shards of the n^2 scenes in
    bf16: K4 and K5 (k = 4) on the fluid frames, K2 on shard 0 of the
    column collapse (10 000 disks), K6 (k = 4 and 8, the bf16 window's
    coupling_k) on shard 0 of its window scene, K7 (k = 4) on shard 0 of
    the static bed, each against its plain version and timed with CUDA
    events beside the same bf16 kernel without a halo on the shard's
    interior and its bound (the cells it reads: a ring of 1 or k).
    Returns {"K2"|"K4"|"K5"|"K6"|"K7": work} of the 2 x 2 shards."""
    from lbmdem_tpu_torch import SimConfig, Simulation
    from lbmdem_tpu_torch.models import column_collapse
    from lbmdem_tpu_torch.ops import fused_fluid, fused_lbm, fused_static
    from lbmdem_tpu_torch.parallel import make_mesh
    from lbmdem_tpu_torch.parallel._kernel_step import (
        _Sharded, exchange, sharded_static_solid,
    )

    out = {}

    def line(shape, mode, key, wk, t):
        bms, by = bound(wk)
        log("mesh-bf16", f"{shape[0]}x{shape[1]} shard prehalo={mode} bf16 "
            f"{key}: kernel {wk['ms']:.4f} ms, plain {wk['plain_ms']:.4f} ms"
            f", the same bf16 kernel without a halo on {shape[0]}x"
            f"{shape[1]} {t:.4f} ms (CUDA events); bound {bms:.4f} ms by {by}"
            f" ({wk['bytes'] / 1e9:.4f} GB, the halo cells it reads "
            f"included)")

    h = n // 2
    for mode, shape in (("yx", (h, h)), ("y", (n // 4, n))):
        cfg = SimConfig(nx=shape[1], ny=shape[0], tau=0.8, gx=1e-6,
                        dtype="float32", **BF16)
        w4 = mesh_fluid_check(cfg, mode, 1, None, 51, f"{shape}", timed=True,
                              amp=0.02)
        w5 = mesh_fluid_check(cfg, mode, 4, (1, 0, 1, int(mode == "y"), 0),
                              52, f"{shape}", timed=True, amp=0.02)
        f = mesh_frame(cfg, "", 53, 0.02)
        a = torch.empty_like(f)
        t4 = cuda_ms(lambda: fused_fluid.fused_step_fluid(f, cfg, a), 20)
        t5 = cuda_ms(lambda: fused_fluid.fused_step_fluid_multi(f, cfg, 4, a),
                     20)
        line(shape, mode, "K4", w4, t4)
        line(shape, mode, "K5 k=4", w5, t5)
        if mode == "yx":
            out["K4"], out["K5"] = w4, w5
    cfg, disks = column_collapse()
    # the slice (sample: K2) and the window (ramp, coupling_k 8: K6)
    for eps, ks in (("sample", (1,)), ("ramp", (4, 8))):
        ccfg = cfg.replace(f_storage="bfloat16", eps_method=eps)
        for dims in ((2, 2), (4, 1)):
            parts, frames, ins = mesh_coupled_inputs(
                ccfg, compressed(disks, 0.94), dims, 54)
            lc, hx, mode = parts.local_cfg, parts.padx, parts.mode
            shape = (lc.ny, lc.nx)
            _, _, td, cnt, s_k, origin = ins[0]
            assert origin == (0, 0)
            hy = fused_fluid.frame_hy(lc)
            f = frames[0][:, hy:hy + lc.ny, hx:hx + lc.nx].contiguous()
            solid = s_k[:, 8:8 + lc.ny, hx:hx + lc.nx].contiguous()
            a = torch.empty_like(f)
            tag = f"bf16 {eps} {n}^2 {dims} shard 0"
            for k in ks:
                if k == 1:
                    wk = mesh_k2_check(parts, frames[0], ins[0], tag,
                                       timed=True)
                    t = cuda_ms(lambda: fused_lbm.fused_step_imb_reduce(
                        f, solid, td, cnt, lc, a), 20)
                    key = "K2"
                else:
                    wk, ef, fmax = mesh_k6_check(parts, frames[0], ins[0], 0,
                                                 k, tag, timed=True)
                    t = cuda_ms(lambda: fused_lbm.fused_step_imb_reduce_multi(
                        f, solid, td, cnt, lc, k, a), 10)
                    key = f"K6 k={k}"
                    log("mesh-bf16", f"{tag} K6 k={k}: force err {ef:.3e} of "
                        f"max|F| {fmax:.3e}")
                line(shape, mode, f"{eps} {key}", wk, t)
                if dims == (2, 2) and k in (1, 8):
                    out["K2" if k == 1 else "K6"] = wk
            del parts, frames, ins
    scfg, sdisks = static_bed(storage="bfloat16")
    for dims in ((2, 2), (4, 1)):
        mesh = make_mesh(["cuda"] * (dims[0] * dims[1]), dims)
        sim = Simulation(scfg, sdisks, mesh=mesh)
        wins = sharded_static_solid(sim.cfg, mesh, sim._state)
        parts = _Sharded(sim.cfg, None, mesh, "y", "drift")
        g = torch.Generator(device="cuda").manual_seed(55)
        frames = exchange([perturbed(f, sim.cfg, g) for f in sim._state.f],
                          mesh)
        lc, hx = parts.local_cfg, parts.padx
        w7 = mesh_k7_check(parts, frames[0], wins[0], 0, 4,
                           f"bf16 static {n}^2 {dims} shard 0", timed=True)
        f = frames[0][:, 16:16 + lc.ny, hx:hx + lc.nx].contiguous()
        solid = wins[0][:, 8:8 + lc.ny, hx:hx + lc.nx].contiguous()
        a = torch.empty_like(f)
        t7 = cuda_ms(lambda: fused_static.fused_step_imb_static_multi(
            f, solid, lc, 4, a), 10)
        line((lc.ny, lc.nx), parts.mode, "K7 k=4", w7, t7)
        if dims == (2, 2):
            out["K7"] = w7
        del sim, wins, frames
    return out


def mesh_kernels_bf16():
    """Phase 41: the bf16 matrix, the identity, the timed shards."""
    mesh_bf16_matrix()
    mesh_identity("bfloat16")
    return mesh_bf16_timed()


def mesh_cli_bf16(smi: str, steps: int = 24):
    """The user's entry point on a bf16 mesh: examples/column_collapse.par
    with f_storage bfloat16 through `python -m lbmdem_tpu_torch.cli deck
    --mesh 2x2 --steps 24` in this process (the auto path: the kernels on
    the one card's four shards), its launches (mesh_chunk_counts), and
    its step-24 disk state from trajectories.csv against
    Simulation(..., mesh=...).run(24) of the deck, bit for bit. Returns
    the launch counts."""
    import shutil
    import tempfile

    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.parallel import make_mesh

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "examples")
    out = tempfile.mkdtemp(prefix="lbmdem_cli_bf16_")
    try:
        text = open(os.path.join(root, "column_collapse.par")).read()
        text = text.replace("particles column_collapse_disks.txt",
                            "particles " + os.path.join(
                                root, "column_collapse_disks.txt"))
        deck = os.path.join(out, "column_collapse_bf16.par")
        with open(deck, "w") as fh:
            fh.write(text + "f_storage bfloat16\n")
        res = os.path.join(out, "res")
        reset_counts()
        rc, stdout, err, secs = _cli([deck, "--mesh", "2x2", "--steps",
                                      str(steps), "--out", res])
        counts = launch_counts()
        assert rc == 0 and "note:" not in err and "kernels" in err, (rc, err)
        assert counts == mesh_chunk_counts(steps, 1, 4, 1), counts
        rows = np.loadtxt(os.path.join(res, "trajectories.csv"),
                          delimiter=",", skiprows=1, ndmin=2)
        cfg, disks = _deck("column_collapse")
        sim = Simulation(cfg.replace(f_storage="bfloat16"), disks,
                         mesh=make_mesh(["cuda"] * 4, (2, 2)))
        sim.run(steps)
        d = sim.disk_arrays()
        ids = rows[:, 1].astype(np.int64)
        assert (rows[:, 0] == steps).all() and len(ids) == len(disks)
        got = rows[:, 2:].astype(np.float32)
        ref = np.column_stack([d["x"][ids], d["v"][ids], d["theta"][ids],
                               d["omega"][ids]]).astype(np.float32)
        err_d = float(np.abs(got - ref).max())
        log("mesh-bf16-cli", f"column_collapse.par + f_storage bfloat16 "
            f"through the CLI with --mesh 2x2: {rc=}, {steps} steps in "
            f"{secs:.2f} s ({_done_mlups(stdout):.1f} MLUPS, one 4096^2 "
            f"snapshot included) on {smi}; launches {counts}; step-{steps} "
            f"disk state vs Simulation(mesh=2x2).run({steps}): max |diff| "
            f"{err_d:.3e} (bit for bit: {bool(np.array_equal(got, ref))})")
        assert np.array_equal(got, ref), f"CLI != in-process run ({err_d})"
        return counts
    finally:
        shutil.rmtree(out, ignore_errors=True)


# --- the lattice mesh IV: K5 on frames deeper than one sweep, and
# --distributed -----------------------------------------------------------

# K5's depths past one row sweep on a frame, per storage (the frame's
# halo rows bound them)
DEEP_K = {"float32": range(5, 9), "bfloat16": range(5, 17)}


def mesh_deep_matrix() -> None:
    """K5 on frames deeper than one sweep (f32 k = 5-8, bf16 k = 5-16)
    against its plain version on the card, over MESH_MATRIX at the 256 x
    128 shards of MESH_BF16_SHARDS (corner, edge and interior of a 3 x 3
    mesh, "yx"; corner and middle of a 3 x 1 mesh, "y"), each with the
    walls and closures of its global edges and the inlet profile of the
    mesh's 3 shard rows. Bars: fluid_bar's (f32 5e-7 + 1e-5 relative,
    2e-6 with Zou/He; bf16 3e-4)."""
    from lbmdem_tpu_torch import SimConfig

    worst, n = {}, 0
    for storage, ks in DEEP_K.items():
        for i, (label, kw) in enumerate(MESH_MATRIX):
            cfg = SimConfig(**{"nx": 128, "ny": 256, "tau": 0.8,
                               "dtype": "float32", "f_storage": storage,
                               **kw})
            for mode, (dims, shards) in MESH_BF16_SHARDS.items():
                for p in shards:
                    iy, ix = divmod(p, dims[1])
                    e = (int(iy == 0), int(iy == dims[0] - 1), int(ix == 0),
                         int(ix == dims[1] - 1), iy * cfg.ny)
                    for k in ks:
                        w = mesh_fluid_check(cfg, mode, k, e, 700 + 16 * i + k,
                                             f"deep {label} shard {p}",
                                             k5=True, nyg=dims[0] * cfg.ny)
                        worst[storage] = max(worst.get(storage, 0.0),
                                             w["err"])
                        n += 1
    log("mesh-deep", f"K5 on frames deeper than one sweep, plain versions on "
        f"the card: {n} checks over {len(MESH_MATRIX)} options x shards "
        f"{ {m: list(s) for m, (_, s) in MESH_BF16_SHARDS.items()} }: f32 "
        f"k=5..8 worst err {worst['float32']:.3e} (bar 5e-7 + 1e-5 rel, "
        f"2e-6 Zou/He), bf16 k=5..16 {worst['bfloat16']:.3e} (bar 3e-4)")


def mesh_identity_deep(storage: str) -> None:
    """K5 on frames deeper than one sweep (DEEP_K) against the halo-free
    K5(k) on a fully periodic lattice whose shard frames are filled from
    the lattice itself (mesh_identity's construction), on a 2 x 2 ("yx")
    and a 2 x 1 ("y") mesh of 256 x 128 shards: the same sweeps over the
    same cells, one rounding per pass on bf16, so torch.equal on every
    case."""
    from lbmdem_tpu_torch import SimConfig
    from lbmdem_tpu_torch.ops import fused_fluid
    from lbmdem_tpu_torch.ops.fused_fluid import HX

    same, diffs = 0, []
    for mode, dims in (("yx", (2, 2)), ("y", (2, 1))):
        ny, nx = 256 * dims[0], 128 * dims[1]
        cfg = SimConfig(nx=nx, ny=ny, tau=0.8, dtype="float32", gx=1e-5,
                        bc_west="periodic", bc_east="periodic",
                        bc_south="periodic", bc_north="periodic",
                        f_storage=storage)
        f = mesh_frame(cfg, "", 43, 0.05)
        h, w = ny // dims[0], nx // dims[1]
        lc = cfg.replace(ny=h, nx=w)
        hy, hx = fused_fluid.frame_hy(lc), HX if mode == "yx" else 0
        for k in DEEP_K[storage]:
            ref = torch.empty_like(f)
            fused_fluid.fused_step_fluid_multi(f, cfg, k, ref)
            for iy in range(dims[0]):
                for ix in range(dims[1]):
                    cols = (torch.arange(-hx, w + hx, device="cuda")
                            + ix * w) % nx
                    rows = (torch.arange(-hy, h + hy, device="cuda")
                            + iy * h) % ny
                    fr = f[:, rows][:, :, cols].contiguous()
                    b = storage_empty(lc, 9, h, w)
                    fused_fluid.fused_step_fluid_multi(
                        fr, lc, k, b, prehalo=mode,
                        edges=(0, 0, int(mode == "y"), int(mode == "y"),
                               iy * h), ny_glob=ny)
                    y = ref[:, iy * h:(iy + 1) * h, ix * w:(ix + 1) * w]
                    if torch.equal(b, y):
                        same += 1
                    else:
                        diffs.append((k, mode, (iy, ix), float(
                            (b.float() - y.float()).abs().max())))
    log("mesh-identity", f"identity on {storage} frames deeper than one "
        f"sweep (fully periodic 512x256 and 512x128, frames filled from the "
        f"lattice): K5 k={DEEP_K[storage].start}..{DEEP_K[storage].stop - 1}"
        f" against the halo-free K5(k) on the shards' rows: {same} of "
        f"{same + len(diffs)} torch.equal; differences {diffs}")
    assert not diffs, diffs


def mesh_deep_timed(n: int = 4096):
    """f32 K5 k = 8 and bf16 k = 16 on frames at the 2 x 2 shard of the
    n^2 fluid (n/2 square plus halos) and the 4 x 1 one, against their
    plain versions, timed with CUDA events beside the halo-free K5(k) on
    the shard's interior, with their bounds (the interior and the ring of
    k it reads, read once, the interior written once; k steps of
    FLOPS_FLUID per interior cell: no scratch traffic). Returns
    {storage: work} of the 2 x 2 shards."""
    from lbmdem_tpu_torch import SimConfig
    from lbmdem_tpu_torch.ops import fused_fluid

    out = {}
    h = n // 2
    for storage, k in (("float32", 8), ("bfloat16", 16)):
        for mode, shape in (("yx", (h, h)), ("y", (n // 4, n))):
            cfg = SimConfig(nx=shape[1], ny=shape[0], tau=0.8, gx=1e-6,
                            dtype="float32", f_storage=storage)
            wk = mesh_fluid_check(cfg, mode, k, (1, 0, 1, int(mode == "y"),
                                                 0), 61, f"{shape}",
                                  timed=True, amp=0.02)
            f = mesh_frame(cfg, "", 62, 0.02)
            a = torch.empty_like(f)
            t = cuda_ms(lambda: fused_fluid.fused_step_fluid_multi(
                f, cfg, k, a), 20)
            bms, by = bound(wk)
            log("mesh-deep", f"{shape[0]}x{shape[1]} shard prehalo={mode} "
                f"{storage} K5 k={k}: kernel {wk['ms']:.4f} ms, plain "
                f"{wk['plain_ms']:.4f} ms, the same kernel without a halo on "
                f"{shape[0]}x{shape[1]} {t:.4f} ms ({wk['ms'] / t:.4f}x; CUDA "
                f"events); bound {bms:.4f} ms by {by} "
                f"({wk['bytes'] / 1e9:.4f} GB, {wk['flops'] / 1e9:.2f} "
                f"GFLOP)")
            if mode == "yx":
                out[storage] = wk
            del f, a
    return out


def mesh_kernels_deep():
    """Phase 47: the deep-frame matrix, the identities, the timed
    shards."""
    mesh_deep_matrix()
    for storage in DEEP_K:
        mesh_identity_deep(storage)
    return mesh_deep_timed()


def mesh_fluid_deep(smi: str, storage: str, k: int, n: int = 4096,
                    calls: int = 50):
    """n^2 pure fluid (bench.py's fluid/4096 stages) on a 2 x 2 mesh of
    the one card through make_sharded_step(..., True, temporal_k=k), one
    exchange per k steps: f after 2 calls equal (torch.equal) to one
    device's 2 passes of K5(k) (f32: K5(k) is k chained K4 steps bit for
    bit, so also one device's run), then `calls` calls timed in turns
    with the mesh's own run (K5 at TEMPORAL_K) and one device's run of
    as many steps: mesh k, mesh run, one, one, mesh run, mesh k, mesh k,
    mesh run, one. Returns (launch counts of the first timed mesh-k
    calls, median MLUPS)."""
    from lbmdem_tpu_torch import SimConfig, Simulation
    from lbmdem_tpu_torch.parallel import make_mesh, make_sharded_step
    from lbmdem_tpu_torch.simulation import make_step_fn

    cfg = SimConfig(nx=n, ny=n, tau=0.8, gx=1e-6, dtype="float32",
                    out_interval=10**9, f_storage=storage)
    mesh = make_mesh(["cuda"] * 4, (2, 2))
    one = Simulation(cfg, device="cuda")
    sh = Simulation(cfg, mesh=mesh)
    step1 = make_step_fn(one.cfg, None, temporal_k=k)
    stepm = make_sharded_step(sh.cfg, None, mesh, True, temporal_k=k)
    for _ in range(2):
        one._advance(step1)
        sh._advance(stepm)
    a, b = one.state.f, sh.state.f
    eq = torch.equal(a, b)
    err = float((a.float() - b.float()).abs().max())
    log("mesh-deep-fluid", f"{n}x{n} {storage}, {mesh_cards(mesh)}, "
        f"make_sharded_step(temporal_k={k}): 2 calls ({2 * k} steps) against "
        f"one device's 2 passes of K5({k}): f equal {eq} (max err "
        f"{err:.3e})")
    assert eq, err
    del a, b
    steps = calls * k

    def mesh_k():
        for _ in range(calls):
            sh._advance(stepm)
        sh._sync()

    reads = {"mesh k": [], "mesh run": [], "one": []}
    counts = None
    for who in ("mesh k", "mesh run", "one", "one", "mesh run", "mesh k",
                "mesh k", "mesh run", "one"):
        if who == "mesh k" and counts is None:
            reset_counts()
        t0 = time.perf_counter()
        if who == "mesh k":
            mesh_k()
        else:
            (sh if who == "mesh run" else one).run(steps)
        reads[who].append(n * n * steps / (time.perf_counter() - t0) / 1e6)
        if counts is None:
            counts = launch_counts()
    ratio = [m / o for m, o in zip(reads["mesh k"], reads["one"])]
    ratio4 = [m / o for m, o in zip(reads["mesh run"], reads["one"])]
    log("mesh-deep-fluid", f"{storage}: {steps} steps per run, in turns "
        f"(mesh k, mesh run, one, one, mesh run, mesh k, mesh k, mesh run, "
        f"one), wall clock: mesh at temporal_k={k} {reads['mesh k']} MLUPS, "
        f"the mesh's run (K5 at k=4) {reads['mesh run']} MLUPS, one device's "
        f"run {reads['one']} MLUPS; mesh k={k} / one per turn "
        f"{[round(x, 4) for x in ratio]} (median "
        f"{float(np.median(ratio)):.4f}x), mesh run / one "
        f"{[round(x, 4) for x in ratio4]} (median "
        f"{float(np.median(ratio4)):.4f}x) on {smi}; launches of the first "
        f"mesh-k run {counts}")
    assert counts == {**_NONE, "K5": 4 * calls}, counts
    assert bool(torch.isfinite(sh.state.f.float()).all()), "non-finite f"
    return counts, float(np.median(reads["mesh k"]))


def _file_rows(path):
    """A metrics.csv's rows without the wall-clock MLUPS column."""
    import csv

    with open(path, newline="") as fh:
        return [{k: v for k, v in row.items() if k != "mlups"}
                for row in csv.DictReader(fh)]


def mesh_cli_distributed(smi: str, steps: int = 24):
    """--distributed on the card: `python -m lbmdem_tpu_torch.cli
    examples/column_collapse.par --distributed --mesh 2x2 --steps 24` in a
    subprocess started as torchrun starts a rank (RANK 0, WORLD_SIZE 1,
    MASTER_ADDR 127.0.0.1, a free MASTER_PORT, LOCAL_RANK 0: one NCCL
    rank, whose four shards share the card), against the one-process
    `--mesh 2x2` run of the deck in this process: the rank's line on
    stderr, the kernel path, and every output file byte for byte
    (metrics.csv row for row but for its MLUPS column: the disk state of
    trajectories.csv bit for bit); the MLUPS of both."""
    import shutil
    import socket
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    deck = os.path.join(root, "examples", "column_collapse.par")
    out = tempfile.mkdtemp(prefix="lbmdem_cli_dist_")
    try:
        one, two = os.path.join(out, "one"), os.path.join(out, "rank")
        rc, stdout, err, secs = _cli([deck, "--mesh", "2x2", "--steps",
                                      str(steps), "--out", one])
        assert rc == 0 and "note:" not in err and "kernels" in err, (rc, err)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        env = dict(os.environ, RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "lbmdem_tpu_torch.cli",
                            deck, "--distributed", "--mesh", "2x2",
                            "--steps", str(steps), "--out", two],
                           capture_output=True, text=True, env=env,
                           cwd=root, timeout=600)
        rsecs = time.perf_counter() - t0
        for line in (r.stdout + r.stderr).splitlines():
            log("cli-dist", f"  | {line}")
        assert r.returncode == 0, r.stderr[-3000:]
        want = "distributed: process 0/1, 1 local / 1 global devices"
        assert want in r.stderr and "kernels" in r.stderr, r.stderr
        names = sorted(os.listdir(one))
        assert names == sorted(os.listdir(two)), (names, os.listdir(two))
        assert "trajectories.csv" in names
        for name in names:
            a, b = os.path.join(one, name), os.path.join(two, name)
            if name == "metrics.csv":
                assert _file_rows(a) == _file_rows(b), name
            else:
                with open(a, "rb") as fa, open(b, "rb") as fb:
                    assert fa.read() == fb.read(), name
        log("mesh-cli-dist", f"column_collapse.par through the CLI with "
            f"--distributed --mesh 2x2 (one NCCL rank, a subprocess: "
            f"{rsecs:.1f} s with its start, its build load and the process "
            f"group) against --mesh 2x2 in this process: files {names} equal "
            f"(metrics.csv but for MLUPS); {steps} steps, one 4096^2 snapshot "
            f"included: rank {_done_mlups(r.stdout):.1f} MLUPS, one process "
            f"{_done_mlups(stdout):.1f} MLUPS on {smi}")
    finally:
        shutil.rmtree(out, ignore_errors=True)


def _brief(res) -> str:
    """A leg's result in one line: its scalars (the path is logged
    apart)."""
    if isinstance(res, dict):
        return ", ".join(f"{k} {v:.6g}" if isinstance(v, float) else
                         f"{k} {v}" for k, v in res.items() if k != "path")
    return str(res)


def validation_legs(smi: str) -> None:
    """Phase 50: the port's validation and study tools on the card, each
    with its own gates (a failed gate raises): the kernels each leg's
    path names must have launched in its run (the plain path's cylinder
    none), and its seconds. The trt leg runs on K5 and logs both
    errors and their ratio (its gates: TRT < 2e-4, BGK > 50 x TRT)."""
    from lbmdem_tpu_torch.tools import (ab_bf16, benchmark_cylinder,
                                        collapse_study, validate)

    def cylinder():
        cd, cl = benchmark_cylinder.main(["--steps", "2000"])
        assert np.isfinite(cd) and np.isfinite(cl), (cd, cl)
        return {"cd": cd, "cl": cl}

    def trt():
        res = validate.trt("cuda")
        return {**res, "bgk / trt": res["bgk"] / res["trt"]}

    def collapse_tiny():
        results = collapse_study.main(["--tiny"])
        return {f"a={r['aspect']:.2f}": (f"dL/L0 {r['runout']:.3f}, "
                                         f"{r['steps']} steps, settled "
                                         f"{r['settled']}")
                for r in results}

    coupled = ("K1", "K2", "K3", "KL")
    legs = [
        ("settling", coupled, lambda: validate.settling("cuda")),
        ("dkt", coupled, lambda: validate.dkt("cuda")),
        ("dktlit", coupled, lambda: validate.dkt_literature("cuda")),
        ("periodic", coupled, lambda: validate.periodic("cuda")),
        ("cavity", ("K5",), lambda: validate.cavity("cuda")),
        ("trt", ("K5",), trt),
        ("friction", ("K3", "KL"), lambda: validate.friction("cuda")),
        ("static", ("K7",), lambda: validate.static_multi("cuda")),
        ("collapse_study --tiny", coupled, collapse_tiny),
        ("benchmark_cylinder --steps 2000", (), cylinder),
        ("ab_bf16 parity_probe", ("K4",),
         lambda: {"max_abs_diff": ab_bf16.parity_probe("cuda")}),
        ("ab_bf16 settling_parity", coupled,
         lambda: {"deviation": ab_bf16.settling_parity("cuda")}),
    ]
    t_all = time.perf_counter()
    for name, want, fn in legs:
        reset_counts()
        t0 = time.perf_counter()
        res = fn()
        secs = time.perf_counter() - t0
        ran = {k: v for k, v in launch_counts().items() if v}
        path = res.get("path", "") if isinstance(res, dict) else ""
        log("validation", f"{name}: {secs:.1f} s on {smi}; {path}; launches "
            f"{ran}; {_brief(res)}")
        missing = [k for k in want if k not in ran]
        assert not missing, f"{name}: {missing} never launched ({ran})"
        assert want or not ran, f"{name}: the plain path launched {ran}"
    log("validation", f"{len(legs)} legs in "
        f"{time.perf_counter() - t_all:.1f} s on {smi}")


# the TRT options of phase 18's matrix: TRT, TRT + LES, and all at once
# (TRT, LES, lambda, Guo, a moving lid, Zou/He)
TRT_MATRIX = [(lb, kw) for lb, kw in BREADTH_MATRIX
              if kw.get("collision") == "trt"]


def trt_case(name: str, run, plain, cfg, es=None, equal=None) -> float:
    """One TRT instantiation against its plain version on the same card
    inputs: run(out) and plain(out) each return (out, extra), extra the
    partials (k, n, 4) of K2/K6 or K8's (phi_x, phi_y), or None. Bars:
    coupled_bars (f'; forces of the partials relative to the largest
    |F|), K8's phi 1e-6. f32 cases also log torch.equal of f' (and the
    extra) into `equal`. Returns the f' max err."""
    from lbmdem_tpu_torch.ops import stamp

    fbar, rbar = coupled_bars(cfg)
    a, ea = run()
    b, eb = plain()
    torch.cuda.synchronize()
    err = float((a.float() - b.float()).abs().max())
    msg = f"f' max err {err:.3e} (bar {fbar:g})"
    same = torch.equal(a, b)
    if isinstance(ea, tuple):  # K8's phi
        ephi = max(float((x - y).abs().max()) for x, y in zip(ea, eb))
        same = same and all(torch.equal(x, y) for x, y in zip(ea, eb))
        msg += f", phi {ephi:.3e} (bar 1e-6)"
        assert ephi <= 1e-6, f"{name}: phi err {ephi}"
    elif ea is not None:
        rel = 0.0
        for t in range(ea.shape[0] if ea.dim() == 3 else 1):
            pk, pp = (ea[t], eb[t]) if ea.dim() == 3 else (ea, eb)
            F, _ = stamp.gather_partials(pk, es, torch.float32)
            Fp, _ = stamp.gather_partials(pp, es, torch.float32)
            rel = max(rel, float((F - Fp).abs().max())
                      / max(float(Fp.abs().max()), 1e-30))
        same = same and torch.equal(ea, eb)
        msg += f", forces {rel:.3e} of max|F| (bar {rbar:g})"
        assert rel <= rbar, f"{name}: force err {rel}"
    if equal is not None and cfg.f_storage == "float32":
        equal.append(same)
    log("trt", f"{name}: {msg}; torch.equal {same}")
    assert bool(torch.isfinite(a.float()).all()), f"{name}: non-finite"
    assert err <= fbar, f"{name}: f' err {err}"
    return err


def trt_pair_form(smi: str):
    """Phase 51: the coupled kernels' TRT instantiations, which collide in
    the pair form of the TPU kernels (csrc/imb.cuh collide_cell_pairs),
    against their plain versions (fused_fluid.collide_imb_pairs) on the
    same card inputs: K2, K6 (k = 4), K7 (k = 4) and K8 (f32) over
    TRT_MATRIX at 256x64, f32 and bf16; on pre-haloed shards of 2 x 2
    ("yx") and 4 x 1 ("y") meshes of a 512^2 column under TRT + LES, K2,
    K6 and K7 (k = 4) and K8 (f32); then the trt leg's deck through K7 and
    K6 over an empty solid (validate.trt_coupled: TRT and BGK Poiseuille
    errors and their ratio, gates < 2e-4 and > 50x), a 256^2 TRT column
    on the card against CPU tensors (K2's path), K8 + K9 per step under
    TRT (the ablation's split step), and K2, K6, K7 and K8 under TRT at
    4096^2 beside their plain versions on the card, timed. Returns
    ({name: work}, {name: launches of the path that ran it})."""
    from lbmdem_tpu_torch import SimConfig, Simulation, lattice
    from lbmdem_tpu_torch.config import window_for_radius
    from lbmdem_tpu_torch.models import column_collapse
    from lbmdem_tpu_torch.ops import fused_lbm, fused_static, lbm, stamp
    from lbmdem_tpu_torch.tools import ablate, validate

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    x = torch.tensor([[1.2, 20.3], [64.3, 32.1], [128.0, 40.0], [200.5, 60.2],
                      [240.0, 12.7]], device="cuda")
    v = torch.tensor([[0.01, -0.02], [0.0, 0.01], [-0.02, 0.0], [0.01, 0.01],
                      [0.0, -0.01]], device="cuda")
    om = torch.tensor([0.005, -0.003, 0.0, 0.002, 0.001], device="cuda")
    r = torch.tensor([4.0, 4.0, 3.0, 5.0, 3.5], device="cuda")
    act = torch.ones(5, dtype=torch.bool, device="cuda")
    rng = np.random.default_rng(51)
    f0 = torch.as_tensor(lattice.W[:, None, None] * (
        1.0 + 0.05 * rng.standard_normal((9, 64, 256))), dtype=torch.float32,
        device="cuda")
    equal = []
    for label, kw in TRT_MATRIX:
        for storage in ("float32", "bfloat16"):
            cfg = SimConfig(**{"nx": 256, "ny": 64, "tau": 0.8,
                               "dtype": "float32", "max_disks": 5,
                               "window": window_for_radius(5.0),
                               "tile_cap": 8, "f_storage": storage, **kw})
            td, cnt, es, ovf = stamp.bin_disks_to_tiles(x, v, om, r, act, cfg)
            assert int(ovf) == 0
            solid = stamp.stamp_fields(td, cnt, cfg)
            if cfg.bc_west == "inlet":
                solid[:, :, 0].zero_()
                solid[:, :, -1].zero_()
            f = lbm.to_storage(f0, cfg)
            a, b = torch.empty_like(f), torch.empty_like(f)
            tag = f"{label} {storage} 256x64"
            trt_case(f"{tag} K2", lambda: fused_lbm.fused_step_imb_reduce(
                f, solid, td, cnt, cfg, a),
                lambda: fused_lbm.fused_step_imb_reduce_plain(
                    f, solid, td, cnt, cfg, b), cfg, es, equal)
            trt_case(f"{tag} K6 k=4", lambda: fused_lbm.
                     fused_step_imb_reduce_multi(f, solid, td, cnt, cfg, 4, a),
                     lambda: fused_lbm.fused_step_imb_reduce_multi_plain(
                         f, solid, td, cnt, cfg, 4, b), cfg, es, equal)
            trt_case(f"{tag} K7 k=4", lambda: (
                fused_static.fused_step_imb_static_multi(f, solid, cfg, 4, a),
                None), lambda: (fused_static.fused_step_imb_static_multi_plain(
                    f, solid, cfg, 4, b), None), cfg, None, equal)
            if storage == "float32":
                trt_case(f"{tag} K8", lambda: (lambda o: (o[0], o[1:]))(
                    fused_lbm.fused_step_imb(f, solid[0], solid[1], solid[2],
                                             cfg, a)),
                    lambda: (lambda o: (o[0], o[1:]))(
                        fused_lbm.fused_step_imb_plain(
                            f, solid[0], solid[1], solid[2], cfg, b)),
                    cfg, None, equal)
    log("trt", f"halo-free TRT instantiations: {sum(equal)} of {len(equal)} "
        f"f32 cases equal their plain versions under torch.equal")
    # pre-haloed shards under TRT + LES (phases 37 and 41 run the whole
    # option matrices)
    opts = dict(collision="trt", smagorinsky=0.16, gx=1e-5)
    for storage in ("float32", "bfloat16"):
        for dims in ((2, 2), (4, 1)):
            cfg = SimConfig(nx=512, ny=512, tau=0.8, dtype="float32",
                            f_storage=storage, **opts)
            disks = mesh_grid_disks(512, 512, seed=5)
            parts, frames, ins = mesh_coupled_inputs(cfg, disks, dims, 51)
            tag = f"trt+les {storage} prehalo {dims} shard 0"
            mesh_k2_check(parts, frames[0], ins[0], tag)
            mesh_k6_check(parts, frames[0], ins[0], 0, 4, tag)
            mesh_k7_check(parts, frames[0], ins[0][4], 0, 4, tag)
            if storage == "float32":
                mesh_k8_check(parts, frames[0], ins[0][4], tag)
    launches = {}
    # the trt leg's deck through K7 and K6
    for kern, key in (("K7", "K7"), ("K6", "K6")):
        res = validate.trt_coupled("cuda", kern)
        launches[kern] = res["launches"]["trt"]
        log("trt", f"trt deck through {res['path']}: TRT {res['trt']:.6e}, "
            f"BGK {res['bgk']:.6e}, BGK / TRT {res['bgk'] / res['trt']:.1f}x "
            f"(gates < 2e-4 and > 50x); {kern} launches under TRT "
            f"{res['launches']['trt']}")
    # K2 under TRT on a coupled run: the 256^2 column on the card against
    # CPU tensors
    n0 = fused_lbm.fused_step_imb_reduce.launches
    slice_vs_cpu(collision="trt")
    launches["K2"] = fused_lbm.fused_step_imb_reduce.launches - n0
    # K8 (+ K9) per step under TRT: the ablation's split step
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    asim = Simulation(cfg.replace(collision="trt", out_interval=10**9),
                      disks, device="cuda")
    reset_counts()
    row = ablate.run_variants(asim, 8, names=["full"],
                              log=lambda m: log("trt", m))["full"]
    launches["K8"] = launch_counts()["K8"]
    assert row["launches"].get("K8") == 1.0, row
    # timed at 4096^2: K2, K6 (k = 4), K8 on the packed column, K7 (k = 4)
    # on the static bed
    out = {}
    ccfg, cdisks = column_collapse()
    csim = Simulation(ccfg.replace(collision="trt"), compressed(cdisks, 0.94),
                      device="cuda")
    c = csim.cfg
    d = csim.state.disks
    vel = torch.as_tensor(rng.uniform(-0.02, 0.02, (d.x.shape[0], 2)),
                          dtype=torch.float32, device="cuda")
    td, cnt, es, ovf = stamp.bin_disks_to_tiles(d.x, vel, d.omega, d.r,
                                                d.active, c)
    assert int(ovf) == 0
    solid = stamp.stamp_fields(td, cnt, c)
    f = lbm.init_equilibrium(c, "cuda") * (1.0 + 0.02 * torch.randn(
        (9, c.ny, c.nx), generator=torch.Generator(device="cuda").manual_seed(
            51), device="cuda"))
    a, b = torch.empty_like(f), torch.empty_like(f)
    cov = cov_flops_of(c, cnt)
    cases = [
        ("K2", lambda: fused_lbm.fused_step_imb_reduce(
            f, solid, td, cnt, c, a), lambda: fused_lbm.
         fused_step_imb_reduce_plain(f, solid, td, cnt, c, b), es,
         nt_flops(solid) + cov),
        ("K6", lambda: fused_lbm.fused_step_imb_reduce_multi(
            f, solid, td, cnt, c, 4, a), lambda: fused_lbm.
         fused_step_imb_reduce_multi_plain(f, solid, td, cnt, c, 4, b), es,
         4 * (nt_flops(solid) + cov)),
        ("K8", lambda: (lambda o: (o[0], o[1:]))(fused_lbm.fused_step_imb(
            f, solid[0], solid[1], solid[2], c, a)),
         lambda: (lambda o: (o[0], o[1:]))(fused_lbm.fused_step_imb_plain(
             f, solid[0], solid[1], solid[2], c, b)), None, nt_flops(solid))]
    for name, run, plain, ees, flops in cases:
        err = trt_case(f"4096x4096 TRT {name}", run, plain, c, ees)
        _, extra = run()
        moved = nbytes(f, solid, a) + (
            nbytes(td, cnt, extra) if ees is not None else nbytes(*extra))
        out[name] = work(err, cuda_ms(run, 10), cuda_ms(plain, 1), moved,
                         flops)
    del csim, solid, td, cnt, f, a, b
    bsim = Simulation(*static_bed(), device="cuda")
    bsolid = bsim._static_solid_operands()
    bc = bsim.cfg.replace(collision="trt")
    gen = torch.Generator(device="cuda").manual_seed(52)
    f = lbm.init_equilibrium(bc, "cuda") * (1.0 + 0.02 * torch.randn(
        (9, bc.ny, bc.nx), generator=gen, device="cuda"))
    a, b = torch.empty_like(f), torch.empty_like(f)
    run = lambda: (fused_static.fused_step_imb_static_multi(  # noqa: E731
        f, bsolid, bc, 4, a), None)
    plain = lambda: (fused_static.fused_step_imb_static_multi_plain(  # noqa
        f, bsolid, bc, 4, b), None)
    err = trt_case("4096x4096 static bed TRT K7 k=4", run, plain, bc)
    out["K7"] = work(err, cuda_ms(run, 10), cuda_ms(plain, 1),
                     nbytes(f, bsolid, a), 4 * nt_flops(bsolid))
    for name, w in out.items():
        bms, by = bound(w)
        log("trt", f"4096x4096 TRT {name}: kernel {w['ms']:.4f} ms, plain "
            f"{w['plain_ms']:.4f} ms (CUDA events); bound {bms:.4f} ms by "
            f"{by}; launches of its path under TRT {launches[name]}")
    return out, launches


def k6_on_run(f, solid, td, cnt, es, cfg, label: str, fa, fb) -> dict:
    """K6 (k = 4) on a run's f32 state: equal to 4 chained K2 steps (f'
    and every inner step's partials) under torch.equal, and beside its
    plain version on the card (f' 2e-5: the plain version on the card
    multiplies by 1/tau), timed. Returns {"K6 k=4": work(...), "forces4":
    the inner steps' (F, T)}."""
    from lbmdem_tpu_torch.ops import fused_lbm, stamp

    k = 4
    a = torch.empty_like(f)
    run6 = lambda: fused_lbm.fused_step_imb_reduce_multi(  # noqa: E731
        f, solid, td, cnt, cfg, k, a)
    _, pk = run6()
    last, p2 = chained(k2_step(solid, td, cnt, cfg), k, f, fa, fb)
    same = [torch.equal(a, last)] + [torch.equal(pk[t], p2[t])
                                     for t in range(k)]
    assert all(same), f"K6 {label}: K6(4) != 4 x K2 {same}"
    b = torch.empty_like(f)
    plain = lambda: fused_lbm.fused_step_imb_reduce_multi_plain(  # noqa
        f, solid, td, cnt, cfg, k, b)
    plain()
    err = float((a - b).abs().max())
    assert err <= 2e-5, f"K6 {label}: f' err {err} against the plain version"
    ms, pms = cuda_ms(run6, 10), cuda_ms(plain, 1)
    log("kernels", f"{label} K6 k=4: equal to 4 chained K2 steps (f' and "
        f"every inner step's partials, torch.equal); f' max err {err:.3e} "
        f"against the plain version on the card (bar 2e-5); kernel "
        f"{ms:.4f} ms, plain {pms:.4f} ms (CUDA events)")
    return {"K6 k=4": work(err, ms, pms, nbytes(f, solid, td, cnt, a, pk),
                           k * (nt_flops(solid) + cov_flops_of(cfg, cnt))),
            "forces4": [stamp.gather_partials(pk[t], es, torch.float32)
                        for t in range(k)]}


# bench.py's 8192^2 / 40 000-disk stages (bench.py:274-283): coupling_k,
# f_storage, eps_method, chunk (a multiple of the binning cadence)
TIER_STAGES = ((1, "float32", "sample", 50), (4, "float32", "sample", 48),
               (1, "bfloat16", "ramp", 50), (8, "bfloat16", "ramp", 48))
# the first row and column past the column's occupied bands (its 40 000
# disks fill x <= 1 789 and y <= 5 464): the partial-writes region
TIER_FREE = (5600, 1900)


def tier_counts(k: int, chunk: int) -> dict:
    """The launches of run(chunk) at coupling_k k: K1, K2, K3 and KL per
    step; at k > 1 K1, K6 and KL per window, K3w per inner step."""
    if k == 1:
        return {**_NONE, "K1": chunk, "K2": chunk, "K3": chunk, "KL": chunk}
    return {**_NONE, "K1": chunk // k, "K6": chunk // k, "K3w": chunk,
            "KL": chunk // k}


def tier_stage(smi: str, k: int, storage: str, eps: str, chunk: int):
    """One 8192^2 stage (qualify_8192.make_sim): run(chunk) cold, then
    run(chunk) timed (wall clock; CUDA events around it), the profiler's
    device time over one more run(chunk) where it keeps records, the
    launches of the timed run, peak memory, and qualify_8192's state
    checks (overflow 0, finite, no zero population, mass). Returns (sim,
    launch counts, MLUPS)."""
    from lbmdem_tpu_torch.ops import slab_dem
    from lbmdem_tpu_torch.tools import qualify_8192 as q

    tag = f"8192 {storage} {eps} k={k}"
    t0 = time.perf_counter()
    sim = q.make_sim(k=k, storage=storage, eps=eps)
    log(tag, f"{q.describe_slab(sim)}; {len(sim.state.disks.x)} disk slots,"
        f" made in {time.perf_counter() - t0:.1f} s")
    assert slab_dem.slab_supported(sim.grid, sim.dem_axis, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sim.run(chunk)
    cold = time.perf_counter() - t0
    reset_counts()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    mlups = sim.run(chunk)
    b.record()
    torch.cuda.synchronize()
    counts = launch_counts()
    ev = a.elapsed_time(b) / chunk
    dev_ms, wall_ms, _ = device_profile(sim, chunk)
    log(tag, f"{mlups:.1f} MLUPS (timed run({chunk}) after a cold one of "
        f"{cold:.2f} s; wall {1e3 * q.N * q.N / mlups / 1e6:.4f} ms per "
        f"step) on {smi}; CUDA events {ev:.4f} ms per step of the timed run "
        f"(the stream's span); "
        + idle_str(dev_ms, wall_ms, f"the profiled run({chunk})")
        + f"; peak mem {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(tag, f"launches of the timed run {counts}")
    assert counts == tier_counts(k, chunk), counts
    q.check_state(sim, lambda m: log(tag, m))
    return sim, counts, mlups


def tier_vs_plain(k: int, steps: int = 16) -> None:
    """`steps` steps of the f32 8192^2 stage at coupling_k k through the
    kernels against the same steps without them, on the card: k = 1 the
    plain path (Simulation(use_kernels=False): make_plain_step_fn), k > 1
    the window with K1, K6, K3w and KL swapped for their plain versions
    (the plain path takes no window). Bars of the card-against-CPU runs:
    f 1e-5, disk x 1e-4, over the whole lattice and over the rows and
    columns past the occupied bands (the partial-writes check)."""
    from unittest import mock

    from lbmdem_tpu_torch import Simulation
    from lbmdem_tpu_torch.ops import fused_lbm, slab_dem, stamp
    from lbmdem_tpu_torch.tools import qualify_8192 as q

    tag = f"8192 vs plain k={k}"
    g = q.make_sim(k=k)
    reset_counts()
    g.run(steps)
    assert launch_counts() == tier_counts(k, steps), launch_counts()
    fk, xk = g.state.f, g.state.disks.x
    del g
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if k == 1:
        p = Simulation(*q.scene(), device="cuda", use_kernels=False)
        what = "the plain path (make_plain_step_fn)"
        reset_counts()
        p.run(steps)
    else:
        p = q.make_sim(k=k)
        what = "the window with K1, K6, K3w and KL plain"
        reset_counts()  # the wrappers' counts, before they are swapped
        with mock.patch.object(stamp, "stamp_fields",
                               stamp.stamp_fields_plain), \
                mock.patch.object(
                    fused_lbm, "fused_step_imb_reduce_multi",
                    fused_lbm.fused_step_imb_reduce_multi_plain), \
                mock.patch.object(
                    slab_dem, "subcycle_slabs_window",
                    lambda sl, f3, kmax, n_occ, bands, grid, cfg, axis:
                    slab_dem.subcycle_slabs_plain(sl, kmax, cfg, grid, axis,
                                                  f3)), \
                mock.patch.object(
                    slab_dem, "leftover_verlet",
                    lambda new, slot, ovf, forces, body_f, grid, cfg, axis:
                    slab_dem.leftover_verlet_plain(new, slot, ovf, forces,
                                                   body_f, cfg)):
            p.run(steps)
    secs = time.perf_counter() - t0
    assert launch_counts() == _NONE, f"{what} launched {launch_counts()}"
    d = (fk - p.state.f).abs()
    err = float(d.max())
    free = max(float(d[:, TIER_FREE[0]:, :].max()),
               float(d[:, :, TIER_FREE[1]:].max()))
    ex = float((xk - p.state.disks.x).abs().max())
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(tag, f"{steps} steps, kernels against {what} on the card "
        f"({secs:.1f} s, peak mem {peak:.2f} GiB): f max err {err:.3e} "
        f"(bar 1e-5), past the occupied bands "
        f"(y >= {TIER_FREE[0]} or x >= {TIER_FREE[1]}) {free:.3e}; disk x "
        f"max err {ex:.3e} (bar 1e-4); overflow {int(p.state.overflow)}")
    assert err <= 1e-5 and free <= 1e-5 and ex <= 1e-4
    assert int(p.state.overflow) == 0


def k6_bf16_on_run(sim) -> dict:
    """bf16 K6 (k = 8) on the bf16 ramp window stage's f and disk
    positions (the disks with kernel_checks' seeded velocities: the force
    bar is relative to the largest |F|) against its plain version on the
    card: f' 3e-4, every inner step's forces 5e-6 of the window's largest
    |F|; timed. Returns work(...)."""
    from lbmdem_tpu_torch.ops import fused_lbm, stamp

    cfg, d, f = sim.cfg, sim.state.disks, sim.state.f
    k = cfg.coupling_k
    rng = np.random.default_rng(0)
    n = d.x.shape[0]
    v = torch.as_tensor(rng.uniform(-0.02, 0.02, (n, 2)), dtype=torch.float32,
                        device=d.x.device)
    om = torch.as_tensor(rng.uniform(-2e-3, 2e-3, n), dtype=torch.float32,
                         device=d.x.device)
    td, cnt, es, ovf = stamp.bin_disks_to_tiles(d.x, v, om, d.r, d.active,
                                                cfg)
    assert int(ovf) == 0
    solid = stamp.stamp_fields(td, cnt, cfg)
    a, b = torch.empty_like(f), torch.empty_like(f)
    run = lambda: fused_lbm.fused_step_imb_reduce_multi(  # noqa: E731
        f, solid, td, cnt, cfg, k, a)
    plain = lambda: fused_lbm.fused_step_imb_reduce_multi_plain(  # noqa
        f, solid, td, cnt, cfg, k, b)
    _, pk = run()
    _, pp = plain()
    err = float((a.float() - b.float()).abs().max())
    ferr, fmax, step_rel = 0.0, 0.0, 0.0
    for t in range(k):
        F, _ = stamp.gather_partials(pk[t], es, torch.float32)
        Fp, _ = stamp.gather_partials(pp[t], es, torch.float32)
        e, m = float((F - Fp).abs().max()), float(Fp.abs().max())
        ferr, fmax = max(ferr, e), max(fmax, m)
        step_rel = max(step_rel, e / max(m, 1e-30))
    rel = ferr / max(fmax, 1e-30)
    ms, pms = cuda_ms(run, 10), cuda_ms(plain, 1)
    log("kernels", f"8192^2 bf16 ramp window state: K6 k={k} f' max err "
        f"{err:.3e} (bar 3e-4), inner-step force err {ferr:.3e} = {rel:.3e} "
        f"of the window's max|F| {fmax:.3e} (bar 5e-6; of each step's own "
        f"max|F| up to {step_rel:.3e}: the seeded motion's first inner step "
        f"carries ten times the later ones' forces, and the plain version on "
        f"the card multiplies by 1/tau); kernel {ms:.4f} ms, plain "
        f"{pms:.4f} ms (CUDA events)")
    assert err <= 3e-4 and rel <= 5e-6, (err, rel)
    return work(err, ms, pms, nbytes(f, solid, td, cnt, a, pk),
                k * (nt_flops(solid) + cov_flops_of(cfg, cnt)))


def leftover_on_run(sim) -> dict:
    """The leftover fallback kernel (KL) at the main path's shape, on the
    f32 k = 1 8192^2 stage's disks: one active disk in 64 planted without
    a slot (overflow > 0; the run itself never overflows) under seeded
    hydro forces handed as views of (N, 4) rows, as the reduction leaves
    them; one step and a k = 4 window against the chained plain
    _fallback_integrate on the card under torch.equal, moving the planted
    disks and no other; both timed with the planted overflow, and once
    with none (the cells' early exit), by CUDA events over back-to-back
    calls (the wrapper's host time paces those) and by the profiler's
    device time, which the kernel row takes where the profiler kept
    device records. Operations: the wall tests (9 per
    enabled wall, a contact more) and force sums (5) of n_sub + 1 force
    evaluations and 24 per Verlet substep, per planted disk and step.
    Returns {"KL": work, "KL k=4": work}."""
    from lbmdem_tpu_torch.ops import dem, slab_dem

    cfg, grid, axis, d = sim.cfg, sim.grid, sim.dem_axis, sim.state.disks
    n = d.x.shape[0]
    body_f = dem.body_forces(d, cfg)
    slot, ovf0 = slab_dem.build_slabs(d, None, None, body_f, grid, axis,
                                      kt=cfg.kt > 0.0,
                                      bake_forces=False)[1:3]
    assert int(ovf0) == 0, f"the run's state overflows: {int(ovf0)}"
    planted = torch.nonzero(d.active).flatten()[::64]
    slot = slot.clone()
    slot[planted] = -1
    leftover = d.active & (slot < 0)
    m = int(leftover.sum())
    ovf = torch.sum(leftover).to(torch.int32)
    rng = np.random.default_rng(11)
    rows = torch.as_tensor(rng.uniform(-1e-3, 1e-3, (4, n, 4)),
                           dtype=torch.float32, device=d.x.device)
    rows[:, :, 2] *= 0.1
    walls = sum(slab_dem._dem_params(cfg, grid, axis).wall_on)
    out = {}
    for k in (1, 4):
        forces = [(rows[t, :, :2], rows[t, :, 2]) for t in range(k)]
        p = d
        for fh, th in forces:
            p = slab_dem._fallback_integrate(p, leftover, fh, th, body_f, cfg)
        want = slab_dem._merge(leftover, p, d)

        def fresh():
            return d._replace(x=d.x.clone(), v=d.v.clone(),
                              omega=d.omega.clone(), theta=d.theta.clone())

        got = slab_dem.leftover_verlet(fresh(), slot, ovf, forces, body_f,
                                       grid, cfg, axis)
        equal = all(torch.equal(getattr(got, f), getattr(want, f))
                    for f in ("x", "v", "omega", "theta"))
        err = max(float((getattr(got, f) - getattr(want, f)).abs().max())
                  for f in ("x", "v", "omega", "theta"))
        moved = (got.x != d.x).any(dim=1) | (got.omega != d.omega)
        tgt = fresh()
        ms = cuda_ms(lambda: slab_dem.leftover_verlet(
            tgt, slot, ovf, forces, body_f, grid, cfg, axis), 20)
        zero = torch.zeros_like(ovf)
        ms0 = cuda_ms(lambda: slab_dem.leftover_verlet(
            tgt, slot, zero, forces, body_f, grid, cfg, axis), 20)
        dev = kernel_device_ms(lambda: slab_dem.leftover_verlet(
            tgt, slot, ovf, forces, body_f, grid, cfg, axis))
        dev0 = kernel_device_ms(lambda: slab_dem.leftover_verlet(
            tgt, slot, zero, forces, body_f, grid, cfg, axis))

        def plain():
            q = d
            for fh, th in forces:
                q = slab_dem._fallback_integrate(q, leftover, fh, th, body_f,
                                                 cfg)
            return slab_dem._merge(leftover, q, d)

        pms = cuda_ms(plain, 3)
        log("kernels", f"8192^2 leftover fallback (KL) k={k}: {n} disk "
            f"slots, {m} planted without a slot (overflow {int(ovf)}), "
            f"n_sub {cfg.n_sub}, {walls} walls: equal to {k} chained "
            f"_fallback_integrate {equal} (max err {err:.3e}); moved "
            f"{int(moved.sum())} disks, all planted "
            f"{bool(moved[leftover & d.mobile].all())}, none other "
            f"{not bool(moved[~leftover].any())}; kernel {ms:.4f} ms, at "
            f"overflow 0 {ms0:.4f} ms, plain {pms:.4f} ms (CUDA events); "
            f"device time {dev_str(dev)}, at overflow 0 {dev_str(dev0)}")
        assert equal, f"KL k={k}: max err {err}"
        assert bool(moved[leftover & d.mobile].all())
        assert not bool(moved[~leftover].any())
        # all threads read active and slot; a planted disk its state
        # (read and written), masses, body force and each step's forces
        moved_b = n * 5 + m * (1 + 12 + 8 + 2 * 24) + m * k * 12
        flops = m * k * ((cfg.n_sub + 1) * (9 * walls + 5)
                         + 24 * cfg.n_sub)
        ms = dev.get("leftover_verlet_kernel", ms)
        out["KL" if k == 1 else "KL k=4"] = work(err, ms, pms, moved_b,
                                                 flops)
    return out


def tier_8192(smi: str):
    """Phase 52: bench.py's four 8192^2 / 40 000-disk stages through
    qualify_8192/qualify_k8's functions (tier_stage); on the f32 k = 1
    stage's state K1, K2, K3 and K3w against their plain versions and
    K6(4) equal to 4 chained K2 steps (kernel_checks on the run), and the
    leftover fallback kernel with planted overflow (leftover_on_run), on the
    bf16 k = 8 stage's state bf16 K6(8) against its plain version; then
    the f32 k = 1 and k = 4 runs against the plain path on the card
    (tier_vs_plain). Returns (the kernels' work, the stages' launch
    counts)."""
    counts, res = {}, {}
    for k, storage, eps, chunk in TIER_STAGES:
        sim, c, _ = tier_stage(smi, k, storage, eps, chunk)
        counts[(k, storage)] = c
        if (k, storage) == (1, "float32"):
            res.update(kernel_checks(sim.cfg, None, "8192x8192/40000 disks "
                                     "(the run's state)", True, sim=sim))
            res.update(leftover_on_run(sim))
        elif (k, storage) == (8, "bfloat16"):
            res["K6 bf16 k=8"] = k6_bf16_on_run(sim)
        del sim
        torch.cuda.empty_cache()
    for k in (1, 4):
        tier_vs_plain(k)
    for name, w in res.items():
        bms, by = bound(w)
        log("kernels", f"8192^2 {name}: kernel {w['ms']:.4f} ms, plain "
            f"{w['plain_ms']:.4f} ms (CUDA events); bound {bms:.4f} ms by "
            f"{by} ({w['bytes'] / 1e9:.4f} GB, {w['flops'] / 1e9:.3f} GFLOP)")
    return res, counts


def timed_phase(label: str, fn, *args):
    """fn(*args), logging the phase's seconds."""
    t0 = time.perf_counter()
    res = fn(*args)
    log("phase-seconds", f"{label}: {time.perf_counter() - t0:.1f} s")
    return res


def main() -> int:
    smi = probe()
    build()
    from lbmdem_tpu_torch.models import column_collapse

    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    kernel_checks(cfg, compressed(disks, 0.94),
                  f"{cfg.nx}x{cfg.ny}/{len(disks)} disks", timed=False)
    coverage_sweep()
    boundary_matrix()
    tblock_identities()
    split_matrix()
    split_checks(cfg, compressed(disks, 0.94),
                 f"{cfg.nx}x{cfg.ny}/{len(disks)} disks", timed=False)
    cfg, disks = column_collapse()
    res = kernel_checks(cfg, compressed(disks, 0.94),
                        f"{cfg.nx}x{cfg.ny}/{len(disks)} disks", timed=True)
    redesign_timed(cfg, compressed(disks, 0.94),
                   f"{cfg.nx}x{cfg.ny}/{len(disks)} disks")
    tblock_timed(cfg, compressed(disks, 0.94),
                 f"{cfg.nx}x{cfg.ny}/{len(disks)} disks")
    k3_timed(cfg, compressed(disks, 0.94),
             f"{cfg.nx}x{cfg.ny}/{len(disks)} disks")
    res.update(split_checks(cfg, compressed(disks, 0.94),
                            f"{cfg.nx}x{cfg.ny}/{len(disks)} disks",
                            timed=True))
    counts, mlups1 = slice_run(smi)
    _, mlups_r, rsim = slice_run(smi, eps_method="ramp", keep=True)
    log("ramp-slice", f"eps_method=ramp {mlups_r:.1f} MLUPS vs sample "
        f"{mlups1:.1f} MLUPS in this call ({mlups_r / mlups1:.3f}x)")
    split_on_run_state(rsim)
    del rsim
    slice_vs_cpu()
    slice_vs_cpu(eps_method="ramp")
    wcounts, mlups4, wsim = slice_run(smi, coupling_k=4, keep=True)
    tblock_on_run_state(wsim)
    del wsim
    log("window-slice", f"coupling_k=4 {mlups4:.1f} MLUPS vs coupling_k=1 "
        f"{mlups1:.1f} MLUPS in this call ({mlups4 / mlups1:.3f}x)")
    slice_vs_cpu(coupling_k=4, steps=19)
    coupling_k_settling()
    res.update(fluid_kernels())
    k5_identities()
    k5_timed()
    fcounts, _ = fluid_slice(smi, "float32")
    fluid_slice(smi, "bfloat16")
    poiseuille_check()
    fluid_vs_cpu()
    res.update(static_kernels())
    scounts, _ = static_slice(smi, "float32")
    static_slice(smi, "bfloat16")
    ghosts_vs_cpu()
    drift_vs_cpu()
    breadth_matrix()
    cfg, disks = column_collapse(nx=256, ny=256, n_disks=60)
    dem_breadth_checks(cfg, compressed(disks, 0.94),
                       f"{cfg.nx}x{cfg.ny}/{len(disks)} disks", timed=False)
    cfg, disks = column_collapse()
    label = f"{cfg.nx}x{cfg.ny}/{len(disks)} disks"
    new = breadth_timed(cfg, compressed(disks, 0.94), label)
    new.update(dem_breadth_checks(cfg, compressed(disks, 0.94), label,
                                  timed=True))
    bcounts, mlups_b, bsim = slice_run(smi, storage="bfloat16", keep=True)
    split_on_run_state(bsim)
    del bsim
    bwcounts, mlups_bw, bwsim = slice_run(smi, coupling_k=4,
                                          storage="bfloat16", keep=True)
    tblock_on_run_state(bwsim)
    del bwsim
    log("bfloat16-slice", f"f_storage=bfloat16 {mlups_b:.1f} MLUPS (k=1), "
        f"{mlups_bw:.1f} MLUPS (k=4) vs float32 {mlups1:.1f} and "
        f"{mlups4:.1f} MLUPS in this call ({mlups_b / mlups1:.3f}x, "
        f"{mlups_bw / mlups4:.3f}x)")
    slice_vs_cpu(storage="bfloat16")
    slice_vs_cpu(coupling_k=4, steps=19, storage="bfloat16")
    slice_vs_cpu(kt=25.0)
    slice_vs_cpu(coupling_k=4, steps=19, kt=25.0)
    kt_slice(smi)
    open_counts = open_channel_vs_cpu()
    dcounts, dwcounts, pcounts = decks_vs_cpu(smi)
    acounts = ablation(1)
    ablation(4)
    ablation(1, chunk=10, storage="bfloat16")
    cli_full_width(smi)
    checkpoint_on_card()
    plain_path_on_card(smi)
    paranoia_on_card()
    mres = mesh_kernels()
    mcounts, _, _ = mesh_slice(smi, (2, 2))
    mesh_slice(smi, (4, 1))
    mfcounts, _ = mesh_fluid(smi)
    if torch.cuda.device_count() >= 4:
        cards = [f"cuda:{i}" for i in range(4)]
        mesh_slice(smi, (2, 2), cards)
        mesh_fluid(smi, (2, 2), cards)
    else:
        log("mesh-placement", f"{torch.cuda.device_count()} card(s): every "
            f"mesh phase put all its shards on cuda:0 (distinct cards need "
            f"4)")
    mres2 = timed_phase("37 mesh kernels II", mesh_kernels_2)
    wmcounts, _, _ = timed_phase("38 mesh window 2x2", mesh_slice, smi,
                                 (2, 2), None, "float32", "sample", 4)
    timed_phase("38 mesh window 4x1", mesh_slice, smi, (4, 1), None,
                "float32", "sample", 4)
    smcounts, _, _ = timed_phase("39 mesh static 2x2", mesh_static_slice,
                                 smi, (2, 2))
    timed_phase("39 mesh static 4x1", mesh_static_slice, smi, (4, 1))
    timed_phase("40 mesh paranoia", mesh_paranoia)
    mres3 = timed_phase("41 mesh kernels bf16", mesh_kernels_bf16)
    bmcounts, _, _ = timed_phase("42 mesh bf16 slice 2x2", mesh_slice, smi,
                                 (2, 2), None, "bfloat16")
    timed_phase("42 mesh bf16 slice 4x1", mesh_slice, smi, (4, 1), None,
                "bfloat16")
    bwmcounts, _, _ = timed_phase("43 mesh bf16 window 2x2", mesh_slice,
                                  smi, (2, 2), None, "bfloat16", "ramp", 8)
    timed_phase("43 mesh bf16 window 4x1", mesh_slice, smi, (4, 1), None,
                "bfloat16", "ramp", 8)
    bfmcounts, _ = timed_phase("44 mesh bf16 fluid", mesh_fluid, smi, (2, 2),
                               None, 4096, "bfloat16")
    bsmcounts, _, _ = timed_phase("45 mesh bf16 static", mesh_static_slice,
                                  smi, (2, 2), 400, "bfloat16")
    timed_phase("46 mesh bf16 CLI", mesh_cli_bf16, smi)
    mres4 = timed_phase("47 mesh deep K5", mesh_kernels_deep)
    deep8, _ = timed_phase("48 mesh fluid k=8", mesh_fluid_deep, smi,
                           "float32", 8)
    deep16, _ = timed_phase("48 mesh bf16 fluid k=16", mesh_fluid_deep, smi,
                            "bfloat16", 16, 4096, 25)
    timed_phase("49 distributed CLI", mesh_cli_distributed, smi)
    timed_phase("50 validation legs", validation_legs, smi)
    tres, tlaunch = timed_phase("51 TRT pair form", trt_pair_form, smi)
    res8, counts8 = timed_phase("52 8192^2 tier", tier_8192, smi)
    counts.update({k: acounts[k] for k in ("K8", "K9")})
    counts.update({k: fcounts[k] for k in ("K4", "K5")})
    counts.update({k: wcounts[k] for k in ("K6", "K3w")})
    counts["K7"] = scounts["K7"]
    res["K6"] = res["K6 k=4"]
    meta = {
        "K1": ("stamp", "lbmdem_tpu_torch/csrc/stamp.cu",
               "lbmdem_tpu/ops/pallas_stamp.py:270"),
        "K2": ("imb_reduce", "lbmdem_tpu_torch/csrc/imb_reduce.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:1048"),
        "K3": ("slab_dem", "lbmdem_tpu_torch/csrc/slab_dem.cu",
               "lbmdem_tpu/ops/pallas_dem.py:313"),
        "K4": ("fluid_step", "lbmdem_tpu_torch/csrc/fluid.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:585"),
        "K5": ("fluid_multi", "lbmdem_tpu_torch/csrc/fluid.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:780"),
        "K6": ("imb_reduce_multi", "lbmdem_tpu_torch/csrc/imb_multi.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:1257"),
        "K3w": ("slab_dem_window", "lbmdem_tpu_torch/csrc/slab_dem.cu",
                "lbmdem_tpu/ops/pallas_dem.py:313"),
        "K7": ("imb_static_multi", "lbmdem_tpu_torch/csrc/imb_static.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:911"),
        "K8": ("imb_split_step", "lbmdem_tpu_torch/csrc/imb_split.cu",
               "lbmdem_tpu/ops/pallas_lbm.py:1469"),
        "K9": ("reduce_hydro", "lbmdem_tpu_torch/csrc/imb_split.cu",
               "lbmdem_tpu/ops/pallas_stamp.py:474"),
        # the leftover fallback: an XLA loop in the JAX package, no
        # pallas_call; on the card a kernel that reads overflow itself
        "KL": ("leftover_verlet", "lbmdem_tpu_torch/csrc/slab_dem.cu",
               "lbmdem_tpu/ops/pallas_dem.py:939"),
    }
    k8_mesh = wmcounts["K8"] + smcounts["K8"]
    assert k8_mesh == 0, f"a mesh path launched K8 {k8_mesh} times"
    # the new instantiations: (base kernel, tag, work, launches of the
    # path that ran it)
    extra = [("K2", "bf16", new["K2 bf16"], bcounts["K2"]),
             ("K6", "bf16", new["K6 bf16"], bwcounts["K6"]),
             ("K2", "trt+les", new["K2 f32 trt+les"], open_counts["K2"]),
             ("K3", "kt", new["K3 kt"], dcounts["K3"]),
             ("K3w", "kt", new["K3w kt"], dwcounts["K3w"]),
             ("K3", "periodic", new["K3 periodic"], pcounts["K3"]),
             ("K2", "prehalo yx", mres["K2"], mcounts["K2"]),
             ("K4", "prehalo yx", mres["K4"], mfcounts["K4"]),
             ("K5", "prehalo yx", mres["K5"], mfcounts["K5"]),
             ("K6", "prehalo yx", mres2["K6"], wmcounts["K6"]),
             ("K7", "prehalo yx", mres2["K7"], smcounts["K7"]),
             # no path runs K8 on a frame (the JAX package's neither):
             # the mesh paths' runs read none
             ("K8", "prehalo yx", mres2["K8"], k8_mesh),
             ("K2", "bf16 prehalo yx", mres3["K2"], bmcounts["K2"]),
             ("K4", "bf16 prehalo yx", mres3["K4"], bfmcounts["K4"]),
             ("K5", "bf16 prehalo yx", mres3["K5"], bfmcounts["K5"]),
             ("K6", "bf16 prehalo yx", mres3["K6"], bwmcounts["K6"]),
             ("K7", "bf16 prehalo yx", mres3["K7"], bsmcounts["K7"]),
             # K5 on frames deeper than one sweep: the mesh fluid at
             # temporal_k 8 (f32) and 16 (bf16)
             ("K5", "prehalo yx k=8", mres4["float32"], deep8["K5"]),
             ("K5", "bf16 prehalo yx k=16", mres4["bfloat16"],
              deep16["K5"]),
             # the TRT instantiations (the pair-form collide): launches of
             # the trt deck (K6, K7), the 256^2 TRT column (K2) and the
             # ablation's split step (K8) under TRT
             ("K2", "trt", tres["K2"], tlaunch["K2"]),
             ("K6", "trt", tres["K6"], tlaunch["K6"]),
             ("K7", "trt", tres["K7"], tlaunch["K7"]),
             ("K8", "trt", tres["K8"], tlaunch["K8"]),
             # the 8192^2 / 40 000-disk stages: launches of each stage's
             # timed run
             ("K1", "8192", res8["K1"], counts8[(1, "float32")]["K1"]),
             ("K2", "8192", res8["K2"], counts8[(1, "float32")]["K2"]),
             ("K3", "8192", res8["K3"], counts8[(1, "float32")]["K3"]),
             ("K6", "8192 k=4", res8["K6 k=4"],
              counts8[(4, "float32")]["K6"]),
             ("K3w", "8192", res8["K3w"], counts8[(4, "float32")]["K3w"]),
             ("K6", "8192 bf16 k=8", res8["K6 bf16 k=8"],
              counts8[(8, "bfloat16")]["K6"]),
             # the leftover fallback with planted overflow on the f32
             # k = 1 stage's disks: launches of the k = 1 and k = 4 stages
             ("KL", "8192", res8["KL"], counts8[(1, "float32")]["KL"]),
             ("KL", "8192 k=4", res8["KL k=4"],
              counts8[(4, "float32")]["KL"])]
    kernels = []
    rows = [(k, "", res[k], counts[k]) for k in (
        "K1", "K2", "K3", "K4", "K5", "K6", "K3w", "K7", "K8", "K9")] + extra
    for k, tag, w, launches in rows:
        bms, by = bound(w)
        # no single PyTorch call computes any of these functions
        kernels.append({
            "name": meta[k][0] + (f"[{tag}]" if tag else ""), "route": "cuda",
            "source": meta[k][1], "replaces": meta[k][2],
            "launches": launches,
            "max_abs_err": w["err"], "ms": w["ms"], "plain_ms": w["plain_ms"],
            "bound_ms": bms, "bound_by": by, "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
