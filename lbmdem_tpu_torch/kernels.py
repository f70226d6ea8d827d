"""Build and load the hand-written CUDA kernels of `csrc/`.

Each source is compiled by its own nvcc process, all started together,
and the objects are linked into one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), cached in
`lbmdem_tpu_torch/_build/` under a hash of the sources and flags, and
loaded with ctypes at first use. Every C entry point launches on the
stream it is given and returns `cudaGetLastError()`; `check` raises on
a non-zero code.

`--fmad=false` keeps nvcc from contracting a*b+c into one FMA: the
coverage sample test must agree bitwise with the plain PyTorch version
(a flipped sample is a 1/16 coverage step), and the collide and
contact-law arithmetic then round like the plain versions too.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
SOURCES = ("stamp.cu", "imb_reduce.cu", "imb_multi.cu", "slab_dem.cu",
           "fluid.cu", "imb_static.cu", "imb_split.cu")
HEADERS = ("coverage.cuh", "d2q9.cuh", "imb.cuh", "tblock.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class DemParams(ctypes.Structure):
    """Scalars of the slab DEM subcycle (K3, K3w); mirrors `struct
    DemParams` in csrc/slab_dem.cu field for field."""

    _fields_ = [
        ("kn", _F), ("gn", _F), ("gt", _F), ("mu", _F),
        ("h", _F), ("half_h", _F), ("kt", _F),
        ("wrap_lx", _F), ("wrap_ly", _F),
        ("wall_pos", _F * 4), ("wall_on", _I * 4),
        ("wrap_s", _I), ("wrap_l", _I), ("ncs", _I),
    ]


class LeftoverForces(ctypes.Structure):
    """Device pointers of the leftover fallback's hydro forces (N, 2) and
    torques (N,), one pair per inner step of a launch (at most 8), and
    their row strides in floats; mirrors `struct LeftoverForces` in
    csrc/slab_dem.cu."""

    _fields_ = [("fh", _P * 8), ("th", _P * 8), ("fh_stride", _I),
                ("th_stride", _I)]


class FluidParams(ctypes.Structure):
    """Scalars of the pure-fluid steps (K4/K5) and of the coupled steps
    (K2, K6, K7, K8), those with the NT constant beside it; mirrors
    `struct FluidParams` in csrc/d2q9.cuh field for field."""

    _fields_ = [
        ("tau", _F), ("tau_sq", _F), ("half_gx", _F), ("half_gy", _F),
        ("gx", _F), ("gy", _F), ("guo_pref", _F), ("trt_magic", _F),
        ("trt_hp", _F), ("trt_hm", _F), ("trt_pe", _F), ("trt_po", _F),
        ("les_c", _F), ("rho0", _F), ("rho_out", _F), ("bb", _F * 12),
        ("forced", _I), ("trt", _I), ("les", _I), ("walls", _I),
        ("open", _I),
    ]


class PairParams(ctypes.Structure):
    """The pair-form collide's scalars without LES (K4/K5, and the TRT
    instantiations of K2, K6, K7, K8; from `ops/fused_fluid.pair_consts`);
    mirrors `struct PairParams` in csrc/d2q9.cuh field for field."""

    _fields_ = [
        ("inv_tau", _F), ("inv_tau_m", _F), ("gw", _F * 5), ("eg9", _F * 4),
        ("w3eg", _F * 4), ("godd", _F * 4),
    ]


class CovParams(ctypes.Structure):
    """The coverage method of a launch and the constants of the sample
    method's fast path (ops/stamp.cov_params); mirrors `struct
    CovParams` in csrc/coverage.cuh field for field."""

    _fields_ = [
        ("method", _I), ("ns", _I), ("r_shift", _F), ("full", _F),
        ("half", _F), ("lo", _F), ("hi", _F),
    ]


# C signatures: (name, argtypes)
_SIGNATURES = {
    "lbm_stamp": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, CovParams, _F, _I,
                  _I, _P],
    "lbm_imb_step": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                     _I, _I, _I, _I, CovParams, _I, _I, FluidParams,
                     PairParams, _F, _F, _I, _P],
    "lbm_imb_multi": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                      _I, _I, _I, CovParams, _I, _I, _I, FluidParams,
                      PairParams, _F, _F, _P],
    "lbm_dem_subcycle": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         DemParams, _P],
    "lbm_dem_subcycle_window": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _I, DemParams, _P],
    "lbm_dem_grid": [_I],
    "lbm_dem_leftover": [_P, _P, _P, _P, _P, _P, _P, _P, LeftoverForces, _I,
                         _P, _P, _P, _P, _P, _I, _I, DemParams, _P],
    "lbm_fluid_step": [_P, _P, _P, _I, _I, _I, FluidParams, PairParams, _P],
    "lbm_fluid_multi": [_P, _P, _P, _P, _I, _I, _I, _I, FluidParams,
                        PairParams, _P],
    "lbm_fluid_strip": [_I, _I],
    "lbm_fluid_step_prehalo": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                               FluidParams, PairParams, _P],
    "lbm_fluid_multi_prehalo": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                FluidParams, PairParams, _P],
    "lbm_imb_step_prehalo": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                             _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                             CovParams, _I, _I, FluidParams, PairParams, _F,
                             _F, _I, _P],
    "lbm_imb_multi_prehalo": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, CovParams,
                              _I, _I, _I, FluidParams, PairParams, _F, _F, _P],
    "lbm_imb_multi_strip": [_I, _I],
    "lbm_imb_static_multi": [_P, _P, _P, _P, _I, _I, _I, _I, _I, FluidParams,
                             PairParams, _F, _P],
    "lbm_imb_static_multi_prehalo": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                     _I, FluidParams, PairParams, _F, _P],
    "lbm_imb_static_strip": [_I, _I],
    "lbm_imb_split_step": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           FluidParams, PairParams, _F, _I, _P],
    "lbm_imb_split_step_prehalo": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                   _I, _I, FluidParams, PairParams, _F, _I,
                                   _P],
    "lbm_reduce_hydro": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, CovParams, _F, _P],
}


def nvcc() -> str:
    """Path of nvcc: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "are built from csrc/ at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """Build (if this source hash has no library yet) and load the
    kernels. The seconds the build took are in `library().build_seconds`
    (0.0 when a cached library was loaded)."""
    BUILD.mkdir(parents=True, exist_ok=True)
    so = BUILD / f"liblbmdem_kernels_{_digest()}.so"
    t0 = time.perf_counter()
    built = 0.0
    if not so.exists():
        tag = f"{os.getpid()}.tmp"
        objs = [BUILD / f"{Path(src).stem}.{tag}.o" for src in SOURCES]
        # -Xptxas -v only reports each entry's registers and spills
        jobs = [_run([nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC),
                      "-c", "-o", str(obj), str(CSRC / src)])
                for src, obj in zip(SOURCES, objs)]
        try:
            report = "".join(f"# {src}\n{_wait(cmd, proc)}"
                             for src, (cmd, proc) in zip(SOURCES, jobs))
        finally:
            for _, proc in jobs:
                proc.kill()
        so.with_suffix(".ptxas.txt").write_text(report)
        tmp = so.with_suffix(f".{tag}")
        _wait(*_run([nvcc(), *NVCC_FLAGS, "-shared", "-o", str(tmp),
                     *map(str, objs)]))
        for obj in objs:
            obj.unlink()
        os.replace(tmp, so)
        built = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.build_seconds = built
    return lib


def _run(cmd):
    return cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)


def _wait(cmd, proc) -> str:
    """Wait for an nvcc process; return its stderr (the ptxas report)."""
    out, err = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{out}\n{err}")
    return err


def resources() -> list:
    """Registers and spills of every kernel entry, from the ptxas report
    saved when the loaded library was built: [(source, entry, registers,
    spill store bytes, spill load bytes)], entries demangled when
    c++filt is on PATH."""
    report = BUILD / f"liblbmdem_kernels_{_digest()}.ptxas.txt"
    rows, src, entry, spills = [], None, None, (0, 0)
    for line in report.read_text().splitlines():
        if line.startswith("# "):
            src = line[2:]
        elif m := re.search(r"Compiling entry function '(\S+)'", line):
            entry = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spills = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and entry:
            rows.append((src, entry, int(m.group(1)), *spills))
            entry = None
    filt = shutil.which("c++filt")
    if filt and rows:
        names = subprocess.run([filt], input="\n".join(r[1] for r in rows),
                               capture_output=True, text=True).stdout.split("\n")
        rows = [(r[0], n or r[1], *r[2:]) for r, n in zip(rows, names)]
    return rows


def check(code: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


_settings: dict = {}


def setting(name: str, *args) -> None:
    """Call the library's setter `name` (a strip, a grid cap) with `args`
    unless its last call had the same ones, so a launch makes no ctypes
    call for a setting that did not change; raise on an error code."""
    if _settings.get(name) != args:
        check(getattr(library(), name)(*args), name)
        _settings[name] = args


def stream() -> int:
    """Handle of PyTorch's current CUDA stream, for the C launchers."""
    return torch.cuda.current_stream().cuda_stream


# CUgraphNodeType values of the driver API that are device operations
_GRAPH_OPS = {0: "kernel", 1: "memcpy", 2: "memset"}


def captured_launches(fn) -> dict:
    """The device operations one call of fn() enqueues, counted without
    running them: fn() is captured into a CUDA graph on a side stream
    (relaxed capture mode, so the caching allocator may still allocate)
    and the graph's nodes are counted by type with the driver API.
    fn() must not synchronise with the host. Returns
    {"kernel": n, "memcpy": n, "memset": n}."""
    cu = ctypes.CDLL("libcuda.so.1")

    def drv(code: int, what: str) -> None:
        if code != 0:
            raise RuntimeError(f"{what}: CUDA driver error {code}")

    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    handle = ctypes.c_void_p(side.cuda_stream)
    graph = ctypes.c_void_p()
    with torch.cuda.stream(side):
        drv(cu.cuStreamBeginCapture_v2(handle, 2), "cuStreamBeginCapture")
        try:
            fn()
        finally:
            end = cu.cuStreamEndCapture(handle, ctypes.byref(graph))
    try:
        drv(end, "cuStreamEndCapture")
        n = ctypes.c_size_t()
        drv(cu.cuGraphGetNodes(graph, None, ctypes.byref(n)),
            "cuGraphGetNodes")
        nodes = (ctypes.c_void_p * n.value)()
        drv(cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n)),
            "cuGraphGetNodes")
        counts = dict.fromkeys(_GRAPH_OPS.values(), 0)
        kind = ctypes.c_int()
        for node in nodes:
            drv(cu.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)),
                "cuGraphNodeGetType")
            if kind.value in _GRAPH_OPS:
                counts[_GRAPH_OPS[kind.value]] += 1
        return counts
    finally:
        if graph.value:
            cu.cuGraphDestroy(graph)


def require_cuda_f32(what: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous float32 CUDA tensors (int32 for index
    tables) on one device; raise on anything else."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"{what}: all tensors must be on one CUDA "
                             f"device (got {t.device})")
        if not t.is_contiguous():
            raise ValueError(f"{what}: tensors must be contiguous")
        if t.dtype not in (torch.float32, torch.int32):
            raise ValueError(f"{what}: the CUDA kernel takes float32 "
                             f"(got {t.dtype})")
