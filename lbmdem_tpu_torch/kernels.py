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
HEADERS = ("coverage.cuh", "d2q9.cuh", "imb.cuh")
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


# C signatures: (name, argtypes)
_SIGNATURES = {
    "lbm_stamp": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _I,
                  _P],
    "lbm_imb_step": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _F, _I, _I, _I, FluidParams, _F, _F, _P],
    "lbm_imb_multi": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                      _I, _I, _I, _F, _I, _I, _I, _I, FluidParams, _F, _F,
                      _P],
    "lbm_dem_subcycle": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, DemParams, _P],
    "lbm_dem_subcycle_window": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _I, DemParams, _P],
    "lbm_fluid_step": [_P, _P, _P, _I, _I, _I, FluidParams, _P],
    "lbm_fluid_multi": [_P, _P, _P, _I, _I, _I, _I, FluidParams, _P],
    "lbm_imb_static_multi": [_P, _P, _P, _P, _I, _I, _I, _I, _I,
                             FluidParams, _F, _P],
    "lbm_imb_split_step": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           FluidParams, _F, _P],
    "lbm_reduce_hydro": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _I, _F, _F, _I, _P],
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


def stream() -> int:
    """Handle of PyTorch's current CUDA stream, for the C launchers."""
    return torch.cuda.current_stream().cuda_stream


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
