"""Build and load the hand-written CUDA kernels of `csrc/`.

The sources are compiled with nvcc into one shared library with a plain
C interface (no PyTorch headers, so a build takes seconds), cached in
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
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "_build"
SOURCES = ("stamp.cu", "imb_reduce.cu", "slab_dem.cu")
HEADERS = ("coverage.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_D = ctypes.c_double


class LbmParams(ctypes.Structure):
    """Scalars of the coupled collide-stream step (K2); mirrors
    `struct LbmParams` in csrc/imb_reduce.cu field for field."""

    _fields_ = [
        ("tau", _F), ("tm", _F), ("half_gx", _F), ("half_gy", _F),
        ("gx", _F), ("gy", _F), ("guo_pref", _F), ("eps_min", _F),
        ("forced", _I), ("walls", _I),
        ("uw_west", _D), ("uw_east", _D), ("uw_south", _D),
        ("uw_north", _D), ("rho0", _D),
    ]


class DemParams(ctypes.Structure):
    """Scalars of the slab DEM subcycle (K3); mirrors `struct
    DemParams` in csrc/slab_dem.cu field for field."""

    _fields_ = [
        ("kn", _F), ("gn", _F), ("gt", _F), ("mu", _F),
        ("h", _F), ("half_h", _F),
        ("wall_pos", _F * 4), ("wall_on", _I * 4),
    ]


# C signatures: (name, argtypes)
_SIGNATURES = {
    "lbm_stamp": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    "lbm_imb_step": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                     _I, _I, _I, _F, LbmParams, _P],
    "lbm_dem_subcycle": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                         _I, DemParams, _P],
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
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               *[str(CSRC / s) for s in SOURCES]]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n"
                f"{res.stdout}\n{res.stderr}")
        os.replace(tmp, so)
        built = time.perf_counter() - t0
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
    lib.build_seconds = built
    return lib


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
