"""ctypes bindings for the native C++ snapshot writer, as the JAX
package's `lbmdem_tpu/utils/native.py`.

`lbmdem_tpu_torch/native/snapshot.cc` (a copy of the JAX package's)
builds with g++ on first use into `native/libsnapshot.so` (git-ignored;
rebuilt when the source is newer). Without a toolchain the callers take
the pure-Python writers of `utils/io_vtk.py`, which write the same
bytes, slower.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "native", "snapshot.cc")
_LIB = os.path.join(_HERE, "..", "native", "libsnapshot.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> bool:
    """Compile into a file of this process, then rename it into place:
    processes that build at once never load a half-written library."""
    tmp = f"{_LIB}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-o", tmp, _SRC],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded native library, building it if needed; None if the
    toolchain is unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if (not os.path.exists(_LIB)
                or os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        f32p = ctypes.POINTER(ctypes.c_float)
        f64p = ctypes.POINTER(ctypes.c_double)
        lib.write_fluid_vtk.argtypes = [
            ctypes.c_char_p, ctypes.c_int32, ctypes.c_int32,
            f32p, f32p, f32p, f32p,
        ]
        lib.write_fluid_vtk.restype = ctypes.c_int
        lib.append_particle_csv.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            f64p, f64p, f64p, f64p,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int32,
        ]
        lib.append_particle_csv.restype = ctypes.c_int
        _lib = lib
        return _lib


def write_fluid_vtk(path: str, rho, ux, uy, eps=None) -> bool:
    """Native binary VTK write. Returns False if unavailable/failed
    (caller falls back to Python)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    ny, nx = rho.shape
    f32 = lambda a: np.ascontiguousarray(a, dtype=np.float32)
    rho32, ux32, uy32 = f32(rho), f32(ux), f32(uy)
    pt = ctypes.POINTER(ctypes.c_float)
    eps32 = f32(eps) if eps is not None else None
    rc = lib.write_fluid_vtk(
        path.encode(), ny, nx,
        rho32.ctypes.data_as(pt), ux32.ctypes.data_as(pt),
        uy32.ctypes.data_as(pt),
        eps32.ctypes.data_as(pt) if eps32 is not None else pt(),
    )
    return rc == 0


def append_particle_csv(path: str, step: int, disks: dict) -> bool:
    """Native trajectory-CSV append. Returns False if unavailable/failed
    (caller falls back to Python)."""
    import numpy as np

    lib = get_lib()
    if lib is None:
        return False
    x = np.ascontiguousarray(disks["x"], np.float64)
    v = np.ascontiguousarray(disks["v"], np.float64)
    th = np.ascontiguousarray(disks["theta"], np.float64)
    om = np.ascontiguousarray(disks["omega"], np.float64)
    act = np.ascontiguousarray(disks["active"], np.uint8)
    header = 0 if os.path.exists(path) else 1
    pd = ctypes.POINTER(ctypes.c_double)
    rc = lib.append_particle_csv(
        path.encode(), step, x.shape[0],
        x.ctypes.data_as(pd), v.ctypes.data_as(pd),
        th.ctypes.data_as(pd), om.ctypes.data_as(pd),
        act.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), header,
    )
    return rc == 0
