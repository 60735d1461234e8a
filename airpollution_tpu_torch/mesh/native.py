"""ctypes bridge to the native C++ edge enumeration, PyTorch counterpart of
``airpollution_tpu/mesh/native.py``.

``native/mesh_topology.cpp`` enumerates CR edges in first-encounter order
(the contract of mesh/topology.py) as one hash-table pass. The library is
built on first use with the host's C++ compiler into ``build/native/
<hash>/`` at the repository root, keyed by a hash of the source and the
flags, and never with ``-march=native``: a checkout may be copied to
another host. ``APT_NATIVE=0`` turns it off; when it is off or cannot be
built, ``enumerate_edges_native`` returns None and mesh/topology.py takes
its numpy path, which gives the same output.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "mesh_topology.cpp"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "native"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")

_LOCK = threading.Lock()
_STATE = {"tried": False, "lib": None, "error": None}


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16] / "libmeshtopo.so"


def _build() -> Path:
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which(os.environ.get("CXX", "c++")) or shutil.which("g++")
    if cxx is None:
        raise FileNotFoundError("no C++ compiler on PATH")
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True, timeout=120)
    os.replace(tmp, out)
    return out


def _load():
    """Build (if needed) and load the library once per process; None when
    ``APT_NATIVE=0`` or when it cannot be built or loaded (the reason is
    kept for :func:`load_error`)."""
    with _LOCK:
        if _STATE["tried"]:
            return _STATE["lib"]
        _STATE["tried"] = True
        if os.environ.get("APT_NATIVE", "1") == "0":
            _STATE["error"] = "APT_NATIVE=0"
            return None
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError) as exc:
            _STATE["error"] = f"{type(exc).__name__}: {exc}"
            return None
        lib.enumerate_edges.restype = ctypes.c_int64
        lib.enumerate_edges.argtypes = [
            ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
            ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int64),
        ]
        _STATE["lib"] = lib
        return lib


def available() -> bool:
    return _load() is not None


def load_error():
    """Why the library is not in use (None when it is)."""
    _load()
    return _STATE["error"]


def enumerate_edges_native(triangles: np.ndarray, n_points: int):
    """Native edge enumeration: ``(segments, triangle_to_segments)`` as
    int32 arrays, or None when the library is not available."""
    lib = _load()
    if lib is None:
        return None
    tris = np.ascontiguousarray(triangles, dtype=np.int32)
    n_tri = tris.shape[0]
    tri_to_seg = np.empty((n_tri, 3), dtype=np.int32)
    segments = np.empty((3 * n_tri, 2), dtype=np.int32)
    n_seg = ctypes.c_int64(0)
    rc = lib.enumerate_edges(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        n_tri, int(n_points),
        tri_to_seg.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        segments.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        ctypes.byref(n_seg),
    )
    if rc != 0:
        raise ValueError(f"native enumerate_edges failed with code {rc}")
    return segments[: n_seg.value].copy(), tri_to_seg
