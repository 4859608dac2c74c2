"""ctypes bindings for the native host-side kernels (port of
`hept_tpu/native/`, with its own copy of the C++ source).

`hept_native.cpp` is compiled with g++ at first use into
`hept_tpu_torch/_build/libhept_native.so` (listed in .gitignore; rebuilt when
missing or older than the source). Where no g++ builds it,
`native_available()` is False and the callers take their Python paths
(`data/synthetic.py:radius_pairs` falls back to cKDTree). Nothing is built at
import time.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import tempfile
from pathlib import Path

import numpy as np

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / "hept_native.cpp"
BUILD_DIR = _SRC.parent.parent / "_build"
_LIB = BUILD_DIR / "libhept_native.so"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib = None
_tried = False


def _build() -> bool:
    """g++ into a temporary file beside the library, then an atomic rename
    (several processes may build at once)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", tmp, str(_SRC)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except Exception as e:  # no toolchain: the callers' Python paths
        logger.warning("native build failed (%s); using the Python paths", e)
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
        if not _build():
            return None
    lib = ctypes.CDLL(str(_LIB))
    lib.radius_pairs.restype = ctypes.c_int64
    lib.radius_pairs.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_float, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.c_int64,
    ]
    lib.pack_dense.restype = None
    lib.pack_dense.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_bool),
    ]
    lib.knn_small.restype = None
    lib.knn_small.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int32, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the library is built (building it at the first call)."""
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32ptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _require():
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    return lib


def radius_pairs(eta: np.ndarray, phi: np.ndarray, radius: float, max_k: int) -> np.ndarray:
    """(2, E) int32 neighbour pairs within `radius` on (eta, phi), up to the
    max_k nearest per point (grid hash of `radius`-wide cells), anchor in
    row 0."""
    lib = _require()
    eta = np.ascontiguousarray(eta, np.float32)
    phi = np.ascontiguousarray(phi, np.float32)
    n = len(eta)
    cap = max(n * max_k, 1)
    for _ in range(3):
        src = np.empty(cap, np.int32)
        dst = np.empty(cap, np.int32)
        count = lib.radius_pairs(_fptr(eta), _fptr(phi), n, radius, max_k,
                                 _i32ptr(src), _i32ptr(dst), cap)
        if count >= 0:
            return np.stack([src[:count], dst[:count]])
        cap *= 4
    raise RuntimeError("radius_pairs capacity exceeded")


def pack_dense(events_x: list[np.ndarray], n_max: int):
    """Pack ragged per-event feature arrays into (B, n_max, F) float32 and a
    (B, n_max) valid mask."""
    lib = _require()
    b = len(events_x)
    f = events_x[0].shape[1]
    xs = np.ascontiguousarray(np.concatenate(events_x, axis=0), np.float32)
    sizes = np.asarray([e.shape[0] for e in events_x], np.int64)
    out = np.zeros((b, n_max, f), np.float32)
    valid = np.zeros((b, n_max), bool)
    lib.pack_dense(_fptr(xs), sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), b, n_max,
                   f, _fptr(out), valid.ctypes.data_as(ctypes.POINTER(ctypes.c_bool)))
    return out, valid


def knn_small(x: np.ndarray, k: int):
    """Brute-force k nearest neighbours (squared L2, self included) of each
    row of a small (n, d) set: (dists (n, k) float32, idx (n, k) int32),
    +inf / -1 past n."""
    lib = _require()
    x = np.ascontiguousarray(x, np.float32)
    n, d = x.shape
    out_d = np.empty((n, k), np.float32)
    out_i = np.empty((n, k), np.int32)
    lib.knn_small(_fptr(x), n, d, k, _fptr(out_d), _i32ptr(out_i))
    return out_d, out_i
