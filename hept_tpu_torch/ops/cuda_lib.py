"""Build and load the port's CUDA kernels.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface under `hept_tpu_torch/_build/` (listed in
.gitignore), and is loaded with ctypes. The build runs at first use, from the
package's own sources: a library is rebuilt when it is missing or older than
its source. `build()` starts one `nvcc` per source, all at once, and waits
for them. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
SOURCES = ("bucket_attn", "pair_ops", "row_gather", "sort")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
# ptxas register / shared-memory report of each build in this process
build_log: dict[str, str] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    so = lib_path(name)
    return not so.exists() or so.stat().st_mtime < (CSRC_DIR / f"{name}.cu").stat().st_mtime


def build(names=SOURCES, force: bool = False) -> float:
    """Compile the named sources that need it, one nvcc each, in parallel.
    Returns the seconds taken. Raises with nvcc's output on failure."""
    todo = [nm for nm in names if force or _stale(nm)]
    t0 = time.perf_counter()
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for nm in todo:
        # compile to a temporary name, then rename: a concurrent loader never
        # sees a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{nm}.cu")]
        procs.append((nm, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for nm, tmp, p in procs:
        out, _ = p.communicate()
        build_log[nm] = out
        if p.returncode != 0:
            failed.append(f"{nm}.cu (exit {p.returncode}):\n{out}")
            Path(tmp).unlink(missing_ok=True)
        else:
            os.replace(tmp, lib_path(nm))
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(lib_path(name)))
        _libs[name] = lib
    return lib


def check(err: int, lib: ctypes.CDLL, error_fn: str, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        fn = getattr(lib, error_fn)
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(f"{what}: CUDA error {err}: {fn(err).decode()}")


def stream_ptr(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)
