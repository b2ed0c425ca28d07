"""Build and load the port's native code; count kernel launches.

The CUDA kernels (``csrc/*.cu``) are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded with ctypes.  The
shared host library of the JAX package (``webgraph_tpu/native/wgnative.cpp``)
is compiled with ``g++`` for the host it runs on.  Both land in
``webgraph_tpu_torch/build/`` on first use, under file names keyed by a hash
of their sources, so an edited source is rebuilt and a stale library is never
loaded.  Nothing is built when this module is imported.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper adds
one where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
_WGNATIVE_SRC = os.path.join(os.path.dirname(_PKG), "webgraph_tpu", "native",
                             "wgnative.cpp")

LAUNCHES = {"bv_decode_lanes": 0, "compact_runs": 0}

_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _digest(paths) -> str:
    h = hashlib.sha256()
    for p in sorted(paths):
        h.update(os.path.basename(p).encode())
        with open(p, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _compile(cmd, out: str) -> str:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.tmp{os.getpid()}"
    proc = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"build failed: {' '.join(cmd)}\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_kernels() -> str:
    """nvcc-build ``csrc/*.cu`` into the build dir (once per source hash);
    returns the library path."""
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    out = os.path.join(BUILD_DIR, f"libwgtorch-{_digest(srcs)}.so")
    if os.path.exists(out):
        return out
    return _compile([_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                     *srcs], out)


def build_native() -> str:
    """g++-build the shared host library for this host; returns its path.
    Point ``webgraph_tpu.native._LIB_PATH`` at it before the host layer's
    first native call."""
    out = os.path.join(BUILD_DIR,
                       f"libwgnative-{_digest([_WGNATIVE_SRC])}.so")
    if os.path.exists(out):
        return out
    return _compile(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                     "-pthread", _WGNATIVE_SRC], out)


def use_built_native() -> str:
    """Build the shared host library for this host and point the shared
    host layer at it (``webgraph_tpu.native._LIB_PATH``), in place of the
    committed binary, which was built with ``-march=native`` elsewhere.
    Call before the host layer's first native call; returns the path."""
    from webgraph_tpu import native
    path = build_native()
    if native._lib is not None and native._LIB_PATH != path:
        raise RuntimeError(f"the host library is already loaded from "
                           f"{native._LIB_PATH}")
    native._LIB_PATH = path
    if not native.available():
        raise RuntimeError(f"the host library at {path} did not load")
    return path


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        L = ctypes.CDLL(build_kernels())
        vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        L.wg_bv_decode_lanes.argtypes = [vp, i64, vp, i64, i64, vp, vp,
                                         ci, ci, ci, ci, ci, ci, ci, ci, vp]
        L.wg_bv_decode_lanes.restype = ci
        L.wg_compact_runs.argtypes = [vp, vp, i64, vp, vp, vp, vp, i64, i64,
                                      vp]
        L.wg_compact_runs.restype = ci
        _lib = L
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
