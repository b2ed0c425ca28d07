"""Build and load the port's native code; count kernel launches.

The CUDA kernels (``csrc/*.cu``) are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded with ctypes.  The
shared host library of the JAX package (``webgraph_tpu/native/wgnative.cpp``)
is compiled with ``g++`` for the host it runs on.  Both land in
``webgraph_tpu_torch/build/`` on first use, under file names keyed by a hash
of their sources, so an edited source is rebuilt and a stale library is never
loaded.  Nothing is built when this module is imported.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper adds
one where it launches its kernel and nowhere else.  The main path's two
kernels have a key each, and so has every probe site of ``experiments/``
(the ports in ``webgraph_tpu_torch/experiments/``), keyed by the probe
module and the kernel it launches.
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
# one key per ``pl.pallas_call`` site of the JAX package's probes: the CUDA
# source of its kernel and the site (file:line) it replaces
_P = "experiments/pallas_probe"
PROBE_SITES = {
    "probe.trivial": ("probe_loop.cu", _P + ".py:50"),
    "probe.gather_sublane": ("probe_loop.cu", _P + ".py:82"),
    "probe.gather_ref": ("probe_loop.cu", _P + ".py:108"),
    "probe.gather_1d": ("probe_loop.cu", _P + ".py:136"),
    "probe.vpu_loop": ("probe_loop.cu", _P + ".py:160"),
    "probe.gather_32": ("probe_loop.cu", _P + ".py:188"),
    "probe2.loop_kernel": ("probe_loop.cu", _P + "2.py:63"),
    "probe3.loop_kernel": ("probe_loop.cu", _P + "3.py:40"),
    "probe4.loop_kernel": ("probe_loop.cu", _P + "4.py:50"),
    "probe16.make": ("probe_loop.cu", _P + "16.py:49"),
    "probe5.simple": ("probe_prims.cu", _P + "5.py:34"),
    "probe5.t_dma_dynoffset": ("probe_prims.cu", _P + "5.py:157"),
    "probe6.build": ("probe_lane.cu", _P + "6.py:82"),
    "probe7.run": ("probe_lane.cu", _P + "7.py:25"),
    "probe8.run": ("probe_lane.cu", _P + "8.py:29"),
    "probe9.build": ("probe_lane.cu", _P + "9.py:68"),
    "probe10.build": ("probe_lane.cu", _P + "10.py:70"),
    "probe11.run": ("probe_lane.cu", _P + "11.py:43"),
    "probe12.run": ("probe_lane.cu", _P + "12.py:41"),
    "probe13.run": ("probe_lane.cu", _P + "13.py:40"),
    "probe14.run": ("probe_lane.cu", _P + "14.py:62"),
    "probe15.run": ("probe_lane.cu", _P + "15.py:63"),
    "probe17.make": ("probe_flush.cu", _P + "17.py:141"),
}
LAUNCHES.update((k, 0) for k in PROBE_SITES)

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
    """nvcc-build ``csrc/*.cu`` into the build dir (once per source hash):
    one nvcc per source, all started together, then one link; returns the
    library path."""
    srcs = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    digest = _digest(srcs)
    out = os.path.join(BUILD_DIR, f"libwgtorch-{digest}.so")
    if os.path.exists(out):
        return out
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC"]
    objdir = os.path.join(BUILD_DIR, f"obj-{digest}.tmp{os.getpid()}")
    os.makedirs(objdir, exist_ok=True)
    objs = [os.path.join(objdir, os.path.basename(s) + ".o") for s in srcs]
    procs = [subprocess.Popen([nvcc, *flags, "-c", s, "-o", o],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    failed = []
    for s, p in zip(srcs, procs):
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{os.path.basename(s)}:\n{log}")
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    path = _compile([nvcc, "-shared", *objs], out)
    shutil.rmtree(objdir, ignore_errors=True)
    return path


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
        # probe kernels: (variant, ..., stream), each returns cudaGetLastError
        L.wg_probe_loop.argtypes = [ci, ci, ci, vp, vp, vp, i64, ci, ci, vp]
        L.wg_probe_loop.restype = ci
        L.wg_probe_prims.argtypes = [ci, vp, vp, vp, ci, ci, vp]
        L.wg_probe_prims.restype = ci
        L.wg_probe_lane.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, vp]
        L.wg_probe_lane.restype = ci
        L.wg_probe_flush.argtypes = [ci, vp, vp, vp, vp, ci, ci, ci, vp]
        L.wg_probe_flush.restype = ci
        _lib = L
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_tensor(t, name: str, shape=None, *, dtype=torch.int32,
                 device=None) -> None:
    """Raise ValueError unless ``t`` is a contiguous tensor of ``dtype``, of
    ``shape`` (where given; ``None`` entries match any size) and on
    ``device`` (where given)."""
    if not isinstance(t, torch.Tensor):
        raise ValueError(f"{name}: need a tensor, got {type(t).__name__}")
    if t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: need a contiguous {dtype} tensor, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if shape is not None and (
            t.dim() != len(shape)
            or any(w is not None and w != d for w, d in zip(shape, t.shape))):
        raise ValueError(f"{name}: need shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
