"""Build and load the port's native code; count kernel launches.

The CUDA kernels (``csrc/*.cu``) are compiled with ``nvcc`` for ``sm_90a``
into one shared library with a plain C interface, loaded with ctypes.  The
port's host library (``native/wgnative.cpp``) is compiled with ``g++`` for
the host it runs on.  Both land in ``webgraph_tpu_torch/build/`` on first
use, under file names keyed by a hash of their sources, so an edited source
is rebuilt and a stale library is never loaded.  Each build writes a file of
its own and renames it into place, so several processes may build at once.
Nothing is built when this module is imported.

``PTXAS`` holds, per kernel of the last nvcc build in this process, what
``-Xptxas -v`` reported: registers, stack frame and spill bytes.

``LAUNCHES`` counts, per kernel, the launches its wrapper made; a wrapper adds
one where it launches its kernel and nowhere else.  The main path's
kernels (B1, B2, HyperBall's merge and estimate and the EF decode) have a
key each, and so has every probe site of ``experiments/`` (the ports in
``webgraph_tpu_torch/experiments/``), keyed by the probe module and the
kernel it launches.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import re
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
_WGNATIVE_SRC = os.path.join(_PKG, "native", "wgnative.cpp")

LAUNCHES = {"bv_decode_lanes": 0, "bv_decode_lanes_split": 0,
            "split_merge": 0, "compact_runs": 0, "hyperball_merge": 0,
            "hyperball_estimate": 0, "ef_decode": 0}
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

PTXAS = {}
_lib = None
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
_vp, _i64, _ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
# the C entries of csrc/*.cu (and of their variants): argument types; each
# returns cudaGetLastError
SIGNATURES = {
    "wg_bv_decode_lanes": [_vp, _i64, _vp, _i64, _i64, _vp, _vp, _vp]
    + [_ci] * 8 + [_vp],
    "wg_bv_decode_lanes_split": [_vp, _i64, _vp, _i64, _i64, _vp, _vp, _vp]
    + [_ci] * 8 + [_vp],
    "wg_split_merge": [_vp, _vp, _vp, _vp, _vp, _vp, _i64, _vp],
    "wg_compact_runs": [_vp, _i64, _vp, _i64, _vp, _vp, _vp, _vp, _i64, _i64,
                        _vp],
    "wg_hyperball_merge": [_vp, _vp, _ci, _vp, _i64, _vp, _i64, _vp, _vp,
                           _vp],
    "wg_hyperball_estimate": [_vp, _i64, _vp, _i64, ctypes.c_double, _vp,
                              _vp],
    "wg_ef_decode": [_vp, _i64, _vp, _vp, _i64, _i64, _ci, _i64, _vp, _i64,
                     _vp, _vp],
    # probe kernels: (variant, ..., stream)
    "wg_probe_loop": [_ci, _ci, _ci, _vp, _vp, _vp, _i64, _ci, _ci, _vp],
    "wg_probe_prims": [_ci, _vp, _vp, _vp, _ci, _ci, _vp],
    "wg_probe_lane": [_ci, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _vp],
    "wg_probe_flush": [_ci, _vp, _vp, _vp, _vp, _ci, _ci, _ci, _vp],
}


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
    log_path = out + ".ptxas.txt"
    if os.path.exists(out):
        if os.path.exists(log_path):
            with open(log_path) as f:
                PTXAS.update(parse_ptxas(f.read()))
        return out
    nvcc = _nvcc()
    flags = NVCC_FLAGS
    objdir = os.path.join(BUILD_DIR, f"obj-{digest}.tmp{os.getpid()}")
    os.makedirs(objdir, exist_ok=True)
    objs = [os.path.join(objdir, os.path.basename(s) + ".o") for s in srcs]
    procs = [subprocess.Popen([nvcc, *flags, "-c", s, "-o", o],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for s, o in zip(srcs, objs)]
    failed, logs = [], []
    for s, p in zip(srcs, procs):
        log, _ = p.communicate()
        logs.append(log)
        if p.returncode != 0:
            failed.append(f"{os.path.basename(s)}:\n{log}")
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    PTXAS.update(parse_ptxas("".join(logs)))
    with open(f"{log_path}.tmp{os.getpid()}", "w") as f:
        f.write("".join(logs))
    os.replace(f"{log_path}.tmp{os.getpid()}", log_path)
    path = _compile([nvcc, "-shared", *objs], out)
    shutil.rmtree(objdir, ignore_errors=True)
    return path


def parse_ptxas(log: str) -> dict:
    """``-Xptxas -v`` output -> {entry function: {regs, stack, spill_stores,
    spill_loads}} (bytes for the last three)."""
    res, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = res.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            cur.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["regs"] = int(m.group(1))
    return res


def start_variant(src: str, defs: str, tag: str):
    """Start nvcc on ``src`` with the comma-separated macros ``defs`` into a
    shared library of the build dir (keyed by source and macros); returns
    (process, library path).  :func:`load_variant` waits for it."""
    with open(src, "rb") as f:
        key = hashlib.sha256(f.read() + defs.encode()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, f"{tag}-{key}.so")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-shared",
         *[f"-D{d}" for d in defs.split(",") if d], src, "-o", out],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, out


def load_variant(proc, out: str, what: str):
    """Wait for :func:`start_variant`'s build; returns (library with its C
    entries bound, ptxas's report of its kernels)."""
    log, _ = proc.communicate()
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {what}:\n{log}")
    return bind(ctypes.CDLL(out)), parse_ptxas(log)


def bind(L: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument and result types of every C entry ``L`` has."""
    for name, args in SIGNATURES.items():
        fn = getattr(L, name, None)
        if fn is not None:
            fn.argtypes = args
            fn.restype = _ci
    return L


def build_native() -> str:
    """g++-build the port's host library for this host (once per source
    hash); returns its path.  ``native`` loads it on first use."""
    out = os.path.join(BUILD_DIR,
                       f"libwgnative-{_digest([_WGNATIVE_SRC])}.so")
    if os.path.exists(out):
        return out
    return _compile(["g++", "-O3", "-fPIC", "-shared", "-std=c++17",
                     "-pthread", _WGNATIVE_SRC], out)


def lib() -> ctypes.CDLL:
    """The kernel library, built on first use."""
    global _lib
    if _lib is None:
        _lib = bind(ctypes.CDLL(build_kernels()))
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
