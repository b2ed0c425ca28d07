"""Run one cell: generate, set up, measure a window, check, report.

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file found by its name in ``BENCHMARK.json``:

- ``configs/<config>.json`` (the entry's ``file``): the generator, its
  parameters, the BVGraph settings;
- ``gen/<generator>.py``: ``generate(params, seed, device)`` -> the CSR;
- ``traffic/<mix>.json``: the op it drives, its parameters and the limits
  of its check;
- ``ops/<op>.py``: ``Op(env)`` with ``setup``, ``step``, ``end_to_end``,
  ``release``, ``check`` and the ``counters`` the readers read;
- ``layers/<metric>.py``: ``read(ctx)`` -> the metric, or None when there
  is nothing to read.

A later cell, configuration, mix or metric is new files and a new entry;
no file here changes.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import random
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from .trace import capture, span

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def sync(device: torch.device) -> None:
    with span("synchronize"):
        if device.type == "cuda":
            torch.cuda.synchronize(device)


@contextlib.contextmanager
def timed(env, part: str):
    """Seconds of one part of set-up, ending in a synchronise."""
    t0 = time.perf_counter()
    yield
    sync(env.device)
    env.parts[part] = env.parts.get(part, 0.0) + time.perf_counter() - t0


def load_bench() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``<kind>/<name>.py`` under the benchmark, as a module of it."""
    path = os.path.join(HERE, kind, name + ".py")
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    modname = "benchmark.{}.{}".format(
        kind, "".join(c if c.isalnum() else "_" for c in name))
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    spec.loader.exec_module(mod)
    return mod


def cell_files(bench: dict, workload: str) -> dict:
    """The entries and files of one cell, found by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[cell["config"]]
    return dict(cell=cell, config_entry=entry,
                config=load_json(ROOT, entry["file"]),
                traffic=load_json(HERE, "traffic", cell["traffic"] + ".json"))


def metrics_of(bench: dict, kind: str, workload: str) -> list:
    """The ``kind`` ("end_to_end" or "per_layer") metrics this cell reports:
    those that list it, and those that list no cells."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


class Env:
    """What an op sees: the cell's files, the seed, the device, the
    generated graph (the reference) and the set-up clock."""

    def __init__(self, config, traffic, seed, device, control):
        self.config, self.traffic = config, traffic
        self.seed, self.device, self.control = seed, device, control
        self.parts = {}
        self.offsets = self.succ = None

    @property
    def n(self) -> int:
        return self.offsets.numel() - 1

    @property
    def m(self) -> int:
        return self.succ.numel()

    def park(self) -> None:
        """Move the reference to the host while the program runs, so the
        peak is the program's."""
        if not self.control:
            with timed(self, "park"):
                self.offsets, self.succ = self.offsets.cpu(), self.succ.cpu()

    def ref_offsets(self) -> torch.Tensor:
        self.offsets = self.offsets.to(self.device)
        return self.offsets

    def ref_succ(self) -> torch.Tensor:
        self.succ = self.succ.to(self.device)
        return self.succ


def _held_bytes(obj, seen: set) -> int:
    """Bytes of device memory that holding ``obj`` keeps allocated: the
    whole storage of every CUDA tensor in it, each storage once."""
    if isinstance(obj, (tuple, list)):
        return sum(_held_bytes(o, seen) for o in obj)
    if isinstance(obj, torch.Tensor) and obj.is_cuda:
        st = obj.untyped_storage()
        if st.data_ptr() not in seen:
            seen.add(st.data_ptr())
            return st.nbytes()
    return 0


class Peak:
    """The program's peak of allocated device memory over set-up and the
    window, leaving out the answers the harness keeps for the check.

    The kept bytes change only when an answer is kept, so the allocator's
    peak is read just before each keep, less what the answers kept until
    then hold, and restarted after it.  Reading it builds the allocator's
    whole table of statistics (about 0.2 ms), so it is not read after
    every operation: that would put the harness's time into the window."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        self.kept_bytes = 0
        self._seen = set()
        self.setup_peak = self._max()    # nothing is kept yet
        self.window_peak = 0
        self.restart()

    @property
    def peak(self) -> int:
        return max(self.setup_peak, self.window_peak)

    def _max(self) -> int:
        return torch.cuda.max_memory_allocated(self.device) if self.cuda else 0

    def keep(self, kept: list, item) -> None:
        """Read the peak so far, then add ``item`` to ``kept``."""
        self.window_peak = max(self.window_peak,
                               self._max() - self.kept_bytes)
        kept.append(item)
        if self.cuda:
            self.kept_bytes += _held_bytes(item, self._seen)

    def restart(self) -> None:
        if self.cuda:
            torch.cuda.reset_peak_memory_stats(self.device)


def _power_limit():
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return None
    return out[0] if out else None


def _device_info(device: torch.device, peak: int) -> dict:
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=1, memory_peak_bytes=peak,
                    power_limit=_power_limit())
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=peak)


def _build(device: torch.device) -> None:
    """CUDA context, the program's host library and kernels: built on the
    first run in a checkout, loaded from its build directory after."""
    from webgraph_tpu_torch import native
    native.lib_path()
    if device.type == "cuda":
        from webgraph_tpu_torch.ops import _build as build
        torch.zeros(1, device=device)
        build.lib()


def run_cell(bench: dict, workload: str, seed: int, seconds: float,
             trace: bool, device, t_start: float, control: bool = False,
             config: dict = None, log=None) -> dict:
    """One run of ``workload``: the result line's object.  ``config``
    replaces the cell's configuration (tests shrink it); ``control`` puts
    the reference's control in the program's place."""
    device = torch.device(device)
    files = cell_files(bench, workload)
    config = config or files["config"]
    traffic = files["traffic"]
    gen = load_module("gen", config["generator"])
    op_mod = load_module("ops", traffic["op"])
    env = Env(config, traffic, seed, device, control)
    env.parts["imports"] = time.perf_counter() - t_start
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))

    with timed(env, "init"):
        _build(device)
    with timed(env, "generate"):
        env.offsets, env.succ = gen.generate(config["params"], seed, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    op = op_mod.Op(env)
    kept = []
    try:
        op.setup()
        setup_s = time.perf_counter() - t_start
        rng = random.Random(seed)
        among = int(traffic.get("keep_among", 0))
        keep_idx = set(rng.sample(range(among), min(int(traffic.get(
            "keep", 0)), among)))

        op_s = []
        mem = Peak(device)

        def window():
            done, t0 = 0, time.perf_counter()
            while True:
                t1 = time.perf_counter()
                out = op.step()
                op_s.append(time.perf_counter() - t1)
                done += 1
                elapsed = time.perf_counter() - t0
                last = elapsed >= seconds
                if last or done - 1 in keep_idx:
                    mem.keep(kept, (done - 1, out))
                    del out
                    mem.restart()
                else:
                    del out
                if last:
                    return elapsed, done

        tr = None
        if trace:
            (window_s, done), tr = capture(window, device)
        else:
            window_s, done = window()
        peak = mem.peak
    finally:
        op.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks, failed = op.check(kept)
    del kept

    units = {m["name"]: m["unit"] for m in bench["end_to_end"]
             + bench["per_layer"]}
    device_info = _device_info(device, peak)
    device_info["kept_bytes"] = mem.kept_bytes
    metrics = {}
    if not trace:
        values = dict(op.end_to_end(window_s, done), setup_s=setup_s)
        for m in metrics_of(bench, "end_to_end", workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": units[m["name"]]}
    else:
        ctx = SimpleNamespace(trace=tr, counters=op.counters, env=env,
                              calls=done, window_s=window_s,
                              kind=device_info["kind"])
        for m in metrics_of(bench, "per_layer", workload):
            v = load_module("layers", m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": units[m["name"]]}
    result = {"correct": None, "attempted": done, "failed": failed,
              "metrics": metrics, "device": device_info}
    if trace:
        device_info.update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.device_ops(),
                               "idle_gaps": tr.idle_gaps()}
    limits = traffic["limits"]
    result["correct"] = failed == 0 and all(
        checks[k] <= limits[k] for k in limits)
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]}
                        for k in limits}
    for k, v in env.parts.items():
        log(f"setup {k} {v:.6f} s")
    log(f"memory peak {peak} bytes (the program's: set-up {mem.setup_peak},"
        f" window {mem.window_peak}), besides {mem.kept_bytes} bytes of "
        "answers the harness keeps for the check")
    log(f"window {window_s:.6f} s, {done} operations, seconds each: first "
        f"{op_s[0]:.6f} median {statistics.median(op_s):.6f} "
        f"max {max(op_s):.6f}")
    for k in limits:
        log(f"check {k} {checks[k]} limit {limits[k]}")
    return result
