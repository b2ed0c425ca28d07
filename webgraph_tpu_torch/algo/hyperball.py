"""HyperBall: neighbourhood function and distance sums over a device CSR.

Counterpart of ``webgraph_tpu/algo/hyperball.py``: ``hyperloglog_init`` and
``estimate_counts`` (``:57-95``), ``device_round`` (``:296``), the
``HyperBall`` class (``:353-625``), ``sequential_hyperball`` (``:628``) and
``effective_diameter`` (``:649``).  The host functions are numpy copies of
the JAX module's (that module imports jax); ``hyperloglog_init`` and
``estimate_counts`` are the plain references of their ``_device``
versions.

A round is c'[x] = max(c[x], max over successors y of c[y]) on uint8
registers (HyperBall.java:654-900).  ``merge_rows`` computes it for a list
of nodes: on the card one launch of ``csrc/hyperball.cu``, a segmented
byte-max over each node's successor rows; on the CPU its plain twin
``merge_rows_plain``, a gather of the successors' rows and a scatter-max
into their sources (in the JAX package the round is an XLA program of that
gather and scatter, not a Pallas kernel).  ``estimate_rows`` counts listed
rows: on the card one launch of the same file's ``hyperball_estimate``,
which reads each row where it lies; on the CPU its plain twin
``estimate_rows_plain``, ``estimate_counts_device`` over gathered rows.
The JAX package's packed-u32 ``DenseRoundPlan`` is a TPU layout and has no
counterpart; its power-of-two padding exists for XLA's static shapes and
has none either.

The class keeps registers, counts, the modified mask and the distance sums
on the graph's device; the must-check set of a systolic or local round, the
count update and the NF sum are device ops too.  External mode keeps the
registers on the host (in memory or a memmap) and merges on the device.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .. import state
from ..core.graph import CSRGraph, expand_ranges
from ..ops import _build
from ..utils.trace import count, span

__all__ = ["HyperBall", "hyperloglog_init", "hyperloglog_init_device",
           "estimate_counts", "estimate_counts_device", "estimate_rows",
           "estimate_rows_plain", "merge_rows", "merge_rows_plain",
           "device_round",
           "sequential_hyperball", "effective_diameter"]

_M64 = np.uint64(0xFFFFFFFFFFFFFFFF)

# arcs per gather/scatter slice: bounds the (arcs, registers) transient
ARC_SLICE = 1 << 26
# counter rows per block of the plain estimate and of external mode's
# upload: bounds the (rows, registers) float64 transient
EST_ROWS = 1 << 20


def _splitmix64(x: np.ndarray) -> np.ndarray:
    x = (x + np.uint64(0x9E3779B97F4A7C15)) & _M64
    z = ((x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & _M64
    z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & _M64
    return z ^ (z >> np.uint64(31))


def _alpha(m: int) -> float:
    return {16: 0.673, 32: 0.697, 64: 0.709}.get(m, 0.7213 / (1 + 1.079 / m))


def hyperloglog_init(n: int, log2m: int, seed: int = 0) -> np.ndarray:
    """Initial registers: each node's counter holds only itself
    (HyperBall.init :571).  uint8 (n, 2^log2m)."""
    m = 1 << log2m
    regs = np.zeros((n, m), dtype=np.uint8)
    with np.errstate(over="ignore"):   # the seed's mix wraps mod 2^64
        h = _splitmix64(np.arange(n, dtype=np.uint64)
                        + np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15))
    j = (h & np.uint64(m - 1)).astype(np.int64)
    w = h >> np.uint64(log2m)
    zero = w == 0
    v = np.where(zero, np.uint64(1), w)
    tz = np.zeros(n, dtype=np.int64)
    for shift in (32, 16, 8, 4, 2, 1):
        low = (v & ((np.uint64(1) << np.uint64(shift)) - np.uint64(1))) == 0
        tz = np.where(low, tz + shift, tz)
        v = np.where(low, v >> np.uint64(shift), v)
    rho = np.where(zero, 64 - log2m, tz) + 1
    regs[np.arange(n), j] = rho.astype(np.uint8)
    return regs


def _i64(c: int) -> int:
    """A 64-bit pattern as the int64 torch holds it."""
    c &= (1 << 64) - 1
    return c - (1 << 64) if c >> 63 else c


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def hyperloglog_init_device(n: int, log2m: int, seed: int,
                            device) -> torch.Tensor:
    """``hyperloglog_init`` on ``device``: the same splitmix64 hash in
    int64 arithmetic, which wraps mod 2^64 as the uint64 one does."""
    m = 1 << log2m
    golden = 0x9E3779B97F4A7C15
    x = torch.arange(n, dtype=torch.int64, device=device)
    x += _i64(seed * golden + golden)
    z = (x ^ _shr(x, 30)) * _i64(0xBF58476D1CE4E5B9)
    z = (z ^ _shr(z, 27)) * _i64(0x94D049BB133111EB)
    h = z ^ _shr(z, 31)
    del x, z
    j = h & (m - 1)
    w = _shr(h, log2m)
    zero = w == 0
    v = torch.where(zero, 1, w)
    tz = torch.zeros(n, dtype=torch.int64, device=device)
    for shift in (32, 16, 8, 4, 2, 1):
        low = (v & ((1 << shift) - 1)) == 0
        tz += low * shift
        v = torch.where(low, _shr(v, shift), v)
    rho = torch.where(zero, 64 - log2m, tz) + 1
    regs = torch.zeros((n, m), dtype=torch.uint8, device=device)
    regs[torch.arange(n, device=device), j] = rho.to(torch.uint8)
    return regs


def estimate_counts(regs: np.ndarray) -> np.ndarray:
    """Per-node HLL cardinality estimates with small-range correction."""
    regs = np.asarray(regs)
    m = regs.shape[1]
    est = _alpha(m) * m * m / np.sum(np.exp2(-regs.astype(np.float64)),
                                     axis=1)
    zeros = np.sum(regs == 0, axis=1)
    small = (est <= 2.5 * m) & (zeros > 0)
    with np.errstate(divide="ignore"):
        lin = m * np.log(m / np.maximum(zeros, 1e-300))
    return np.where(small, lin, est)


def estimate_counts_device(regs: torch.Tensor) -> torch.Tensor:
    """``estimate_counts`` of uint8 (k, 2^log2m) registers on their device,
    float64[k]."""
    m = regs.shape[1]
    est = _alpha(m) * m * m / torch.exp2(-regs.to(torch.float64)).sum(1)
    zeros = (regs == 0).sum(1).to(torch.float64)
    small = (est <= 2.5 * m) & (zeros > 0)
    lin = m * torch.log(m / torch.clamp(zeros, min=1e-300))
    return torch.where(small, lin, est)


def estimate_rows(regs: torch.Tensor,
                  nodes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Counts of the rows ``nodes`` of ``regs`` (every row when None),
    float64[k] on their device: ``estimate_counts_device(regs[nodes])``.

    ``regs``: uint8 (n, 2^log2m), ``nodes``: int64[k] ids in [0, n),
    contiguous on one device.  CUDA tensors launch ``hyperball_estimate``
    (``csrc/hyperball.cu``) once, which reads each row in place and adds k
    to the counter ``hyperball.est_rows``; CPU tensors run
    :func:`estimate_rows_plain`.  The ids are not checked on the card, as
    that would cost a sync a call: an id outside [0, n) reads past
    ``regs`` there, where the CPU's gather raises IndexError."""
    dev = regs.device
    _build.check_tensor(regs, "regs", (None, None), dtype=torch.uint8)
    n, R = regs.shape
    if R & (R - 1):
        raise ValueError("regs must have 2^log2m columns")
    if nodes is not None:
        _build.check_tensor(nodes, "nodes", (None,), dtype=torch.int64,
                            device=dev)
    if dev.type == "cpu":
        return estimate_rows_plain(regs, nodes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k = n if nodes is None else nodes.numel()
    out = torch.empty(k, dtype=torch.float64, device=dev)
    if k == 0:
        return out
    rc = _build.lib().wg_hyperball_estimate(
        regs.data_ptr(), R, None if nodes is None else nodes.data_ptr(), k,
        _alpha(R) * R * R, out.data_ptr(), _build.stream_ptr(regs))
    _build.check(rc, "hyperball_estimate")
    _build.LAUNCHES["hyperball_estimate"] += 1
    count("hyperball.est_rows", k)
    return out


def estimate_rows_plain(regs: torch.Tensor,
                        nodes: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """The plain twin of :func:`estimate_rows`: ``estimate_counts_device``
    over gathered rows, in blocks of EST_ROWS."""
    k = regs.shape[0] if nodes is None else nodes.numel()
    out = torch.empty(k, dtype=torch.float64, device=regs.device)
    for lo in range(0, k, EST_ROWS):
        hi = min(lo + EST_ROWS, k)
        rows = regs[lo:hi] if nodes is None else regs[nodes[lo:hi]]
        out[lo:hi] = estimate_counts_device(rows)
    return out


def _scatter_max_rows(out: torch.Tensor, dst: torch.Tensor,
                      table: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """out[dst[i]] = max(out[dst[i]], table[rows[i]]) for every i, in
    slices of ARC_SLICE; returns ``out``."""
    R = out.shape[1]
    for lo in range(0, dst.numel(), ARC_SLICE):
        hi = min(lo + ARC_SLICE, dst.numel())
        idx = dst[lo:hi].to(torch.int64)[:, None].expand(-1, R)
        out.scatter_reduce_(0, idx, table[rows[lo:hi].to(torch.int64)],
                            "amax", include_self=True)
    return out


def merge_rows(off: torch.Tensor, succ: torch.Tensor, regs: torch.Tensor,
               nodes: Optional[torch.Tensor] = None) -> tuple:
    """Merged registers of ``nodes`` and whether each changed: row i is the
    bytewise max of ``regs[x_i]`` and the rows of x_i's successors, where
    x_i = ``nodes[i]``, or i when ``nodes`` is None (every node: a dense
    round).  Reads ``regs`` only.

    ``off``: int64[n+1] offsets and ``succ``: int32/int64[m] successors of
    the CSR, ``regs``: uint8 (n, 2^log2m), ``nodes``: int64[k], all
    contiguous on one device.  Returns (uint8 (k, 2^log2m), bool[k]).  CUDA
    tensors launch ``hyperball_merge`` (``csrc/hyperball.cu``); CPU tensors
    run :func:`merge_rows_plain`."""
    dev = regs.device
    _build.check_tensor(regs, "regs", (None, None), dtype=torch.uint8)
    n, R = regs.shape
    if R & (R - 1):
        raise ValueError("regs must have 2^log2m columns")
    _build.check_tensor(off, "off", (n + 1,), dtype=torch.int64, device=dev)
    if succ.dtype not in (torch.int32, torch.int64):
        raise ValueError("succ must be int32 or int64")
    _build.check_tensor(succ, "succ", (None,), dtype=succ.dtype, device=dev)
    if nodes is not None:
        _build.check_tensor(nodes, "nodes", (None,), dtype=torch.int64,
                            device=dev)
    if dev.type == "cpu":
        return merge_rows_plain(off, succ, regs, nodes)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    k = n if nodes is None else nodes.numel()
    out = torch.empty((k, R), dtype=torch.uint8, device=dev)
    changed = torch.empty(k, dtype=torch.bool, device=dev)
    if k == 0:
        return out, changed
    rc = _build.lib().wg_hyperball_merge(
        off.data_ptr(), succ.data_ptr(), int(succ.dtype == torch.int64),
        regs.data_ptr(), R, None if nodes is None else nodes.data_ptr(), k,
        out.data_ptr(), changed.data_ptr(), _build.stream_ptr(regs))
    _build.check(rc, "hyperball_merge")
    _build.LAUNCHES["hyperball_merge"] += 1
    return out, changed


def merge_rows_plain(off: torch.Tensor, succ: torch.Tensor,
                     regs: torch.Tensor,
                     nodes: Optional[torch.Tensor] = None) -> tuple:
    """The plain twin of :func:`merge_rows`: a gather of the successors'
    rows and a scatter-max into their list's row (``_scatter_max_rows``)."""
    dev = regs.device
    if nodes is None:
        old, cnt, tgt = regs, off[1:] - off[:-1], succ
    else:
        lo = off[nodes]
        cnt = off[nodes + 1] - lo
        old, tgt = regs[nodes], succ[expand_ranges(lo, cnt, dev)]
    seg = torch.repeat_interleave(torch.arange(old.shape[0], device=dev),
                                  cnt, output_size=tgt.numel())
    new = _scatter_max_rows(old.clone(), seg, regs, tgt)
    return new, (new != old).any(1)


def device_round(csr_off, succ: torch.Tensor,
                 regs: torch.Tensor) -> torch.Tensor:
    """One HyperBall iteration over a device CSR; returns new registers.

    ``csr_off``: int64[n+1] offsets (host or device); ``succ``: int32/int64
    [m] on the device; ``regs``: uint8 (n, 2^log2m) on the same device."""
    co = torch.as_tensor(csr_off, device=regs.device).to(torch.int64)
    return merge_rows(co.contiguous(), succ.contiguous(),
                      regs.contiguous())[0]


class HyperBall:
    """Iterative neighbourhood-function computation (HyperBall.run).

    With the transpose ``gt``, rounds become **systolic** once fewer than
    half the counters changed (HyperBall.java:1011): only the predecessors
    of last round's modified counters are merged, which is exact because a
    counter with no modified successor cannot change.  A round is labelled
    **local** when modified * m * 10 < n * n (HyperBall.java:1021).  Without
    ``gt`` every round is dense.

    ``external_chunk`` > 0 keeps the registers on the host, in a memmap at
    ``regs_path`` when given (HyperBall.java:268-273, :1104-1130): each round
    gathers <= external_chunk arcs' worth of successor registers on the
    host, merges them on the device, and applies the buffered updates after
    the round.  Counts, distance sums and the modified mask stay on the
    device in every mode and are computed the same way in each, so every
    mode gives the same neighbourhood function."""

    def __init__(self, g: CSRGraph, log2m: int = 6, seed: int = 0,
                 gt: Optional[CSRGraph] = None,
                 do_sum_of_distances: bool = False,
                 do_sum_of_inverse_distances: bool = False,
                 external_chunk: int = 0,
                 regs_path: Optional[str] = None):
        n = g.num_nodes
        dev = g.device
        if gt is not None and (gt.device != dev or gt.num_nodes != n):
            raise ValueError("gt must be the transpose of g, on g's device")
        self.g, self.gt = g, gt
        self.log2m = log2m
        self.seed = seed
        self.device = dev
        self.external_chunk = int(external_chunk)
        if not self.external_chunk:
            self.regs = hyperloglog_init_device(n, log2m, seed, dev)
        elif regs_path is not None:
            mm = np.lib.format.open_memmap(
                regs_path, mode="w+", dtype=np.uint8, shape=(n, 1 << log2m))
            mm[:] = hyperloglog_init(n, log2m, seed)
            mm.flush()
            self.regs = mm
        else:
            self.regs = hyperloglog_init(n, log2m, seed)
        self._counts = self._estimate(None)
        self.neighbourhood_function: List[float] = [float(n)]
        self.modified = n
        self._mod_mask: Optional[torch.Tensor] = None  # None: dense next
        self.iteration = 0
        self.mode_history: List[str] = []
        self.arcs_touched: List[int] = []
        f64 = dict(dtype=torch.float64, device=dev)
        self.sum_of_distances = (torch.zeros(n, **f64)
                                 if do_sum_of_distances else None)
        self.sum_of_inverse_distances = (
            torch.zeros(n, **f64) if do_sum_of_inverse_distances else None)

    # -- registers, wherever they live -------------------------------------

    def _rows(self, nodes: torch.Tensor) -> torch.Tensor:
        """Register rows of ``nodes`` (device int64), on the device."""
        if not self.external_chunk:
            return self.regs[nodes]
        return torch.from_numpy(
            np.asarray(self.regs[nodes.cpu().numpy()])).to(self.device)

    def _estimate(self, nodes: Optional[torch.Tensor]) -> torch.Tensor:
        """Count estimates of ``nodes`` (all when None), float64 on the
        device: ``estimate_rows`` over the resident registers, or over
        host rows uploaded in blocks of EST_ROWS in external mode."""
        if not self.external_chunk:
            return estimate_rows(self.regs, nodes)
        k = self.g.num_nodes if nodes is None else nodes.numel()
        out = torch.empty(k, dtype=torch.float64, device=self.device)
        for lo in range(0, k, EST_ROWS):
            hi = min(lo + EST_ROWS, k)
            idx = (torch.arange(lo, hi, device=self.device) if nodes is None
                   else nodes[lo:hi])
            out[lo:hi] = estimate_rows(self._rows(idx))
        return out

    # -- persistence: the JAX package's .npz keys and dtypes --------------

    def save_state(self, path: str) -> None:
        def host(t, empty_dtype):
            return (t.cpu().numpy() if t is not None
                    else np.zeros(0, dtype=empty_dtype))
        regs = (np.asarray(self.regs) if self.external_chunk
                else state.registers_to_jax(self.regs))
        np.savez_compressed(
            path, regs=regs, counts=self._counts.cpu().numpy(),
            nf=np.asarray(self.neighbourhood_function),
            iteration=self.iteration, modified=self.modified,
            mod_mask=host(self._mod_mask, bool),
            sum_of_distances=host(self.sum_of_distances, np.float64),
            sum_of_inverse_distances=host(self.sum_of_inverse_distances,
                                          np.float64),
            log2m=self.log2m, seed=self.seed)

    def load_state(self, path: str) -> None:
        z = np.load(path if path.endswith(".npz") else path + ".npz")
        if int(z["log2m"]) != self.log2m or int(z["seed"]) != self.seed:
            raise ValueError("state saved with another log2m or seed")
        dev = self.device
        if self.external_chunk:
            self.regs[:] = state.registers_from_jax(z["regs"], "cpu").numpy()
        else:
            self.regs = state.registers_from_jax(z["regs"], dev)
        self._counts = torch.from_numpy(z["counts"]).to(dev)
        self.neighbourhood_function = [float(v) for v in z["nf"]]
        self.iteration = int(z["iteration"])
        self.modified = int(z["modified"])
        mm = z["mod_mask"]
        self._mod_mask = torch.from_numpy(mm).to(dev) if mm.size else None
        if z["sum_of_distances"].size:
            self.sum_of_distances = torch.from_numpy(
                z["sum_of_distances"]).to(dev)
        if z["sum_of_inverse_distances"].size:
            self.sum_of_inverse_distances = torch.from_numpy(
                z["sum_of_inverse_distances"]).to(dev)

    # -- one round ----------------------------------------------------------

    def _must_check(self) -> torch.Tensor:
        """Predecessors (through the transpose) of last round's modified
        counters, ascending: the only counters that can change."""
        gt = self.gt
        mod = torch.nonzero(self._mod_mask).squeeze(1)
        lo = gt.offsets[mod]
        preds = gt.succ[expand_ranges(lo, gt.offsets[mod + 1] - lo,
                                      self.device)]
        mark = torch.zeros(self.g.num_nodes, dtype=torch.bool,
                           device=self.device)
        mark[preds.to(torch.int64)] = True
        return torch.nonzero(mark).squeeze(1)

    def _round_mode(self) -> str:
        """"local" or "systolic" when only the predecessors of last
        round's modified counters need merging, else "dense"."""
        n = self.g.num_nodes
        if (self.gt is not None and self._mod_mask is not None
                and self.modified < n // 2):
            return ("local" if self.modified * self.g.num_arcs * 10 < n * n
                    else "systolic")
        return "dense"

    def _mark(self, changed: torch.Tensor) -> None:
        """Keep the round's changed nodes as the next round's mask."""
        mask = torch.zeros(self.g.num_nodes, dtype=torch.bool,
                           device=self.device)
        mask[changed] = True
        self._mod_mask = mask
        self.modified = changed.numel()

    def _merge_external(self, nodes: torch.Tensor) -> tuple:
        """Merged registers of ``nodes`` (device int64) with the registers
        on the host: the successor rows are gathered there (the "spill"
        read) and merged on the device.  Returns (new rows, changed flags,
        arcs)."""
        g = self.g
        lo = g.offsets[nodes]
        cnt = g.offsets[nodes + 1] - lo
        aidx = expand_ranges(lo, cnt, self.device)
        seg = torch.repeat_interleave(
            torch.arange(nodes.numel(), device=self.device), cnt,
            output_size=aidx.numel())
        table = self._rows(g.succ[aidx].to(torch.int64))
        old = self._rows(nodes)
        new = _scatter_max_rows(old.clone(), seg, table,
                                torch.arange(aidx.numel(), device=self.device))
        return new, (new != old).any(1), aidx.numel()

    def _iterate_device(self, must: Optional[torch.Tensor]):
        g = self.g
        with span("hyperball.merge"):
            new, ch = merge_rows(g.offsets, g.succ, self.regs, must)
            if must is None:
                self.regs, touched = new, g.num_arcs
            else:
                self.regs[must] = new
                touched = (g.offsets[must + 1] - g.offsets[must]).sum()
        with span("hyperball.changed"):
            changed = (torch.nonzero(ch).squeeze(1) if must is None
                       else must[ch])
            self._mark(changed)
        return changed, touched

    def _iterate_external(self, must: Optional[torch.Tensor]):
        """Batches of <= external_chunk arcs of the active nodes, each read
        from the previous round's registers; updates applied after."""
        n = self.g.num_nodes
        with span("hyperball.merge"):
            if must is None:
                must = torch.arange(n, device=self.device)
            cnt = (self.g.offsets[must + 1]
                   - self.g.offsets[must]).cpu().numpy()
            ccum = np.concatenate([[0], np.cumsum(cnt)])
            updates, changed, touched = [], [], 0
            lo = 0
            while lo < len(cnt):
                hi = int(np.searchsorted(ccum, ccum[lo] + self.external_chunk,
                                         "right")) - 1
                hi = min(max(hi, lo + 1), len(cnt))
                b = must[lo:hi]
                new, ch, tb = self._merge_external(b)
                if bool(ch.any()):
                    updates.append((b[ch].cpu().numpy(),
                                    new[ch].cpu().numpy()))
                    changed.append(b[ch])
                touched += tb
                lo = hi
            for rows, vals in updates:
                self.regs[rows] = vals
        with span("hyperball.changed"):
            changed = (torch.cat(changed) if changed else
                       torch.zeros(0, dtype=torch.int64, device=self.device))
            self._mark(changed)
        return changed, touched

    def iterate(self) -> int:
        """One iteration; returns the number of modified counters
        (HyperBall.iterate :1000).

        The round is the span ``wg.hyperball.round.<mode>``, ``<mode>`` as
        ``mode_history`` records it, with children
        ``wg.hyperball.must_check`` (systolic and local rounds),
        ``wg.hyperball.merge``, ``wg.hyperball.changed`` and
        ``wg.hyperball.estimate``; the arcs it merges add to the counter
        ``hyperball.arcs`` (``utils/trace.py``)."""
        t = self.iteration + 1
        mode = self._round_mode()
        sparse = mode != "dense"
        if self.external_chunk:
            mode += "-external"
        with span("hyperball.round." + mode):
            must = None
            if sparse:
                with span("hyperball.must_check"):
                    must = self._must_check()
            if self.external_chunk:
                changed, touched = self._iterate_external(must)
            else:
                changed, touched = self._iterate_device(must)
            touched = int(touched)
            self.mode_history.append(mode)
            self.arcs_touched.append(touched)
            count("hyperball.arcs", touched)
            self.iteration = t
            # incremental count update: only changed counters moved
            with span("hyperball.estimate"):
                if self.modified:
                    new_counts = self._estimate(changed)
                    delta = torch.clamp(new_counts - self._counts[changed],
                                        min=0.0)
                    if self.sum_of_distances is not None:
                        self.sum_of_distances[changed] += t * delta
                    if self.sum_of_inverse_distances is not None:
                        self.sum_of_inverse_distances[changed] += delta / t
                    self._counts[changed] = new_counts
                self.neighbourhood_function.append(
                    float(self._counts.sum()))
        return self.modified

    def run(self, upper_bound: int = -1, threshold: float = -1.0
            ) -> List[float]:
        """Iterate until no counter changes, the NF stabilises below
        ``threshold`` relative change, or ``upper_bound`` iterations."""
        if upper_bound < 0:
            upper_bound = self.g.num_nodes
        while self.iteration < upper_bound:
            self.iterate()
            if self.modified == 0:
                break
            if threshold >= 0 and len(self.neighbourhood_function) >= 2:
                a, b = self.neighbourhood_function[-2:]
                if a != 0 and abs(b - a) / a < threshold:
                    break
        return self.neighbourhood_function

    def reachable_counts(self) -> torch.Tensor:
        """Per-node reachable-set size estimates, float64 on the device."""
        return self._counts.clone()


def sequential_hyperball(g: CSRGraph, log2m: int = 6, seed: int = 0,
                         iterations: int = -1) -> np.ndarray:
    """The scalar oracle: the same registers computed node by node on the
    host in numpy (the test SequentialHyperBall, SURVEY §4.4), from host
    copies of the graph.  Returns the final uint8 register matrix."""
    n = g.num_nodes
    off = g.offsets.cpu().numpy()
    succ = g.succ.cpu().numpy().astype(np.int64)
    regs = hyperloglog_init(n, log2m, seed)
    if iterations < 0:
        iterations = n
    for _ in range(iterations):
        new = regs.copy()
        for x in range(n):
            ys = succ[off[x]:off[x + 1]]
            if len(ys):
                new[x] = np.maximum(new[x], regs[ys].max(axis=0))
        if np.array_equal(new, regs):
            break
        regs = new
    return regs


def effective_diameter(neighbourhood_function, alpha: float = 0.9) -> float:
    """Effective diameter at fraction ``alpha`` of a neighbourhood function
    (EstimateEffectiveDiameter): the interpolated t where NF(t) reaches
    alpha * NF(inf)."""
    nf = list(neighbourhood_function)
    if not nf:
        return 0.0
    target = alpha * nf[-1]
    for t in range(len(nf)):
        if nf[t] >= target:
            if t == 0:
                return 0.0
            prev, cur = nf[t - 1], nf[t]
            if cur == prev:
                return float(t)
            return (t - 1) + (target - prev) / (cur - prev)
    return float(len(nf) - 1)
