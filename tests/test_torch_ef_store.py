"""The port's EFGraph device store and device decode against the plain
reference of the format (``benchmark/reference/efgraph.py``).

- ``EFGraph.store(backend="cuda")``, run on CPU tensors here, writes the
  bytes of ``backend="numpy"`` (``.graph``, ``.offsets``; ``.properties``
  bar the date line), in one chunk and in chunks of a few arcs, for log2
  quanta 2 to 8, upper bounds n and above, hub lists that get skip
  pointers, empty lists and an empty graph;
- every node's stored entry is the reference encoder's, bit for bit, its
  length the reference's closed form, and the reference decoder reads it
  back to the list;
- ``EFDevicePlan.decode`` on the CPU gives back the input and what the
  reference decoder reads;
- the device store refuses the lists EF cannot hold, as the numpy one does.

The ``gpu`` cases (skipped without a card) hold the store on the card
byte-equal to the numpy store.  Nothing here imports jax; every comparison
is exact.
"""

import os

import numpy as np
import pytest
import torch

from benchmark.reference import efgraph as R
from webgraph_tpu_torch.codecs import efgraph as PE
from webgraph_tpu_torch.codecs.efgraph import EFGraph
from webgraph_tpu_torch.core.graph import CSRGraph
from webgraph_tpu_torch.ops.efdecode import EFDevicePlan

CPU = torch.device("cpu")


def _graph(n, seed, hubs=2, u=None, max_deg=12):
    """Seeded random lists below ``u`` (n when None): short lists, some
    empty, and ``hubs`` lists of min(n, u) / 2 values (skip pointers)."""
    rng = np.random.default_rng(seed)
    u = n if u is None else u
    lists = []
    for x in range(n):
        hub = hubs and x % max(1, n // hubs) == 0
        d = min(min(n, u) // 2 if hub else int(rng.integers(0, max_deg)), u)
        lists.append(np.sort(rng.choice(u, size=d, replace=False)))
    return lists, CSRGraph.from_lists(lists, device=CPU)


def _files(base):
    with open(base + ".graph", "rb") as f:
        g = f.read()
    with open(base + ".offsets", "rb") as f:
        o = f.read()
    with open(base + ".properties") as f:
        p = [ln for ln in f.read().splitlines() if not ln.startswith("#")]
    return g, o, p


def _store_both(g, tmp_path, **kw):
    a, b = str(tmp_path / "numpy"), str(tmp_path / "cuda")
    EFGraph.store(g, a, **kw)
    EFGraph.store(g, b, backend="cuda", device=CPU, **kw)
    assert _files(a) == _files(b)
    return b


def _check_against_reference(lists, base, u, q):
    ef = EFGraph.load(base)
    d = torch.tensor([len(x) for x in lists], dtype=torch.int64)
    np.testing.assert_array_equal(np.diff(ef.offsets),
                                  R.entry_bits(d, u, q).numpy())
    bits = []
    for x, lst in enumerate(lists):
        entry = R.stored_bits(ef.words, int(ef.offsets[x]),
                              int(ef.offsets[x + 1]))
        assert entry == R.encode_list(lst, u, q), x
        assert R.decode_entry(entry, u, q) == lst.tolist(), x
        bits += entry
    # the whole stream is the entries end to end, zero-padded to a word
    want = np.zeros(len(bits) // 64 + 1, dtype=np.uint64)
    for i, b in enumerate(bits):
        if b:
            want[i // 64] |= np.uint64(1) << np.uint64(i % 64)
    np.testing.assert_array_equal(ef.words, want)
    return ef


@pytest.mark.parametrize("q", [2, 3, 4, 6, 8])
@pytest.mark.parametrize("upper", ["n", "above", "wide"])
def test_store_matches_reference(tmp_path, q, upper):
    n = 300
    u = {"n": n, "above": 3 * n + 7, "wide": 1 << 30}[upper]
    lists, g = _graph(n, seed=q * 7 + len(upper), hubs=3, u=u)
    base = _store_both(g, tmp_path, log2_quantum=q,
                       upper_bound=-1 if upper == "n" else u)
    _check_against_reference(lists, base, u, q)


def test_hub_lists_have_pointers(tmp_path):
    """At quantum 256 a hub of half of [0, n) holds skip pointers, and the
    store writes them as the reference does."""
    n = 3000
    lists, g = _graph(n, seed=11, hubs=4)
    cl = n // 2 + 1
    l = max(0, (n // cl).bit_length() - 1)
    assert (n >> l) >> 8 > 0
    base = _store_both(g, tmp_path, log2_quantum=8)
    _check_against_reference(lists, base, n, 8)


@pytest.mark.parametrize("chunk", [1, 5, 64])
def test_store_in_chunks(tmp_path, monkeypatch, chunk):
    lists, g = _graph(200, seed=chunk, hubs=2)
    monkeypatch.setattr(PE, "_STORE_CHUNK_ARCS", chunk)
    base = _store_both(g, tmp_path, log2_quantum=2)
    _check_against_reference(lists, base, 200, 2)


@pytest.mark.parametrize("lists", [[], [[], [], []], [[0, 2], [], [1]],
                                   [[1, 2], [], [0, 3], [3]]])
@pytest.mark.parametrize("q", [0, 8])
def test_store_small_and_empty(tmp_path, lists, q):
    g = CSRGraph.from_lists([np.asarray(x, dtype=np.int64) for x in lists],
                            device=CPU)
    base = _store_both(g, tmp_path, log2_quantum=q)
    if lists:
        _check_against_reference(
            [np.asarray(x, dtype=np.int64) for x in lists], base,
            len(lists), q)


def test_store_big_endian_and_host_graph(tmp_path):
    """Big-endian words; a graph that is not a ``CSRGraph`` goes through
    its host lists."""
    lists, g = _graph(150, seed=3, hubs=1)

    class Lists:
        num_nodes = g.num_nodes

        def iter_nodes(self):
            return enumerate(lists)

    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    EFGraph.store(g, a, byte_order="big", log2_quantum=4)
    EFGraph.store(Lists(), b, byte_order="big", log2_quantum=4,
                  backend="cuda", device=CPU)
    assert _files(a) == _files(b)


@pytest.mark.parametrize("lists,kw", [
    ([[0, 5], [9]], dict(upper_bound=9)),     # a successor at u
    ([[0, 12], [1]], dict(upper_bound=10)),   # a successor above u
    ([[3, 3]], {}), ([[4, 1]], dict(upper_bound=10)),  # repeated, decreasing
    ([[1]], dict(upper_bound=1 << 32))])      # past the device store's u
def test_device_store_refuses_bad_lists(tmp_path, lists, kw):
    g = CSRGraph.from_lists([np.asarray(x) for x in lists], device=CPU)
    with pytest.raises(ValueError):
        EFGraph.store(g, str(tmp_path / "p"), backend="cuda", device=CPU,
                      **kw)
    assert not os.path.exists(str(tmp_path / "p.graph"))


def test_device_store_defaults_to_the_card(tmp_path, monkeypatch):
    _, g = _graph(20, seed=1, hubs=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        EFGraph.store(g, str(tmp_path / "p"), backend="cuda")


@pytest.mark.parametrize("q,chunk", [(2, 1), (4, 50), (8, 1 << 24)])
def test_decode_matches_reference(tmp_path, q, chunk):
    lists, g = _graph(250, seed=q + chunk, hubs=2)
    base = str(tmp_path / "g")
    EFGraph.store(g, base, backend="cuda", device=CPU, log2_quantum=q)
    ef = EFGraph.load(base)
    co, su = EFDevicePlan(ef.words, ef.offsets, ef.upper_bound,
                          ef.log2_quantum, device=CPU).decode(chunk_arcs=chunk)
    assert torch.equal(co, g.offsets) and torch.equal(su, g.succ)
    for x in range(g.num_nodes):
        entry = R.stored_bits(ef.words, int(ef.offsets[x]),
                              int(ef.offsets[x + 1]))
        assert R.decode_entry(entry, 250, q) == \
            su[co[x]:co[x + 1]].tolist()


def test_reference_against_the_java_transcription():
    """The reference encoder against the JAX package's tests' independent
    transcription of the Java writer (a CPU-only import)."""
    from .test_ef_golden import java_ef_graph_bits
    for seed, q in ((0, 2), (1, 4), (2, 8)):
        lists, _ = _graph(60, seed=seed, hubs=2)
        bits = []
        for lst in lists:
            bits += R.encode_list(lst, 60, q)
        assert bits == java_ef_graph_bits([x.tolist() for x in lists], 60,
                                          60, q)


# -- on the card ----------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("q", [2, 8])
def test_device_store_on_the_card(cuda, tmp_path, q):
    from webgraph_tpu_torch.utils.synth import synthesize_webgraph
    co, su = synthesize_webgraph(200_000, seed=q)
    g = CSRGraph(co, su, device=cuda)
    a, b = str(tmp_path / "numpy"), str(tmp_path / "cuda")
    EFGraph.store(g, a, log2_quantum=q)
    EFGraph.store(g, b, backend="cuda", log2_quantum=q)
    assert _files(a) == _files(b)
    ef = EFGraph.load(b)
    out = EFDevicePlan(ef.words, ef.offsets, ef.upper_bound, ef.log2_quantum,
                       device=cuda).decode()
    assert torch.equal(out[0], g.offsets) and torch.equal(out[1], g.succ)


@pytest.mark.gpu
def test_device_store_hubs_on_the_card(cuda, tmp_path):
    lists, g = _graph(4000, seed=5, hubs=6)
    a, b = str(tmp_path / "numpy"), str(tmp_path / "cuda")
    EFGraph.store(g, a, log2_quantum=4)
    EFGraph.store(CSRGraph(g.offsets, g.succ, device=cuda), b,
                  backend="cuda", log2_quantum=4)
    assert _files(a) == _files(b)
    _check_against_reference(lists, b, 4000, 4)
