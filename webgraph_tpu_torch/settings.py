"""BVGraph compression settings and code identifiers.

The port's own copy of the JAX package's ``BVGraphSettings`` and
``CompressionFlags`` (``webgraph_tpu/codecs/bvgraph.py:47-268``): the fields
that the plan, the kernels and the host library read, the flag mask that
``.properties`` files carry (``compressionflags``), and the per-component
code readers and writers of the host codec (``codecs/bvgraph.py``).  Every
function of the port takes any object with these fields, so the JAX
package's settings work as well.
"""

from __future__ import annotations

from dataclasses import dataclass


class CompressionFlags:
    """Code identifiers (CompressionFlags.java:23-47) and flag-mask layout
    (BVGraph.java:476-524: 4-bit nibbles at shifts 0/4/8/12/16/20 for
    outdegrees/blocks/residuals/references/blockCount/offsets)."""

    NONE = 0
    DELTA = 1
    GAMMA = 2
    GOLOMB = 3
    SKEWED_GOLOMB = 4
    UNARY = 5
    ZETA = 6
    NIBBLE = 7

    CODING_NAME = {DELTA: "DELTA", GAMMA: "GAMMA", GOLOMB: "GOLOMB",
                   SKEWED_GOLOMB: "SKEWED_GOLOMB", UNARY: "UNARY",
                   ZETA: "ZETA", NIBBLE: "NIBBLE"}
    NAME_CODING = {v: k for k, v in CODING_NAME.items()}

    COMPONENT_SHIFT = {"outdegrees": 0, "blocks": 4, "residuals": 8,
                       "references": 12, "blockcount": 16, "offsets": 20}
    COMPONENT_FLAG_NAME = {"outdegrees": "OUTDEGREES", "blocks": "BLOCKS",
                           "residuals": "RESIDUALS", "references": "REFERENCES",
                           "blockcount": "BLOCK_COUNT", "offsets": "OFFSETS"}


_C = CompressionFlags


@dataclass
class BVGraphSettings:
    """Compression parameters and per-component codings; defaults follow
    BVGraph.java:455-473 and :527-542."""

    window_size: int = 7
    max_ref_count: int = 3
    min_interval_length: int = 4
    zeta_k: int = 3
    outdegree_coding: int = _C.GAMMA
    block_coding: int = _C.GAMMA
    residual_coding: int = _C.ZETA
    reference_coding: int = _C.UNARY
    block_count_coding: int = _C.GAMMA
    offset_coding: int = _C.GAMMA

    # -- flag mask <-> codings (BVGraph.java:1281-1331) -------------------

    def flags(self) -> int:
        defaults = BVGraphSettings()
        mask = 0
        for comp, shift in _C.COMPONENT_SHIFT.items():
            attr = _ATTR_OF_COMPONENT[comp]
            mine, dflt = getattr(self, attr), getattr(defaults, attr)
            if mine != dflt:
                mask |= mine << shift
        return mask

    def flags_string(self) -> str:
        parts = []
        mask = self.flags()
        for comp in ("outdegrees", "blocks", "residuals", "references",
                     "blockcount", "offsets"):
            nib = (mask >> _C.COMPONENT_SHIFT[comp]) & 0xF
            if nib:
                parts.append(f"{_C.COMPONENT_FLAG_NAME[comp]}_"
                             f"{_C.CODING_NAME[nib]}")
        return " | ".join(parts)

    @staticmethod
    def from_flags_string(s: str) -> "BVGraphSettings":
        settings = BVGraphSettings()
        if not s or not s.strip():
            return settings
        for token in s.split("|"):
            token = token.strip()
            if not token:
                continue
            for comp, flag_name in _C.COMPONENT_FLAG_NAME.items():
                if token.startswith(flag_name + "_"):
                    coding = _C.NAME_CODING[token[len(flag_name) + 1:]]
                    setattr(settings, _ATTR_OF_COMPONENT[comp], coding)
                    break
            else:
                raise IOError(f"Compression flag {token!r} unknown")
        return settings

    # -- component readers/writers (ops/bitio BitReader / BitWriter) ------

    def read_outdegree(self, r) -> int:
        c = self.outdegree_coding
        if c == _C.GAMMA:
            return r.read_gamma()
        if c == _C.DELTA:
            return r.read_delta()
        raise NotImplementedError(f"outdegree coding {c}")

    def write_outdegree(self, w, d: int) -> int:
        c = self.outdegree_coding
        if c == _C.GAMMA:
            return w.write_gamma(d)
        if c == _C.DELTA:
            return w.write_delta(d)
        raise NotImplementedError(f"outdegree coding {c}")

    def read_reference(self, r) -> int:
        c = self.reference_coding
        if c == _C.UNARY:
            ref = r.read_unary()
        elif c == _C.GAMMA:
            ref = r.read_gamma()
        elif c == _C.DELTA:
            ref = r.read_delta()
        else:
            raise NotImplementedError(f"reference coding {c}")
        if ref > self.window_size:
            raise ValueError("reference incompatible with window size")
        return ref

    def write_reference(self, w, ref: int) -> int:
        c = self.reference_coding
        if c == _C.UNARY:
            return w.write_unary(ref)
        if c == _C.GAMMA:
            return w.write_gamma(ref)
        if c == _C.DELTA:
            return w.write_delta(ref)
        raise NotImplementedError(f"reference coding {c}")

    def read_block_count(self, r) -> int:
        return _read_udg(r, self.block_count_coding, "block count")

    def write_block_count(self, w, x: int) -> int:
        return _write_udg(w, self.block_count_coding, x, "block count")

    def read_block(self, r) -> int:
        return _read_udg(r, self.block_coding, "block")

    def write_block(self, w, x: int) -> int:
        return _write_udg(w, self.block_coding, x, "block")

    def read_residual(self, r) -> int:
        c = self.residual_coding
        if c == _C.ZETA:
            return r.read_zeta(self.zeta_k)
        if c == _C.GAMMA:
            return r.read_gamma()
        if c == _C.DELTA:
            return r.read_delta()
        if c == _C.GOLOMB:
            return r.read_golomb(self.zeta_k)
        if c == _C.NIBBLE:
            return r.read_nibble()
        raise NotImplementedError(f"residual coding {c}")

    def write_residual(self, w, x: int) -> int:
        c = self.residual_coding
        if c == _C.ZETA:
            return w.write_zeta(x, self.zeta_k)
        if c == _C.GAMMA:
            return w.write_gamma(x)
        if c == _C.DELTA:
            return w.write_delta(x)
        if c == _C.GOLOMB:
            return w.write_golomb(x, self.zeta_k)
        if c == _C.NIBBLE:
            return w.write_nibble(x)
        raise NotImplementedError(f"residual coding {c}")

    def read_offset(self, r) -> int:
        c = self.offset_coding
        if c == _C.GAMMA:
            return r.read_gamma()
        if c == _C.DELTA:
            return r.read_delta()
        raise NotImplementedError(f"offset coding {c}")

    def write_offset(self, w, x: int) -> int:
        c = self.offset_coding
        if c == _C.GAMMA:
            return w.write_gamma(x)
        if c == _C.DELTA:
            return w.write_delta(x)
        raise NotImplementedError(f"offset coding {c}")


def _read_udg(r, c: int, what: str) -> int:
    """A unary, gamma or delta code (the block and block-count codings)."""
    if c == _C.UNARY:
        return r.read_unary()
    if c == _C.GAMMA:
        return r.read_gamma()
    if c == _C.DELTA:
        return r.read_delta()
    raise NotImplementedError(f"{what} coding {c}")


def _write_udg(w, c: int, x: int, what: str) -> int:
    if c == _C.UNARY:
        return w.write_unary(x)
    if c == _C.GAMMA:
        return w.write_gamma(x)
    if c == _C.DELTA:
        return w.write_delta(x)
    raise NotImplementedError(f"{what} coding {c}")


_ATTR_OF_COMPONENT = {
    "outdegrees": "outdegree_coding",
    "blocks": "block_coding",
    "residuals": "residual_coding",
    "references": "reference_coding",
    "blockcount": "block_count_coding",
    "offsets": "offset_coding",
}
