"""Label types: the prototypes and the host surface of the labelled graphs.

The port's own copy of ``webgraph_tpu/labelling/labels.py`` (reference
semantics: Label.java:45-62, the serialization contract -- a label is
self-delimiting and receives its source node; FixedWidthIntLabel.java:70-78,
a w-bit unsigned int; GammaCodedIntLabel.java:60-76, gamma-coded;
FixedWidthIntListLabel.java:73-85 / FixedWidthLongListLabel, a gamma length
prefix then w-bit entries).

In the port a labelled graph keeps its labels as tensors
(``labelling/graph.py``); these objects are the prototype that names the
label's type and its stream format, and what ``labels_of(x)`` returns, built
from the tensors.  Their per-label ``to_bitstream``/``from_bitstream`` are
the scalar oracle of the device codec (``ops/labelcodec.py``).

Spec strings follow the reference's ObjectParser convention:
``fully.qualified.ClassName(arg1,arg2)`` with no quoting (Label.java:264).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Type

import numpy as np

from ..ops.bitio import BitReader, BitWriter

__all__ = ["Label", "FixedWidthIntLabel", "FixedWidthIntListLabel",
           "FixedWidthLongListLabel", "GammaCodedIntLabel",
           "label_from_spec", "LABEL_CLASS_REGISTRY"]

LABEL_CLASS_REGISTRY: Dict[str, Type["Label"]] = {}


def register_label_class(*java_names):
    def deco(cls):
        for n in java_names:
            LABEL_CLASS_REGISTRY[n] = cls
        cls.java_class_names = java_names
        return cls

    return deco


class Label:
    """A label attached to an arc: an attribute map with a well-known
    attribute, serializable on a bit stream (Label.java:72+)."""

    key: str

    # -- attribute map ----------------------------------------------------

    def well_known_attribute_key(self) -> str:
        return self.key

    def attribute_keys(self) -> Sequence[str]:
        return (self.key,)

    def get(self, key: Optional[str] = None):
        if key is not None and key != self.key:
            raise KeyError(key)
        return self.value

    # -- serialization ----------------------------------------------------

    def to_bitstream(self, w: BitWriter, source: int) -> int:
        raise NotImplementedError

    def from_bitstream(self, r: BitReader, source: int) -> int:
        raise NotImplementedError

    def fixed_width(self) -> int:
        """Bits per serialized label if constant, else -1."""
        return -1

    def copy(self) -> "Label":
        raise NotImplementedError

    def to_spec(self) -> str:
        raise NotImplementedError

    def __eq__(self, other):
        return (type(self) is type(other) and self.key == other.key
                and np.array_equal(self.value, other.value))

    def __repr__(self):
        return f"{type(self).__name__}({self.key}={self.value})"


@register_label_class(
    "it.unimi.dsi.big.webgraph.labelling.FixedWidthIntLabel",
    "it.unimi.dsi.webgraph.labelling.FixedWidthIntLabel",
)
class FixedWidthIntLabel(Label):
    """A w-bit nonnegative integer (FixedWidthIntLabel.java:39-78)."""

    def __init__(self, key: str, width, value=0):
        width = int(width)
        value = int(value)
        if not (0 <= width <= 31):
            raise ValueError(f"Width out of range: {width}")
        if not (0 <= value < (1 << width)):
            raise ValueError(f"Value out of range: {value}")
        self.key = key
        self.width = width
        self.value = value

    def to_bitstream(self, w: BitWriter, source: int) -> int:
        return w.write_bits(self.value, self.width)

    def from_bitstream(self, r: BitReader, source: int) -> int:
        self.value = r.read_bits(self.width)
        return self.width

    def fixed_width(self) -> int:
        return self.width

    def copy(self):
        return FixedWidthIntLabel(self.key, self.width, self.value)

    def to_spec(self) -> str:
        return (f"it.unimi.dsi.big.webgraph.labelling.FixedWidthIntLabel"
                f"({self.key},{self.width})")


@register_label_class(
    "it.unimi.dsi.big.webgraph.labelling.GammaCodedIntLabel",
    "it.unimi.dsi.webgraph.labelling.GammaCodedIntLabel",
)
class GammaCodedIntLabel(Label):
    """A gamma-coded nonnegative integer (GammaCodedIntLabel.java:60-76)."""

    def __init__(self, key: str, value=0):
        self.key = key
        self.value = int(value)

    def to_bitstream(self, w: BitWriter, source: int) -> int:
        return w.write_gamma(self.value)

    def from_bitstream(self, r: BitReader, source: int) -> int:
        p = r.tell()
        self.value = r.read_gamma()
        return r.tell() - p

    def fixed_width(self) -> int:
        return -1

    def copy(self):
        return GammaCodedIntLabel(self.key, self.value)

    def to_spec(self) -> str:
        return (f"it.unimi.dsi.big.webgraph.labelling.GammaCodedIntLabel"
                f"({self.key})")


class _FixedWidthListLabel(Label):
    _dtype = np.int64
    _max_width = 63

    def __init__(self, key: str, width, value=()):
        width = int(width)
        if not (0 <= width <= self._max_width):
            raise ValueError(f"Width out of range: {width}")
        self.key = key
        self.width = width
        self.value = np.asarray(list(value), dtype=self._dtype)

    def to_bitstream(self, w: BitWriter, source: int) -> int:
        bits = w.write_gamma(len(self.value))
        for v in self.value.tolist():
            bits += w.write_bits(int(v), self.width)
        return bits

    def from_bitstream(self, r: BitReader, source: int) -> int:
        p = r.tell()
        n = r.read_gamma()
        self.value = np.asarray([r.read_bits(self.width) for _ in range(n)],
                                dtype=self._dtype)
        return r.tell() - p

    def fixed_width(self) -> int:
        return -1

    def copy(self):
        return type(self)(self.key, self.width, self.value)

    def to_spec(self) -> str:
        return (f"it.unimi.dsi.big.webgraph.labelling.{type(self).__name__}"
                f"({self.key},{self.width})")


@register_label_class(
    "it.unimi.dsi.big.webgraph.labelling.FixedWidthIntListLabel",
    "it.unimi.dsi.webgraph.labelling.FixedWidthIntListLabel",
)
class FixedWidthIntListLabel(_FixedWidthListLabel):
    """A list of w-bit ints, gamma length prefix
    (FixedWidthIntListLabel.java:73-85)."""
    _dtype = np.int64
    _max_width = 31


@register_label_class(
    "it.unimi.dsi.big.webgraph.labelling.FixedWidthLongListLabel",
    "it.unimi.dsi.webgraph.labelling.FixedWidthLongListLabel",
)
class FixedWidthLongListLabel(_FixedWidthListLabel):
    """A list of w-bit longs, gamma length prefix."""
    _dtype = np.int64
    _max_width = 63


def label_from_spec(spec: str) -> Label:
    """Instantiate a label prototype from an ObjectParser spec string."""
    spec = spec.strip()
    if "(" in spec:
        cls_name, rest = spec.split("(", 1)
        args = [a.strip() for a in rest.rstrip(")").split(",") if a.strip()]
    else:
        cls_name, args = spec, []
    cls = LABEL_CLASS_REGISTRY.get(cls_name.strip())
    if cls is None:
        raise IOError(f"Unknown label class {cls_name!r}")
    return cls(*args)
