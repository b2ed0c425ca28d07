"""Labelled graphs on a device (SURVEY §2.3).

Counterpart of ``webgraph_tpu/labelling``: arc labels serialized into a
separate bit stream next to any underlying graph.

- :class:`Label` hierarchy -- the prototypes and the host surface:
  self-delimiting bit-stream serialization given the source node,
  fixed-width detection, ObjectParser-style spec strings (Label.java:45-62,
  :264).
- :class:`ArcLabelledGraph` -- a ``CSRGraph`` and its labels as tensors on
  its device: int64 per arc, or ``(counts, entries)`` for list labels.
- :class:`BitStreamArcLabelledGraph` -- the ``.labels`` + ``.labeloffsets``
  + ``.properties`` on-disk family wrapping an underlying graph
  (BitStreamArcLabelledImmutableGraph.java:66-120 format); ``to_device``
  takes it to the card.
- union / relabelling / semiring composition / label filters
  (UnionArcLabelledImmutableGraph, ArcRelabelledImmutableGraph,
  LabelSemiring, IntegerLabelFilter) as tensor functions, their merges
  over batches of scalar or list labels (``concat_lists``, the
  concatenation of list labels).
"""

from .labels import (
    FixedWidthIntLabel,
    FixedWidthIntListLabel,
    FixedWidthLongListLabel,
    GammaCodedIntLabel,
    Label,
    label_from_spec,
)
from .graph import (
    ArcLabelledGraph,
    BitStreamArcLabelledGraph,
    LabelSemiring,
    concat_lists,
    integer_label_filter,
    relabel,
    union_labelled,
)
from .triples import integer_triples_graph, store_integer_triples

__all__ = [
    "Label", "FixedWidthIntLabel", "FixedWidthIntListLabel",
    "FixedWidthLongListLabel", "GammaCodedIntLabel", "label_from_spec",
    "ArcLabelledGraph", "BitStreamArcLabelledGraph", "union_labelled",
    "relabel", "LabelSemiring", "integer_label_filter", "concat_lists",
    "integer_triples_graph", "store_integer_triples",
]
