"""Compressed inverted-index query engine on the card.

``builder`` turns per-term sorted docid lists into a block-compressed
index (vbyte, skip tables per block, per-posting impact streams);
``query`` runs conjunctive (AND), disjunctive (OR) and top-k scored
queries (TAAT, driver DAAT, MaxScore) as decode→intersect→score
pipelines over the CUDA kernels.
"""
from .builder import (  # noqa: F401
    InvertedIndex,
    TermPostings,
    build_index,
    impact_value,
    quantize_impacts,
)
from .query import (  # noqa: F401
    QueryStats,
    conjunctive,
    disjunctive,
    topk,
)
