"""Compressed inverted-index query engine on the card.

``builder`` turns per-term sorted docid lists into a block-compressed
index (vbyte, skip tables per block, per-posting impact streams);
``query`` runs conjunctive (AND), disjunctive (OR) and top-k scored
queries (TAAT, driver DAAT, MaxScore) as decode→intersect→score
pipelines over the CUDA kernels.

``ingest`` + ``wal`` make the index mutable: a WAL-backed
:class:`~repro_torch.index.ingest.LiveIndex` layers an uncompressed delta
(+ tombstones) over an immutable segment resident on the card, drains it
through ``build_index(format="auto")`` in crash-safe merges, and recovers
to the exact acknowledged state from any crash. Its directory and WAL
formats are the reference's.
"""
from .builder import (  # noqa: F401
    InvertedIndex,
    TermPostings,
    build_index,
    impact_value,
    quantize_impacts,
)
from .ingest import (  # noqa: F401
    CRASH_POINTS,
    CrashPoint,
    LiveIndex,
    Snapshot,
)
from .query import (  # noqa: F401
    QueryStats,
    conjunctive,
    disjunctive,
    topk,
)
from .wal import (  # noqa: F401
    WalWriter,
    open_wal,
    read_wal,
)
