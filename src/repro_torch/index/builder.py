"""Inverted-index construction over the compressed-array stack.

One :class:`TermPostings` per term: the sorted docid list d-gap-coded into
a blocked :class:`~repro_torch.core.CompressedIntArray`
(``differential=True`` — per-block ``bases`` make every block
independently decodable, the classic skip-block layout), a **skip table**
(``first_doc``/``last_doc`` per block, host numpy) so the query engine
prunes at block granularity before anything is decoded, and the document
frequency for term ordering and impact scoring.

Scoring uses **quantized impacts**: each term's BM25 idf is quantized to
an integer in ``[1, 2^impact_bits)``, scaled per posting by the BM25 tf
saturation ``tf·(k1+1)/(tf+k1)`` when term frequencies are supplied. The
per-posting impacts are a second blocked array (``differential=False``)
whose blocks align 1:1 with the docid-gap blocks, plus a per-block
``max_impact`` column — the block-max bound that drives MaxScore. Integer
impacts make score accumulation exact, so every decode plan gives
bit-identical scores.

The compressed streams live on the index's device (the card by default);
the skip tables, ``max_impact`` and ``counts_host`` stay on the host,
where the query engine reads them without waiting on the device.

``format`` is one codec for every list (``"vbyte"``, ``"streamvbyte"``,
``"binpack"``) or ``"auto"``: the shortest-path block partition of
``index.partition`` per list, which gives each term its own codec and its
own variable-count block boundaries. The emitted arrays are ordinary
uniform-``block_size`` ``CompressedIntArray``s (counts ≤ block_size mask
the tails), so the query engine serves a mixed-codec index unchanged.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core import CompressedIntArray
from repro_torch.core.compressed_array import _check_format
from repro_torch.core.vbyte import prepare_blocked

from .partition import choose_partition, encode_partitioned

MAX_DOCID = (1 << 31) - 1  # the membership epilogue compares in int32
BM25_K1 = 1.2  # tf-saturation shape; sat(1) == 1 exactly


@dataclass(frozen=True, eq=False)
class TermPostings:
    """One term's compressed posting list + block skip table."""

    term: int
    arr: CompressedIntArray  # d-gap coded, differential=True
    first_doc: np.ndarray  # uint32 [n_live_blocks] first docid per block
    last_doc: np.ndarray  # uint32 [n_live_blocks] last docid per block
    df: int  # document frequency (= arr.n)
    impacts: CompressedIntArray | None = None  # per-posting quantized
    #   impacts, differential=False, blocks aligned 1:1 with ``arr``
    max_impact: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32))  # int32 per block

    @property
    def n_blocks(self) -> int:
        """Live (non-padding) blocks — the skip table's length."""
        return len(self.first_doc)

    @property
    def ub(self) -> int:
        """Term score upper bound: the largest block-max impact."""
        return int(self.max_impact.max()) if self.max_impact.size else 0


@dataclass
class InvertedIndex:
    """Term id → compressed postings, plus collection-level stats."""

    terms: dict[int, TermPostings]
    n_docs: int  # collection size N (docid universe)
    block_size: int
    format: str
    impact_bits: int = 8
    has_tf: bool = False  # were real per-posting tfs supplied at build?

    def __contains__(self, term: int) -> bool:
        return term in self.terms

    def df(self, term: int) -> int:
        tp = self.terms.get(term)
        return tp.df if tp is not None else 0

    def impact(self, term: int) -> int:
        """Quantized tf-free integer impact in ``[1, 2^impact_bits)``."""
        return impact_value(self.n_docs, self.df(term), self.impact_bits)

    @property
    def n_terms(self) -> int:
        return len(self.terms)

    @property
    def n_postings(self) -> int:
        return sum(tp.df for tp in self.terms.values())

    @property
    def bits_per_int(self) -> float:
        """Corpus-weighted compressed bits per posting (paper §V metric)."""
        total_bits = sum(tp.arr.bits_per_int * tp.df
                         for tp in self.terms.values() if tp.df)
        return total_bits / max(self.n_postings, 1)

    @property
    def device(self):
        return next(iter(self.terms.values())).arr.device if self.terms \
            else None

    def stats(self) -> dict:
        blocks = sum(tp.arr.n_blocks for tp in self.terms.values())
        return {"n_terms": self.n_terms, "n_postings": self.n_postings,
                "n_blocks": blocks, "format": self.format,
                "block_size": self.block_size,
                "bits_per_int": round(self.bits_per_int, 2),
                "has_tf": self.has_tf}

    def to(self, device) -> "InvertedIndex":
        """The same index with every compressed stream on ``device``."""
        dev = resolve_device(device)
        terms = {t: replace(tp, arr=tp.arr.to(dev),
                            impacts=(tp.impacts.to(dev)
                                     if tp.impacts is not None else None))
                 for t, tp in self.terms.items()}
        return replace(self, terms=terms)


def impact_value(n_docs: int, df: int, impact_bits: int = 8) -> int:
    """The quantized tf-free impact as a pure function of ``(n_docs, df)``,
    scaled against the rarest possible term (df=1)."""
    if df == 0:
        return 0
    idf = math.log1p((n_docs - df + 0.5) / (df + 0.5))
    idf_max = math.log1p((n_docs - 0.5) / 1.5)
    q = round(idf / idf_max * ((1 << impact_bits) - 1))
    return max(1, int(q))


def quantize_impacts(base_impact: int, tfs, impact_bits: int = 8,
                     k1: float = BM25_K1) -> np.ndarray:
    """Per-posting quantized impacts: ``base_impact`` scaled by the BM25 tf
    saturation ``tf·(k1+1)/(tf+k1)``, rounded and clipped to
    ``[1, 2^impact_bits)``. ``sat(1) == 1`` exactly."""
    tf = np.asarray(tfs, dtype=np.float64)
    sat = tf * (k1 + 1.0) / (tf + k1)
    q = np.rint(base_impact * sat)
    return np.clip(q, 1, (1 << impact_bits) - 1).astype(np.int32)


def _block_max(vals: np.ndarray, block_size: int) -> np.ndarray:
    """Per-block max of ``vals`` (int32) — the ``max_impact`` column."""
    n = len(vals)
    if n == 0:
        return np.zeros(0, np.int32)
    nb = -(-n // block_size)
    pad = np.zeros(nb * block_size, np.int32)
    pad[:n] = vals
    return pad.reshape(nb, block_size).max(axis=1)


def _check_docids(term, docs) -> np.ndarray:
    """Validate one docid list: integer dtype, in-range, increasing."""
    d = np.asarray(docs).ravel()
    if d.size == 0:
        return np.zeros(0, np.uint64)
    if d.dtype.kind not in "iu":
        raise ValueError(
            f"term {term}: docids must have an integer dtype, got "
            f"{d.dtype} — refusing to silently truncate")
    if d.dtype.kind == "i" and int(d.min()) < 0:
        raise ValueError(f"term {term}: docids must be non-negative")
    d = d.astype(np.uint64)
    if int(d.max()) > MAX_DOCID:
        raise ValueError(
            f"term {term}: docids must be < 2^31 (got {d.max()}) — "
            "the membership epilogue compares in int32")
    if np.any(np.diff(d.astype(np.int64)) <= 0):
        raise ValueError(f"term {term}: docids must be strictly increasing")
    return d


def build_index(
    lists,
    *,
    tfs=None,
    format: str = "vbyte",
    block_size: int = 128,
    n_docs: int | None = None,
    impact_bits: int = 8,
    stride_multiple: int = 128,
    checksum: bool = False,
    device=None,
) -> InvertedIndex:
    """Build a compressed inverted index from per-term docid lists.

    ``lists`` is a ``{term: sorted_docids}`` mapping or a sequence (term =
    position), each list strictly increasing docids < 2^31. ``tfs``
    optionally supplies per-posting term frequencies (≥ 1), aligned with
    the docid lists; terms without one get tf=1 everywhere. ``n_docs``
    defaults to ``max docid + 1``. ``checksum=True`` writes the per-block
    checksum column on both streams. Encoding runs on the host; the
    streams are placed on ``device`` (default: the card).

    ``format="auto"`` chooses each list's partition and codec
    (:func:`~repro_torch.index.partition.choose_partition`); docids and
    impacts are encoded over the same bounds, so their blocks align 1:1,
    and the skip table and ``max_impact`` follow the partition's blocks.
    """
    if format != "auto":
        _check_format(format)
    dev = resolve_device(device)
    if not isinstance(lists, dict):
        lists = dict(enumerate(lists))
    if tfs is not None and not isinstance(tfs, dict):
        tfs = dict(enumerate(tfs))
    docids: dict[int, np.ndarray] = {}
    tf_arrs: dict[int, np.ndarray] = {}
    max_doc = -1
    for term, docs in lists.items():
        d = _check_docids(term, docs)
        if d.size:
            max_doc = max(max_doc, int(d.max()))
        docids[term] = d
        tf = None if tfs is None else tfs.get(term)
        if tf is not None:
            t = np.asarray(tf).ravel()
            if t.dtype.kind not in "iu":
                raise ValueError(
                    f"term {term}: tfs must have an integer dtype, got "
                    f"{t.dtype}")
            if t.size != d.size:
                raise ValueError(
                    f"term {term}: tfs length {t.size} != docids "
                    f"length {d.size}")
            if t.size and int(t.min()) < 1:
                raise ValueError(f"term {term}: tfs must be ≥ 1")
            tf_arrs[term] = t.astype(np.int64)
    if n_docs is None:
        n_docs = max_doc + 1 if max_doc >= 0 else 1
    if n_docs > MAX_DOCID + 1:
        raise ValueError("n_docs must be ≤ 2^31")
    index = InvertedIndex(terms={}, n_docs=int(n_docs),
                          block_size=block_size, format=format,
                          impact_bits=impact_bits, has_tf=bool(tf_arrs))
    enc_kw = dict(block_size=block_size, stride_multiple=stride_multiple,
                  checksum=checksum, device=dev)
    for term, d in docids.items():
        df = int(d.size)
        tf = tf_arrs.get(term, np.ones(d.size, np.int64))
        q = quantize_impacts(impact_value(index.n_docs, df, impact_bits), tf,
                             impact_bits)
        if format == "auto":
            part = choose_partition(d, block_size=block_size)
            b = part.bounds
            arr = encode_partitioned(d, b, format=part.format,
                                     differential=True, **enc_kw)
            # impacts share the docid stream's partition so blocks stay
            # aligned 1:1 (MaxScore's block-max column indexes both)
            imp = encode_partitioned(q.astype(np.uint64), b,
                                     format=part.format, differential=False,
                                     **enc_kw)
            if df:
                first = d[b[:-1]].astype(np.uint32)
                last = d[b[1:] - 1].astype(np.uint32)
                mi = np.array([int(q[i:j].max(initial=0))
                               for i, j in zip(b[:-1], b[1:])], np.int32)
            else:
                first = last = np.zeros(0, np.uint32)
                mi = np.zeros(0, np.int32)
        else:
            # one metadata pass shared by the payload encode and the skip
            # table
            meta = prepare_blocked(d, block_size=block_size,
                                   differential=True)
            arr = CompressedIntArray.encode(format=format, differential=True,
                                            meta=meta, **enc_kw)
            first, last = meta.skip_table()
            imeta = prepare_blocked(q.astype(np.uint64),
                                    block_size=block_size, differential=False)
            imp = CompressedIntArray.encode(format=format, differential=False,
                                            meta=imeta, **enc_kw)
            mi = _block_max(q, block_size)
        index.terms[term] = TermPostings(
            term=term, arr=arr, first_doc=first, last_doc=last, df=df,
            impacts=imp, max_impact=mi)
    return index
