"""Boolean and top-k queries over the compressed inverted index.

The port of ``repro/index/query.py``: the same decisions, the same
accounting, the same results — each decode goes to the card. Every query
is a decode→intersect→score pipeline; posting lists are never
materialized as whole docid arrays unless they ARE the answer:

* **Conjunctive (AND)** — terms ordered by document frequency; the rarest
  term is the *driver* and only its blocks inside the terms' common docid
  window are decoded (``stream`` epilogue, kernel 1). Its docids become
  the probe set, processed in chunks of ≤ ``probe_width``: for every other
  term each probe binary-searches the host skip table and only the blocks
  whose docid range contains a probe are gathered (on the device) and
  decoded by the fused ``membership*`` epilogues (kernel 2), which emit the
  chunk's match bitmap — the larger list's docids never leave the card.
* **Disjunctive (OR)** — the union is the output, so each term's blocks
  are decoded once and merged on the host.
* **Top-k** — ``mode="or"`` scores term-at-a-time over the union decode;
  ``mode="and"`` probes each term's impact per conjunctive candidate;
  ``mode="driver"`` is required-term DAAT through the fused
  ``bm25_accum*``/``bm25_weighted*`` epilogues; ``mode="maxscore"`` is
  block-max dynamic pruning with bit-identical results to ``"or"``: blocks
  and probes whose best case is *strictly* below the running k-th score θ
  are never decoded (ties must still be scored — the final (score desc,
  docid asc) order can rank a tied smaller docid first).

The engine is host-driven: the skip tables, pruning and merges run in
numpy, and each decode's result comes back with one device→host copy
(``.cpu()``), which waits for the card. Impacts are exact int32, so every
plan gives bit-identical scores; ties break by ascending docid.
:class:`QueryStats` counts decoded vs skipped vs threshold-pruned blocks.
With ``use_skip=False`` (an index whose arrays are block-sharded over a
mesh) every pass decodes each whole list in place, once per shard; a
decoded list is gathered to the host, a probe pass's per-block hits are
summed on each shard and only the partials come back.

Telemetry (``repro_torch.obs``) opens the reference's stage spans at the
same sites — ``gallop`` (a probe pass), ``merge`` (a bulk merge pass),
``score``, ``seed`` (MaxScore's θ seeding), ``topk`` and ``topk-select``
— with the reference's attributes. Attributes that need host values are
computed only when a span is recording, and no span waits for the card.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.distributed.sharding import BlockSharded
from repro_torch.kernels.vbyte_decode import dispatch
from repro_torch.kernels.vbyte_decode.ops import normalize_probe
from repro_torch.obs import trace as _trace
from repro_torch.robustness.validate import Deadline  # noqa: F401  (re-exported)

from .builder import InvertedIndex, TermPostings

# maximum probe-set width per membership/scoring pass; chunks are sized
# min(pow2(candidates), this), so pass shapes come from a bounded set
DEFAULT_PROBE_WIDTH = 512
# MaxScore strip ramp: ×8 per round, capped (one small first strip forms θ
# cheaply, then the horizon grows fast)
STRIP_RAMP = 8
MAX_STRIP_BLOCKS = 2048
# MaxScore candidate-scoring crossover: at or below this many candidates a
# term is probed through the row-gathered weighted epilogues; above it,
# bulk decode-and-merge
MERGE_MIN_PROBES = 32


@dataclass
class QueryStats:
    """Decode accounting for one query (pruning evidence).

    ``blocks_decoded + blocks_skipped`` equals the blocks *considered* by
    skip-table routing (per decode/probe pass); ``rows_gathered`` counts
    per-probe row gathers on top; ``blocks_pruned``/``postings_pruned``
    count blocks eliminated by the MaxScore threshold, never decoded by any
    pass, so per term ``per_term_pruned[t] + len(per_term_blocks[t]) ==
    n_blocks(t)``. ``probes_pruned`` counts (candidate × term) probes
    settled by the score bound alone; ``impact_ints_decoded`` counts
    per-posting impacts decoded from the weight streams. A deadline that
    expires mid-query marks the result ``degraded``; the robustness fields
    (``errors``, ``retries``, ``quarantined_blocks``, ``bound_fallbacks``)
    are filled in by the hardened ``SearchEngine``; the live-index fields
    (``delta_postings``, ``delta_hits``, ``tombstones_applied``) by
    :class:`~repro_torch.index.ingest.LiveIndex`.
    """

    blocks_decoded: int = 0
    blocks_skipped: int = 0
    blocks_pruned: int = 0  # MaxScore threshold-pruned, never decoded
    rows_gathered: int = 0  # per-probe row gathers (duplicates included)
    ints_decoded: int = 0  # valid integers in decoded blocks/rows
    impact_ints_decoded: int = 0  # per-posting impacts decoded alongside
    postings_pruned: int = 0  # postings inside threshold-pruned blocks
    probes_pruned: int = 0  # candidate×term probes settled by bound alone
    decode_calls: int = 0
    per_term_decoded: dict = field(default_factory=dict)
    per_term_pruned: dict = field(default_factory=dict)
    per_term_blocks: dict = field(default_factory=dict)  # term -> set of
    #   live block rows decoded at least once (strip-pulled or gathered)
    # robustness accounting: a degraded result is still correct over the
    # work that ran — smaller, never silently wrong
    errors: int = 0  # typed DecodeErrors hit while answering
    retries: int = 0  # transient-failure retries that succeeded
    quarantined_blocks: int = 0  # blocks of quarantined segments not served
    bound_fallbacks: int = 0  # maxscore→TAAT fallbacks (unsafe bounds)
    # live-index accounting (index.ingest): postings served from the
    # uncompressed delta layer, result docs sourced from it, and main-
    # segment postings suppressed by the tombstone set at query time
    delta_postings: int = 0
    delta_hits: int = 0
    tombstones_applied: int = 0
    degraded: bool = False
    degraded_reasons: list = field(default_factory=list)

    def mark_degraded(self, reason: str):
        self.degraded = True
        if reason not in self.degraded_reasons:
            self.degraded_reasons.append(reason)

    def merge(self, other: "QueryStats"):
        """Fold a per-query stats object into this aggregate. Iterates
        ``dataclasses.fields``; a field with no merge rule raises."""
        for f in dataclasses.fields(self):
            mine = getattr(self, f.name)
            theirs = getattr(other, f.name)
            if isinstance(mine, bool):
                setattr(self, f.name, mine or theirs)
            elif isinstance(mine, (int, float)):
                setattr(self, f.name, mine + theirs)
            elif isinstance(mine, dict):
                for t, v in theirs.items():
                    if isinstance(v, (set, frozenset)):
                        mine.setdefault(t, set()).update(v)
                    elif isinstance(v, (int, float)):
                        mine[t] = mine.get(t, 0) + v
                    else:
                        raise TypeError(
                            f"QueryStats.merge: no merge rule for dict "
                            f"field {f.name!r} value of type "
                            f"{type(v).__name__}")
            elif isinstance(mine, list):
                for r in theirs:  # dedup-append (degraded_reasons order)
                    if r not in mine:
                        mine.append(r)
            elif isinstance(mine, set):
                mine.update(theirs)
            else:
                raise TypeError(
                    f"QueryStats.merge: no merge rule for field "
                    f"{f.name!r} of type {type(mine).__name__}")

    def span_attrs(self) -> dict:
        """Flat attribute dict for trace spans: every scalar counter plus
        the degraded flag/reasons; the per-term dicts summarize as sizes."""
        out = {}
        values = vars(self)
        for name, terms_key in _span_fields(type(self)):
            v = values[name]
            t = type(v)  # exact types first: the common case, one lookup
            if t in _SCALARS or isinstance(v, _SCALARS):
                out[name] = v
            elif t is dict or isinstance(v, dict):
                out[terms_key] = len(v)
            elif isinstance(v, list):
                out[name] = list(v)
        return out

    def count(self, term: int, decoded: int, skipped: int, ints: int):
        self.blocks_decoded += decoded
        self.blocks_skipped += skipped
        self.ints_decoded += ints
        self.decode_calls += 1
        self.per_term_decoded[term] = (
            self.per_term_decoded.get(term, 0) + decoded)

    def count_pruned(self, blocks: int, postings: int, term=None):
        self.blocks_pruned += blocks
        self.postings_pruned += postings
        if term is not None:
            self.per_term_pruned[term] = (
                self.per_term_pruned.get(term, 0) + blocks)

    def touch(self, term: int, rows):
        """Record live block rows of ``term`` decoded at least once."""
        self.per_term_blocks.setdefault(term, set()).update(
            int(r) for r in rows)


_SCALARS = (bool, int, float)
_FIELDS: dict = {}


def _span_fields(cls) -> tuple:
    """A dataclass's ``(field name, name_terms)`` pairs, worked out once per
    class (``topk`` spans read every ``QueryStats`` field per query)."""
    names = _FIELDS.get(cls)
    if names is None:
        names = _FIELDS[cls] = tuple((f.name, f"{f.name}_terms")
                                     for f in dataclasses.fields(cls))
    return names


def _pow2(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _expired(deadline: Deadline | None, stats: QueryStats | None,
             where: str) -> bool:
    """Deadline check at a work-unit boundary: expiry only stops *new*
    strips / terms / chunks from starting; the result is flagged."""
    if deadline is None or not deadline.expired():
        return False
    if stats is not None:
        stats.mark_degraded(f"deadline:{where}")
    return True


def _to_host(out) -> np.ndarray:
    """One decode result to the host (waits for the card); a block-sharded
    result is gathered first."""
    if isinstance(out, BlockSharded):
        out = out.gather()
    return out.cpu().numpy()


def _overlap_blocks(tp: TermPostings, lo: int, hi: int) -> tuple[int, int]:
    """Block range ``[i0, i1)`` whose ``[first, last]`` intersects [lo, hi]."""
    i0 = int(np.searchsorted(tp.last_doc, lo, side="left"))
    i1 = int(np.searchsorted(tp.first_doc, hi, side="right"))
    return i0, max(i1, i0)


def _decode_blocks(tp: TermPostings, i0: int, i1: int, *, plan, stats,
                   use_skip: bool) -> np.ndarray:
    """Decode blocks ``[i0, i1)`` of one term to sorted uint32 docids."""
    if not use_skip:
        i0, i1 = 0, tp.n_blocks
    if i1 <= i0:
        return np.zeros(0, np.uint32)
    if use_skip and (i0, i1) != (0, tp.n_blocks):
        sub = tp.arr.slice_blocks(i0, i1, pad_to=_pow2(i1 - i0))
    else:
        # whole list: decode the resident (possibly sharded) array in place
        sub = tp.arr
    if stats is not None:
        stats.count(tp.term, i1 - i0, tp.n_blocks - (i1 - i0), sub.n)
        stats.touch(tp.term, range(i0, i1))
    return sub.decode(plan=plan)


def _decode_impact_stream(tp: TermPostings, *, plan, stats) -> np.ndarray:
    """Decode the whole per-posting impact stream, aligned with the docids."""
    if stats is not None:
        stats.impact_ints_decoded += tp.impacts.n
        stats.decode_calls += 1
    return tp.impacts.decode(plan=plan).astype(np.int64)


def _weight_extras(weights, rows=None, *, pad=None):
    """Format-tagged weight operands (``w_payload``, ``w_control`` +
    ``w_data`` or ``w_widths`` + ``w_data``) for the ``bm25_weighted*``
    epilogues, optionally row-gathered to align with a gathered main
    stream. The format is the impact stream's own: an ``auto`` index mixes
    codecs per term."""
    sub = weights if rows is None else weights.take_blocks(rows, pad_to=pad)
    extras = {f"w_{k}": v for k, v in sub.device_operands().items()
              if k in ("payload", "control", "data", "widths")}
    return extras, sub.n


def _route_probes(tp: TermPostings, chunk: np.ndarray):
    """Per-probe skip-table gallop: ``(ok mask, block id per hit probe)``."""
    pos = np.searchsorted(tp.first_doc, chunk, side="right") - 1
    ok = pos >= 0
    ok &= chunk <= tp.last_doc[np.maximum(pos, 0)]
    return ok, pos[ok]


def _probe_pass(tp: TermPostings, chunk: np.ndarray, *, impact: int,
                probe_width: int, plan, stats, use_skip: bool,
                weights=None, touched=None) -> np.ndarray:
    """Skip-gallop stage span around :func:`_probe_pass_impl`."""
    with _trace("gallop", term=tp.term, probes=len(chunk)) as sp:
        if sp and stats is not None:
            b0, i0 = stats.blocks_decoded, stats.ints_decoded
        out = _probe_pass_impl(tp, chunk, impact=impact,
                               probe_width=probe_width, plan=plan,
                               stats=stats, use_skip=use_skip,
                               weights=weights, touched=touched)
        if sp and stats is not None:
            sp.attrs.update(blocks_decoded=stats.blocks_decoded - b0,
                            ints_decoded=stats.ints_decoded - i0)
        return out


def _probe_pass_impl(tp: TermPostings, chunk: np.ndarray, *, impact: int,
                     probe_width: int, plan, stats, use_skip: bool,
                     weights=None, touched=None) -> np.ndarray:
    """One (term, candidate-chunk) pass: int32 [len(chunk)] per-candidate
    result — the membership bitmap (``impact=0``), the constant bm25 impact
    contribution (``impact>0``), or the exact per-posting impact
    contribution (``weights=`` the term's impact array, decoded in the same
    pass by the ``bm25_weighted*`` epilogues).

    With skip pruning, each hit probe gathers its one candidate block and
    the ``*_rows`` epilogue compares probe t against tile t only. When the
    probes pile into few blocks, each hit block is gathered once and the
    broadcast epilogue runs over the chunk. Without skip pruning the whole
    list decodes under the broadcast epilogue.
    """
    dev = tp.arr.device
    if use_skip:
        ok, rows = _route_probes(tp, chunk)
        if rows.size == 0:  # every probe galloped past: nothing decoded
            if stats is not None:
                stats.count(tp.term, 0, tp.n_blocks, 0)
            return np.zeros(len(chunk), np.int32)
        uniq = np.unique(rows)
        if touched is not None:
            touched.update(uniq.tolist())
        if stats is not None:
            stats.touch(tp.term, uniq)
        res = np.zeros(len(chunk), np.int32)
        if uniq.size * 2 > rows.size:
            # mostly-distinct blocks: one gathered row per probe
            row_ints = int(tp.arr.counts_host[rows].sum())
            if stats is not None:
                stats.count(tp.term, int(uniq.size),
                            tp.n_blocks - int(uniq.size), row_ints)
                stats.rows_gathered += int(rows.size)
            pad = _pow2(rows.size)
            sub = tp.arr.take_blocks(rows, pad_to=pad)
            probe = np.full((pad, 1), -1, np.int32)
            probe[: rows.size, 0] = chunk[ok].astype(np.int32)
            extras = {"probe": torch.as_tensor(probe, device=dev)}
            if weights is not None:
                w_extras, w_ints = _weight_extras(weights, rows, pad=pad)
                extras.update(w_extras)
                if stats is not None:
                    stats.impact_ints_decoded += w_ints
                ep_name = "bm25_weighted_rows"
            elif impact:
                extras["impact"] = torch.tensor([[impact]], dtype=torch.int32,
                                                device=dev)
                ep_name = "bm25_accum_rows"
            else:
                ep_name = "membership_rows"
            out = dispatch.decode(sub, epilogue=ep_name,
                                  epilogue_operands=extras, plan=plan)
            res[ok] = _to_host(out)[: rows.size, 0]
            return res
        # probes pile into few blocks: gather each hit block ONCE and run
        # the broadcast epilogue over the chunk
        if stats is not None:
            stats.count(tp.term, int(uniq.size),
                        tp.n_blocks - int(uniq.size),
                        int(tp.arr.counts_host[uniq].sum()))
        pad = _pow2(uniq.size)
        sub = tp.arr.take_blocks(uniq, pad_to=pad)
        w = _pow2(len(chunk))
        extras = {"probe": torch.as_tensor(normalize_probe(chunk, w),
                                           device=dev)}
        if weights is not None:
            w_extras, w_ints = _weight_extras(weights, uniq, pad=pad)
            extras.update(w_extras)
            if stats is not None:
                stats.impact_ints_decoded += w_ints
            ep_name = "bm25_weighted"
        elif impact:
            extras["impact"] = torch.tensor([[impact]], dtype=torch.int32,
                                            device=dev)
            ep_name = "bm25_accum"
        else:
            ep_name = "membership"
        out = dispatch.decode(sub, epilogue=ep_name,
                              epilogue_operands=extras, plan=plan)
        res[:] = _to_host(out).sum(axis=0, dtype=np.int32)[: len(chunk)]
        return res
    sub = tp.arr
    if touched is not None:
        touched.update(range(tp.n_blocks))
    if stats is not None:
        stats.count(tp.term, tp.n_blocks, 0, sub.n)
        stats.touch(tp.term, range(tp.n_blocks))
    extras = {"probe": torch.as_tensor(normalize_probe(chunk, probe_width),
                                       device=dev)}
    if weights is not None:
        w_extras, w_ints = _weight_extras(weights)
        extras.update(w_extras)
        if stats is not None:
            stats.impact_ints_decoded += w_ints
        ep_name = "bm25_weighted"
    elif impact:
        extras["impact"] = torch.tensor([[impact]], dtype=torch.int32,
                                        device=dev)
        ep_name = "bm25_accum"
    else:
        ep_name = "membership"
    out = dispatch.decode(sub, epilogue=ep_name,
                          epilogue_operands=extras, plan=plan)
    # a docid lives in exactly one block → summing blocks is exact int32
    if isinstance(out, BlockSharded):
        # each shard sums its own blocks where they live: only the [P]
        # partials come to the host, never the [n_blocks, P] output
        out = torch.stack([s.sum(0).to(out.device, non_blocking=True)
                           for s in out.shards])
    return _to_host(out).sum(axis=0, dtype=np.int32)[: len(chunk)]


def _merge_pass(tp: TermPostings, chunk: np.ndarray, *, impact: int,
                plan, stats, weights=None, touched=None) -> np.ndarray:
    """Merge stage span around :func:`_merge_pass_impl`."""
    with _trace("merge", term=tp.term, candidates=len(chunk)) as sp:
        if sp and stats is not None:
            b0, i0 = stats.blocks_decoded, stats.ints_decoded
        out = _merge_pass_impl(tp, chunk, impact=impact, plan=plan,
                               stats=stats, weights=weights,
                               touched=touched)
        if sp and stats is not None:
            sp.attrs.update(blocks_decoded=stats.blocks_decoded - b0,
                            ints_decoded=stats.ints_decoded - i0)
        return out


def _merge_pass_impl(tp: TermPostings, chunk: np.ndarray, *, impact: int,
                     plan, stats, weights=None, touched=None) -> np.ndarray:
    """Bulk variant of :func:`_probe_pass` for candidate sets too large to
    probe: int64 [len(chunk)] per-candidate contribution. Each block that
    contains any candidate decodes exactly once (one gathered decode per
    stream) and membership is a host ``searchsorted`` merge."""
    res = np.zeros(len(chunk), np.int64)
    ok, rows = _route_probes(tp, chunk)
    if rows.size == 0:
        if stats is not None:
            stats.count(tp.term, 0, tp.n_blocks, 0)
        return res
    uniq = np.unique(rows)
    if touched is not None:
        touched.update(uniq.tolist())
    if stats is not None:
        stats.touch(tp.term, uniq)
    pad = _pow2(uniq.size)
    if uniq.size == uniq[-1] - uniq[0] + 1:
        sub = tp.arr.slice_blocks(uniq[0], uniq[-1] + 1, pad_to=pad)
        wsub = (weights.slice_blocks(uniq[0], uniq[-1] + 1, pad_to=pad)
                if weights is not None else None)
    else:
        sub = tp.arr.take_blocks(uniq, pad_to=pad)
        wsub = (weights.take_blocks(uniq, pad_to=pad)
                if weights is not None else None)
    if stats is not None:
        stats.count(tp.term, int(uniq.size),
                    tp.n_blocks - int(uniq.size), sub.n)
    docs = sub.decode(plan=plan)
    if wsub is not None:
        if stats is not None:
            stats.impact_ints_decoded += wsub.n
            stats.decode_calls += 1
        imps = wsub.decode(plan=plan).astype(np.int64)
    else:
        imps = np.full(docs.size, impact, np.int64)
    pos = np.searchsorted(docs, chunk[ok])
    pos = np.minimum(pos, docs.size - 1)
    hit = docs[pos] == chunk[ok]
    vals = np.where(hit, imps[pos], 0)
    res[np.flatnonzero(ok)] = vals
    return res


def _score_term(tp: TermPostings, base_impact: int, cand: np.ndarray,
                sel: np.ndarray, scores: np.ndarray, *, has_tf: bool,
                probe_width: int, plan, stats, touched=None):
    """Add term ``tp``'s exact contribution to ``scores[sel]``: bulk
    decode-and-merge for strip-sized candidate sets, chunked probe
    epilogues for small ones. ``touched`` collects the block rows actually
    gathered, so MaxScore never books a probe-decoded block as pruned."""
    with _trace("score", term=tp.term, candidates=int(sel.size)) as sp:
        if sp and stats is not None:
            b0, i0 = stats.blocks_decoded, stats.ints_decoded
        _score_term_impl(tp, base_impact, cand, sel, scores, has_tf=has_tf,
                         probe_width=probe_width, plan=plan, stats=stats,
                         touched=touched)
        if sp and stats is not None:
            sp.attrs.update(blocks_decoded=stats.blocks_decoded - b0,
                            ints_decoded=stats.ints_decoded - i0)


def _score_term_impl(tp: TermPostings, base_impact: int, cand: np.ndarray,
                     sel: np.ndarray, scores: np.ndarray, *, has_tf: bool,
                     probe_width: int, plan, stats, touched=None):
    wts = tp.impacts if has_tf else None
    if sel.size > MERGE_MIN_PROBES:
        scores[sel] += _merge_pass(
            tp, cand[sel].astype(np.uint32), impact=base_impact,
            plan=plan, stats=stats, weights=wts, touched=touched)
        return
    w = min(_pow2(sel.size), probe_width)
    for s in range(0, sel.size, w):
        ch = sel[s:s + w]
        contrib = _probe_pass(
            tp, cand[ch].astype(np.uint32), impact=base_impact,
            probe_width=w, plan=plan, stats=stats, use_skip=True,
            weights=wts, touched=touched)
        scores[ch] += contrib.astype(np.int64)


def _term_postings(index: InvertedIndex, terms) -> list[TermPostings]:
    out = []
    for t in terms:
        tp = index.terms.get(t)
        out.append(tp if tp is not None
                   else TermPostings(term=t, arr=None,
                                     first_doc=np.zeros(0, np.uint32),
                                     last_doc=np.zeros(0, np.uint32), df=0))
    return out


def conjunctive(
    index: InvertedIndex,
    terms,
    *,
    plan="auto",
    probe_width: int = DEFAULT_PROBE_WIDTH,
    stats: QueryStats | None = None,
    use_skip: bool = True,
    deadline: Deadline | None = None,
) -> np.ndarray:
    """AND query: sorted uint32 docids present in every term's postings.

    On deadline expiry the remaining terms are skipped and the
    intersection-so-far (a superset of the exact answer) is returned,
    flagged degraded via ``stats``.
    """
    if not terms:
        raise ValueError("conjunctive query needs ≥1 term")
    tps = sorted(_term_postings(index, dict.fromkeys(terms)),
                 key=lambda tp: tp.df)
    if tps[0].df == 0:
        return np.zeros(0, np.uint32)
    # common docid window: outside [lo, hi] no doc can be in all terms
    lo = max(int(tp.first_doc[0]) for tp in tps)
    hi = min(int(tp.last_doc[-1]) for tp in tps)
    if lo > hi:
        return np.zeros(0, np.uint32)
    driver, rest = tps[0], tps[1:]
    i0, i1 = _overlap_blocks(driver, lo, hi)
    cand = _decode_blocks(driver, i0, i1, plan=plan, stats=stats,
                          use_skip=use_skip)
    cand = cand[(cand >= lo) & (cand <= hi)]
    for tp in rest:
        if cand.size == 0:
            break
        if _expired(deadline, stats, "and-term"):
            break
        w = min(_pow2(cand.size), probe_width)
        keep = np.zeros(cand.size, bool)
        for s in range(0, cand.size, w):
            if s and _expired(deadline, stats, "and-chunk"):
                keep[s:] = True  # unprobed candidates stay (superset)
                break
            chunk = cand[s:s + w]
            hit = _probe_pass(tp, chunk, impact=0, probe_width=w, plan=plan,
                              stats=stats, use_skip=use_skip)
            keep[s:s + len(chunk)] = hit.astype(bool)
        cand = cand[keep]
    return cand.astype(np.uint32)


def disjunctive(
    index: InvertedIndex,
    terms,
    *,
    plan="auto",
    stats: QueryStats | None = None,
    use_skip: bool = True,
    deadline: Deadline | None = None,
) -> np.ndarray:
    """OR query: sorted uint32 docids present in any term's postings. On
    deadline expiry the union-so-far (a subset) is returned, flagged."""
    if not terms:
        raise ValueError("disjunctive query needs ≥1 term")
    parts = []
    for tp in _term_postings(index, dict.fromkeys(terms)):  # dedup repeats
        if tp.df == 0:
            continue
        if parts and _expired(deadline, stats, "or-term"):
            break
        parts.append(_decode_blocks(tp, 0, tp.n_blocks, plan=plan,
                                    stats=stats, use_skip=use_skip))
    if not parts:
        return np.zeros(0, np.uint32)
    return np.unique(np.concatenate(parts)).astype(np.uint32)


def _taat_scores(index: InvertedIndex, terms, *, plan, stats, use_skip,
                 deadline: Deadline | None = None):
    """Exhaustive TAAT scoring: every term decodes once (the union pass) and
    its impacts scatter onto its own docids. ``(cand int64, scores int64)``,
    exact — the reference every pruned path must match bit for bit."""
    parts = {}
    for t in dict.fromkeys(terms):
        tp = index.terms.get(t)
        if tp is None or tp.df == 0:
            continue
        if parts and _expired(deadline, stats, "taat-term"):
            break
        parts[t] = _decode_blocks(tp, 0, tp.n_blocks, plan=plan,
                                  stats=stats, use_skip=use_skip)
    if not parts:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    with _trace("score", terms=len(parts)):
        cand = np.unique(
            np.concatenate(list(parts.values()))).astype(np.int64)
        scores = np.zeros(cand.size, np.int64)
        for t, docs in parts.items():
            tp = index.terms[t]
            if index.has_tf:
                # per-posting impacts: decode the aligned weight stream
                imps = _decode_impact_stream(tp, plan=plan, stats=stats)
                scores[np.searchsorted(cand, docs.astype(np.int64))] += imps
            else:
                scores[np.searchsorted(cand, docs.astype(np.int64))] \
                    += index.impact(t)
    return cand, scores


class _StripCursor:
    """Per-term DAAT cursor for MaxScore: advances block-aligned strips,
    buffering decoded postings beyond the strip boundary."""

    def __init__(self, tp: TermPostings, has_tf: bool, base_impact: int):
        self.tp = tp
        self.has_tf = has_tf
        self.base_impact = base_impact
        self.i = 0  # next undecoded block
        self.buf_docs = np.zeros(0, np.int64)
        self.buf_imps = np.zeros(0, np.int64)
        self.pruned_rows: list = []  # block rows dropped by θ at pull time

    @property
    def exhausted(self) -> bool:
        return self.i >= self.tp.n_blocks and self.buf_docs.size == 0

    def pull(self, hi: int, theta: int | None, other_ub, *,
             plan, stats: QueryStats):
        """Decode this term's postings ≤ ``hi`` (buffer the overshoot).

        With a threshold, any block whose ``max_impact + other_ub < θ`` is
        pruned and never strip-decoded (strict ``<``: θ-tying blocks stay).
        ``other_ub`` is a scalar or a callable mapping block rows to a
        per-row bound on the other terms' contribution.
        """
        tp = self.tp
        j = int(np.searchsorted(tp.first_doc, hi, side="right"))
        rows = np.arange(self.i, max(j, self.i))
        self.i = max(j, self.i)
        if theta is not None and rows.size:
            ou = other_ub(rows) if callable(other_ub) else other_ub
            beaten = (tp.max_impact[rows].astype(np.int64)
                      + ou < theta)
            if beaten.any():
                self.pruned_rows.append(rows[beaten])
                rows = rows[~beaten]
        if rows.size:
            pad = _pow2(rows.size)
            contiguous = rows.size == rows[-1] - rows[0] + 1
            if contiguous:
                sub = tp.arr.slice_blocks(rows[0], rows[-1] + 1, pad_to=pad)
                wsub = tp.impacts.slice_blocks(rows[0], rows[-1] + 1,
                                               pad_to=pad)
            else:
                sub = tp.arr.take_blocks(rows, pad_to=pad)
                wsub = tp.impacts.take_blocks(rows, pad_to=pad)
            stats.count(tp.term, int(rows.size), 0, sub.n)
            stats.touch(tp.term, rows)
            docs = sub.decode(plan=plan).astype(np.int64)
            if self.has_tf:
                stats.impact_ints_decoded += wsub.n
                stats.decode_calls += 1
                imps = wsub.decode(plan=plan).astype(np.int64)
            else:  # tf-free: the stream would decode to this constant
                imps = np.full(docs.size, self.base_impact, np.int64)
            docs = np.concatenate([self.buf_docs, docs])
            imps = np.concatenate([self.buf_imps, imps])
        else:
            docs, imps = self.buf_docs, self.buf_imps
        cut = int(np.searchsorted(docs, hi, side="right"))
        self.buf_docs, self.buf_imps = docs[cut:], imps[cut:]
        return docs[:cut], imps[:cut]


def _seeded_bound(c, total_ub: int, seed_docs):
    """Per-row bound on the OTHER terms' contribution to cursor ``c``'s
    blocks: a seeded (fully decoded) term whose docids miss a block
    provably contributes 0 to it, so its ub is subtracted."""
    loose = total_ub - c.tp.ub

    def bound(rows: np.ndarray) -> np.ndarray:
        ou = np.full(rows.size, loose, np.int64)
        f = c.tp.first_doc[rows]
        l = c.tp.last_doc[rows]
        for s, ds in seed_docs:
            if s is c:
                continue
            absent = (np.searchsorted(ds, l, side="right")
                      == np.searchsorted(ds, f, side="left"))
            ou -= s.tp.ub * absent
        return ou

    return bound


def _maxscore(index: InvertedIndex, terms, k: int, *, plan, probe_width,
              stats: QueryStats | None, deadline: Deadline | None = None):
    """Block-max pruned disjunctive top-k, bit-exact with
    :func:`_taat_scores` + lexsort: every pruning decision only discards
    work whose best case is *strictly below* the current k-th score θ."""
    st = stats if stats is not None else QueryStats()
    tps = [tp for tp in _term_postings(index, dict.fromkeys(terms))
           if tp.df > 0]
    if not tps:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    for tp in tps:
        if tp.impacts is None or tp.max_impact.size != tp.n_blocks:
            raise ValueError(
                "mode='maxscore' needs per-posting impact streams and the "
                "max_impact skip column — rebuild the index with "
                "build_index (optionally passing tfs=)")
    tps.sort(key=lambda tp: (tp.ub, tp.term))  # ascending upper bound
    ubs = np.array([tp.ub for tp in tps], np.int64)
    cum_ub = np.cumsum(ubs)
    total_ub = int(cum_ub[-1])
    strip_blocks = max(1, probe_width // index.block_size)
    cursors = [_StripCursor(tp, index.has_tf, index.impact(tp.term))
               for tp in tps]
    top_d = np.zeros(0, np.int64)
    top_s = np.zeros(0, np.int64)
    strip = strip_blocks

    # seed θ from the tiny lists: a term whose whole list fits in one strip
    # is decoded and scored exactly up front, probing every other term only
    # at its few docids — θ matures before any long block streams
    seeded = np.zeros(0, np.int64)
    seed_docs = []
    # block rows of each term gathered by probe/merge passes — the exit
    # accounting subtracts these so "pruned" means never decoded anywhere
    touched: dict[int, set] = {}
    if max(tp.n_blocks for tp in tps) > 4 * strip_blocks:
        with _trace("seed"):
            seeds = [c for c in cursors if c.tp.n_blocks <= strip_blocks]
            parts = []
            for c in seeds:
                docs, imps = c.pull(int(c.tp.last_doc[-1]), None, 0,
                                    plan=plan, stats=st)
                if docs.size:
                    parts.append((docs, imps))
                    seed_docs.append((c, docs))
            if parts:
                cand = np.unique(np.concatenate([p[0] for p in parts]))
                scores = np.zeros(cand.size, np.int64)
                for docs, imps in parts:
                    scores[np.searchsorted(cand, docs)] += imps
                for c in cursors:
                    if c not in seeds:
                        _score_term(c.tp, c.base_impact, cand,
                                    np.arange(cand.size), scores,
                                    has_tf=index.has_tf,
                                    probe_width=probe_width, plan=plan,
                                    stats=st,
                                    touched=touched.setdefault(c.tp.term,
                                                               set()))
                order = np.lexsort((cand, -scores))[:k]
                top_d, top_s = cand[order], scores[order]
                seeded = cand

    timed_out = False
    while True:
        if _expired(deadline, st, "maxscore-strip"):
            timed_out = True  # exact over every completed strip
            break
        full = top_d.size >= k
        theta = int(top_s[k - 1]) if full else -1
        # non-essential prefix: cumulative upper bound strictly below θ
        n_ness = (int(np.searchsorted(cum_ub, theta, side="left"))
                  if full else 0)
        if n_ness >= len(tps):
            break  # Σ all ubs < θ: nothing unseen can reach the top-k
        ess = cursors[n_ness:]
        his = [int(c.tp.last_doc[min(c.i + strip, c.tp.n_blocks) - 1])
               for c in ess if c.i < c.tp.n_blocks]
        if his:
            hi = min(his)
        else:  # all essential cursors block-exhausted: drain the buffers
            bufs = [int(c.buf_docs[-1]) for c in ess if c.buf_docs.size]
            if not bufs:
                break
            hi = max(bufs)
        parts = []
        for c in ess:
            docs, imps = c.pull(hi, theta if full else None,
                                _seeded_bound(c, total_ub, seed_docs)
                                if seed_docs else total_ub - c.tp.ub,
                                plan=plan, stats=st)
            if docs.size:
                parts.append((docs, imps))
        if parts:
            cand = np.unique(np.concatenate([p[0] for p in parts]))
            if seeded.size:
                # seeded docs are already exactly scored in the heap
                pos = np.minimum(np.searchsorted(seeded, cand),
                                 seeded.size - 1)
                cand = cand[seeded[pos] != cand]
            partial = np.zeros(cand.size, np.int64)
            for docs, imps in parts:
                pos = np.searchsorted(cand, docs)
                pos = np.minimum(pos, max(cand.size - 1, 0))
                ok = (cand[pos] == docs) if cand.size else np.zeros(
                    docs.size, bool)
                partial[pos[ok]] += imps[ok]
            scores = partial
            # probe non-essential terms in descending-bound order; drop
            # candidates as soon as even a full remaining bound can't pass
            ness = sorted((cursors[i] for i in range(n_ness)),
                          key=lambda c: -c.tp.ub)
            rem_ub = np.concatenate(
                [np.cumsum([c.tp.ub for c in reversed(ness)])[::-1],
                 [0]]) if ness else np.zeros(1, np.int64)
            alive = np.ones(cand.size, bool)
            if full:
                dead = scores + int(rem_ub[0]) < theta
                st.probes_pruned += int(dead.sum()) * len(ness)
                alive &= ~dead
            for idx, c in enumerate(ness):
                sel = np.flatnonzero(alive)
                if sel.size == 0:
                    break
                _score_term(c.tp, c.base_impact, cand, sel, scores,
                            has_tf=index.has_tf, probe_width=probe_width,
                            plan=plan, stats=st,
                            touched=touched.setdefault(c.tp.term, set()))
                if full:
                    dead = alive & (scores + int(rem_ub[idx + 1]) < theta)
                    st.probes_pruned += (int(dead.sum())
                                         * (len(ness) - idx - 1))
                    alive &= ~dead
            md = np.concatenate([top_d, cand[alive]])
            ms = np.concatenate([top_s, scores[alive]])
            order = np.lexsort((md, -ms))[:k]
            top_d, top_s = md[order], ms[order]
        strip = min(strip * STRIP_RAMP, MAX_STRIP_BLOCKS)
    # exit accounting: a block was threshold-pruned iff NO pass ever decoded
    # it; a timed-out query books nothing (abandoned, not proven beaten)
    for c in cursors if not timed_out else ():
        rows = np.concatenate(
            c.pruned_rows + [np.arange(c.i, c.tp.n_blocks)]
        ).astype(np.int64)
        c.i = c.tp.n_blocks
        got = touched.get(c.tp.term)
        if got:
            rows = rows[~np.isin(rows,
                                 np.fromiter(got, np.int64, len(got)))]
        if rows.size:
            st.count_pruned(int(rows.size),
                            int(c.tp.arr.counts_host[rows].sum()),
                            term=c.tp.term)
    return top_d, top_s


def topk(
    index: InvertedIndex,
    terms,
    k: int,
    *,
    mode: str = "or",
    plan="auto",
    probe_width: int = DEFAULT_PROBE_WIDTH,
    stats: QueryStats | None = None,
    use_skip: bool = True,
    deadline: Deadline | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k scored query: ``(docids uint32 [≤k], scores int32 [≤k])``.

    Score(d) = Σ over query terms containing d of the term's quantized
    impact at d (per-posting when the index carries tfs). ``mode``:
    ``"or"`` TAAT over the union, ``"maxscore"`` block-max pruned with
    bit-identical results, ``"and"`` over the conjunctive candidates,
    ``"driver"`` required-term DAAT (docs containing ``terms[0]``). Results
    are ordered by (score desc, docid asc).
    """
    if isinstance(k, bool) or not isinstance(k, (int, np.integer)) or k < 1:
        raise ValueError(f"k must be a positive integer, got {k!r}")
    k = int(k)
    with _trace("topk", mode=mode, k=k) as sp:
        out = _topk_impl(index, terms, k, mode=mode, plan=plan,
                         probe_width=probe_width, stats=stats,
                         use_skip=use_skip, deadline=deadline)
        if sp and stats is not None:
            sp.attrs.update(stats.span_attrs())
        return out


def _topk_impl(index: InvertedIndex, terms, k: int, *, mode, plan,
               probe_width, stats, use_skip, deadline):
    if mode == "or" or (mode == "maxscore" and not use_skip):
        cand, scores = _taat_scores(index, terms, plan=plan, stats=stats,
                                    use_skip=use_skip, deadline=deadline)
    elif mode == "maxscore":
        cand, scores = _maxscore(index, terms, k, plan=plan,
                                 probe_width=probe_width, stats=stats,
                                 deadline=deadline)
    elif mode == "and":
        cand = conjunctive(index, terms, plan=plan, probe_width=probe_width,
                           stats=stats, use_skip=use_skip,
                           deadline=deadline).astype(np.int64)
        if index.has_tf:
            # per-posting impacts vary per candidate: probe each term's
            # weight stream over the conjunctive candidates
            scores = np.zeros(cand.size, np.int64)
            for t in dict.fromkeys(terms):
                tp = index.terms.get(t)
                if tp is None or tp.df == 0 or cand.size == 0:
                    continue
                if _expired(deadline, stats, "and-score-term"):
                    break
                w = min(_pow2(cand.size), probe_width)
                for s in range(0, cand.size, w):
                    chunk = cand[s:s + w].astype(np.uint32)
                    scores[s:s + len(chunk)] += _probe_pass(
                        tp, chunk, impact=index.impact(t), probe_width=w,
                        plan=plan, stats=stats, use_skip=use_skip,
                        weights=tp.impacts).astype(np.int64)
        else:
            # every conjunctive candidate is in every query term, so the
            # tf-free score is one known constant — no scoring decode
            total = sum(index.impact(t) for t in dict.fromkeys(terms))
            scores = np.full(cand.size, total, np.int64)
    elif mode == "driver":
        # required-term top-k: candidates are the docs containing
        # terms[0], ranked by total impact over ALL query terms through the
        # fused scoring epilogues on skip-gathered blocks
        tp0 = index.terms.get(terms[0])
        if tp0 is None or tp0.df == 0:
            return np.zeros(0, np.uint32), np.zeros(0, np.int32)
        cand = _decode_blocks(tp0, 0, tp0.n_blocks, plan=plan, stats=stats,
                              use_skip=use_skip).astype(np.int64)
        if index.has_tf:
            scores = _decode_impact_stream(tp0, plan=plan, stats=stats)
        else:
            scores = np.full(cand.size, index.impact(terms[0]), np.int64)
        for t in dict.fromkeys(terms[1:]):
            tp = index.terms.get(t)
            if t == terms[0] or tp is None or tp.df == 0:
                continue
            if _expired(deadline, stats, "driver-term"):
                break
            imp = index.impact(t)
            w = min(_pow2(cand.size), probe_width)
            for s in range(0, cand.size, w):
                chunk = cand[s:s + w].astype(np.uint32)
                scores[s:s + len(chunk)] += _probe_pass(
                    tp, chunk, impact=imp, probe_width=w, plan=plan,
                    stats=stats, use_skip=use_skip,
                    weights=tp.impacts if index.has_tf else None
                ).astype(np.int64)
    else:
        raise ValueError(
            f"unknown topk mode {mode!r}; expected "
            "'or'/'maxscore'/'and'/'driver'")
    with _trace("topk-select", candidates=int(cand.size)):
        order = np.lexsort((cand, -scores))[:k]
        return cand[order].astype(np.uint32), scores[order].astype(np.int32)
