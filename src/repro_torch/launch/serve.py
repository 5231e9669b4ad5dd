"""Serving on the card: :class:`ServingEngine` (two-tower retrieval and
embedding bags over compressed id lists) and :class:`SearchEngine`
(queries over a resident compressed index).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch search --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch search --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch search \
        --degraded-smoke    # kill 1 of 8 logical shards, heal, parity
    PYTHONPATH=src python -m repro_torch.launch.serve --arch search \
        --ingest-smoke      # WAL ingest, crash a merge, recover, parity
    PYTHONPATH=src python -m repro_torch.launch.serve --arch search \
        --metrics-out DIR   # telemetry capture: metrics.prom, trace.jsonl,
                            # trace-chrome.json
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch two-tower-retrieval --device cpu --requests 32

The port of the single-device paths of ``repro/launch/serve.py``. The
search index's compressed streams live on the card for the engine's
lifetime, skip tables prune on the host, and every decode runs through
the CUDA kernels (``plan="auto"``). ``run_workload`` reports QPS, p50/p99
latency and the decode-vs-skip-vs-pruned block accounting. The engine is
hardened as the reference's: startup validation through kernel 2's
``checksum`` epilogue, quarantine, retries, fault hooks, the unsafe-bound
fallback to TAAT, and logical shards that can be lost and healed
(``--degraded-smoke``). :class:`LiveSearchEngine` serves a WAL-backed
:class:`~repro_torch.index.LiveIndex` (``--ingest-smoke``).

Telemetry (``repro_torch.obs``): ``SearchEngine.search`` opens the
reference's ``request`` / ``admission`` / ``execute`` / ``finalize``
spans and bumps its ``serve_*_total`` counters; ``ServingEngine`` opens a
``microbatch`` span per served batch. ``--metrics-out DIR`` captures a
workload and writes the exports.

``--arch two-tower-retrieval`` runs :class:`ServingEngine` at the
reference's reduced config: a compressed candidate corpus resident on
the card, requests microbatched to buckets 1/2/4/8, scored by kernel 2's
``dot_score`` epilogue against an item table computed once, and the
``bag_sum`` embedding-bag endpoint. The mesh-sharded engines are still to
port (ROADMAP queue 1 item 13); the port writes no benchmark file.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.obs import counter_inc as _obs_counter_inc
from repro_torch.obs import trace as _obs_trace
from repro_torch.obs.stats import latency_summary


# ---------------------------------------------------------------------------
# the batched compressed serving engine
# ---------------------------------------------------------------------------
class ServingEngine:
    """Serve retrieval and embedding-bag requests from a compressed corpus.

    * **Resident corpus** — the candidate id list stays compressed on
      ``device`` (default: the card) for the engine's lifetime; requests
      never upload it again.
    * **Precomputed item table** — the item tower runs once over the
      vocabulary at build (``models.recsys.item_table``, in row chunks);
      serving gathers from the ``[V, d]`` table inside kernel 2's
      ``dot_score`` epilogue, so a request costs user tower + one fused
      decode-gather-dot launch + top-k. Row 0 is the pad row: pad slots
      score it, and ``_mask_and_topk`` masks id 0.
    * **Bucketed microbatching** — requests are grouped to the next bucket
      size (default 1/2/4/8) and padded; the decoded corpus is shared by
      the microbatch, whose ``[b, d]`` query matrix ``dot_score`` takes in
      one pass.
    * **Embedding bags** — ``embed_bags`` pools ragged id bags through
      kernel 2's ``bag_sum`` epilogue. The bf16 copy of ``item_id_emb`` it
      reads is cast once here (the reference casts the f32 table on every
      call: the same values).

    ``retrieve`` serves one microbatch; ``run_workload`` drives a request
    list and reports QPS and per-request p50/p99 latency.
    """

    def __init__(self, params, cfg, corpus, *, top_k: int = 10,
                 buckets=(1, 2, 4, 8), plan="auto", dtype=None, device=None):
        from repro_torch.ft import StragglerDetector
        from repro_torch.models import recsys
        from repro_torch.nn import layers as nnl

        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = params.to(self.device)
        self.top_k = top_k
        self.plan = plan
        self.buckets = tuple(sorted(buckets))
        self.dtype = dtype or nnl.DEFAULT_COMPUTE_DTYPE
        self.corpus = corpus.to(self.device)
        with torch.inference_mode():
            self.item_table = recsys.item_table(self.params, cfg,
                                                dtype=self.dtype)
            self.bag_table = self.params.item_id_emb.to(self.dtype)
        # liveness: one heartbeat per served microbatch; run_workload
        # reports the detector's straggler classification
        self.detector = StragglerDetector()
        self._step = 0

    # -- retrieval ---------------------------------------------------------
    def _mask_and_topk(self, ids, scores):
        from repro_torch.models.recsys import topk_lower_index

        flat_ids = ids.reshape(-1)  # [C]
        if scores.dim() == 2:  # single query: [nb, B]
            s = scores.reshape(1, -1)
        else:  # [nb, B, b] -> [b, C]
            s = scores.reshape(-1, scores.shape[-1]).T
        s = s.masked_fill(flat_ids[None, :] == 0, -torch.inf)  # pad slots
        top_s, top_i = topk_lower_index(s, self.top_k)
        return top_s, flat_ids[top_i]

    def bucket_of(self, k: int) -> int:
        for b in self.buckets:
            if b >= k:
                return b
        return self.buckets[-1]

    def retrieve(self, user_ids, hists):
        """Serve one microbatch: ``[b]`` user ids + ``[b, L]`` histories →
        ``(scores [b, k], item ids [b, k])``; ``b`` is one of the buckets.
        Nothing here synchronises."""
        from repro_torch.kernels.vbyte_decode import dispatch
        from repro_torch.models import recsys

        with torch.inference_mode():
            u = recsys.user_tower(self.params, user_ids.to(self.device),
                                  hists.to(self.device), self.cfg,
                                  dtype=self.dtype)  # [b, d]
            ids, scores = dispatch.decode(
                self.corpus, epilogue="dot_score",
                epilogue_operands={"table": self.item_table, "query": u},
                plan=self.plan)
            return self._mask_and_topk(ids, scores)

    # -- embedding-bag endpoint -------------------------------------------
    def embed_bags(self, bags, *, format="vbyte"):
        """Pooled (mean) embeddings for ragged id bags, one request = one
        bag: compressed on the host, one block per bag of ``seq_len`` slots,
        and reduced by the ``bag_sum`` epilogue. Returns ``[len(bags),
        id_dim]`` in the engine's dtype."""
        from repro_torch.core import CompressedIntArray
        from repro_torch.nn.embedding_bag import embedding_bag_compressed

        k = len(bags)
        b = self.bucket_of(k)
        padded = list(bags) + [[] for _ in range(b - k)]
        arr = CompressedIntArray.encode_ragged(
            padded, format=format, block_size=self.cfg.seq_len,
            differential=False, device=self.device)
        with torch.inference_mode():
            out = embedding_bag_compressed(self.bag_table, arr, mode="mean",
                                           plan=self.plan, dtype=self.dtype)
        return out[:k]

    # -- workload loop -----------------------------------------------------
    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self):
        """Serve every bucket shape once (excluded from latencies)."""
        rng = np.random.default_rng(0)
        for b in self.buckets:
            uid = torch.as_tensor(
                rng.integers(1, max(self.cfg.n_users, 2), b).astype(np.int32))
            hist = torch.as_tensor(rng.integers(
                1, self.cfg.n_items, (b, self.cfg.seq_len)).astype(np.int32))
            self.retrieve(uid, hist)
        self._sync()

    def run_workload(self, requests, *, max_batch: int | None = None,
                     record: list | None = None) -> dict:
        """Drive ``(user_id, hist)`` requests through the microbatching loop.

        Requests are drained greedily up to the largest bucket, padded to
        the bucket shape, and served. The p50/p99 are per-request service
        latencies (host marshal + the microbatch's engine step, ended by a
        device synchronisation); queueing behind earlier batches is not
        included, the aggregate QPS over the drain covers it. ``record``,
        a list, receives each microbatch's ``(top scores, top ids)`` on
        the host, copied after the latency is taken.
        """
        # a microbatch can never exceed the largest bucket shape
        max_batch = min(max_batch or self.buckets[-1], self.buckets[-1])
        lat = []
        i = 0
        t_start = time.perf_counter()
        while i < len(requests):
            take = min(max_batch, len(requests) - i)
            b = self.bucket_of(take)
            chunk = requests[i:i + take]
            t0 = time.perf_counter()
            with _obs_trace("microbatch", bucket=int(b), requests=int(take)):
                uid = np.full(b, 1, np.int32)
                hist = np.ones((b, self.cfg.seq_len), np.int32)
                for j, (u, h) in enumerate(chunk):
                    uid[j] = u
                    hist[j] = h
                top_s, top_i = self.retrieve(torch.as_tensor(uid),
                                             torch.as_tensor(hist))
                self._sync()
            _obs_counter_inc("serve_requests_total", take, engine="serving")
            dt = time.perf_counter() - t0
            if record is not None:
                record.append((top_s[:take].cpu(), top_i[:take].cpu()))
            lat.extend([dt] * take)  # the whole microbatch completes together
            self.detector.heartbeat("serve-host", self._step)
            self._step += 1
            i += take
        wall = time.perf_counter() - t_start
        return {
            "n_requests": len(requests),
            "n_devices": 1,
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            **latency_summary(lat, wall, len(requests)),
            "top_k": self.top_k,
            "corpus_n": self.corpus.n,
            "buckets": list(self.buckets),
            "stragglers": self.detector.stragglers(),
        }


class SearchEngine:
    """Serve boolean / top-k queries from a resident compressed index.

    The index is moved to ``device`` (default: the card) once, at
    construction. ``search(terms, mode)`` serves one query;
    ``run_workload`` drives a query list. Candidate sets are processed in
    ``probe_width`` chunks, so every membership/scoring pass comes from a
    bounded set of shapes.

    **Degraded-mode serving** (the reference's hardened engine): with
    ``validate=True`` every term's streams are validated at startup —
    terms whose payload / metadata / checksum column fails are
    **quarantined** (dropped from queries, which come back flagged
    ``degraded``), terms whose ``max_impact`` bound is unsafe are kept but
    force a ``topk_maxscore`` → exhaustive-TAAT fallback (exact, just
    slower). The checked decode runs kernel 2's ``checksum`` epilogue on
    the index's device; only the per-block column comes to the host.
    Per-request ``Deadline`` budgets (``deadline_s``), bounded
    retry-with-backoff on transient decode errors
    (:class:`~repro_torch.robustness.DecodeError`; one carrying term
    coordinates quarantines that segment and the query is re-answered
    from the rest), and a logical-shard health layer
    (``n_shards`` + :class:`~repro_torch.ft.StragglerDetector`:
    ``heartbeat`` / ``check_health`` / ``kill_shard`` / ``heal``) keep the
    engine answering — partial and flagged, never hung, never silently
    wrong. Quarantine and heal move no index bytes.
    """

    def __init__(self, index, *, top_k: int = 10, plan="auto",
                 probe_width: int = 512, validate: bool = False,
                 deep_validate: bool = False,
                 deadline_s: float | None = None, max_retries: int = 2,
                 backoff_s: float = 0.0, fault_hook=None, n_shards: int = 0,
                 clock=None, device=None):
        from repro_torch.ft import StragglerDetector, shard_intervals

        self.device = resolve_device(device)
        self.index = index.to(self.device)  # no copy where it already lives
        self.top_k = top_k
        self.plan = plan
        self.probe_width = probe_width
        # -- robustness state ------------------------------------------------
        self.deadline_s = deadline_s
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.fault_hook = fault_hook  # fault_hook(attempt, terms, mode):
        #   raise DecodeError to inject a failure for attempt k (tests)
        self.clock = clock or time.monotonic
        self.quarantined: dict = {}  # term -> reason (startup or at-serve)
        self.bound_unsafe: set = set()  # terms with unsafe max_impact bounds
        self.serve_stats = {"errors": 0, "retries": 0,
                            "quarantined_terms": 0, "quarantined_blocks": 0,
                            "bound_fallbacks": 0, "degraded_responses": 0}
        # startup gate wall seconds: host validators, checked decode
        self.validate_seconds = {"validators": 0.0, "checked_decode": 0.0}
        # logical shards: the sorted term list partitioned into n_shards
        # contiguous intervals (ft.elastic.shard_intervals) — the unit of
        # simulated host loss. A dead shard's terms are dropped from
        # queries (flagged degraded) until heal() re-partitions ownership.
        self.term_order = sorted(self.index.terms)
        self.n_shards = int(n_shards)
        self.detector = StragglerDetector()
        self.dead_shards: set = set()
        self.shard_of: dict = {}
        if self.n_shards:
            self._assign_shards(shard_intervals(len(self.term_order),
                                                self.n_shards))
        if validate:
            self._validate_index(deep=deep_validate)

    # -- startup validation / quarantine ----------------------------------
    def _validate_index(self, *, deep: bool):
        """Gate every term at startup.

        Structure + stream validation, skip-table/df invariants, and — when
        the stream carries a checksum column — a checksum-verified decode
        through kernel 2's ``checksum`` epilogue. Beyond the reference, the
        checked docid grid is also held against the skip table on the
        device (:func:`~repro_torch.robustness.validate.check_skip_table`):
        a flipped high bit of a block's base moves no checksum, and the
        reference serves that block's docids shifted. Failing terms are
        quarantined. A :class:`BoundViolationError` (unsafe ``max_impact``,
        only checked with ``deep=True``) instead marks the term
        ``bound_unsafe``: its results are still exact under every mode
        except MaxScore pruning, so the engine keeps it and falls back to
        exhaustive TAAT.
        """
        from repro_torch.robustness import (BoundViolationError, DecodeError,
                                            decode_checked, validate_array,
                                            validate_meta)
        from repro_torch.robustness.validate import check_skip_table

        secs = self.validate_seconds
        for t in self.term_order:
            tp = self.index.terms[t]
            if not tp.df:
                continue
            streams = [a for a in (tp.arr, tp.impacts) if a is not None]
            try:
                t0 = time.perf_counter()
                for a in streams:
                    validate_array(a, term=t)
                t1 = time.perf_counter()
                secs["validators"] += t1 - t0
                for a in streams:
                    if a.checksums is not None:
                        grid = decode_checked(a, plan=self.plan, term=t)
                        if a is tp.arr:
                            check_skip_table(tp, grid)
                        del grid
                t2 = time.perf_counter()
                secs["checked_decode"] += t2 - t1
                validate_meta(tp, deep=deep)
                secs["validators"] += time.perf_counter() - t2
            except BoundViolationError:
                self.bound_unsafe.add(t)
            except DecodeError as e:
                self._quarantine(t, str(e))

    def _bump(self, key: str, n: int = 1, **labels):
        """Increment one robustness counter: the ``serve_stats`` dict (the
        in-process API benchmarks and tests read and reset) and, when
        telemetry is installed, the ``serve_<key>_total`` labeled counter
        in the metrics registry."""
        self.serve_stats[key] += n
        _obs_counter_inc(f"serve_{key}_total", n, engine="search", **labels)

    def _quarantine(self, term, reason: str):
        if term in self.quarantined:
            return
        self.quarantined[term] = reason
        self._bump("quarantined_terms")
        tp = self.index.terms.get(term)
        if tp is not None:
            self._bump("quarantined_blocks", tp.n_blocks)

    # -- logical-shard health (ft.heartbeat + ft.elastic) ------------------
    def _assign_shards(self, intervals):
        self.shards = list(intervals)
        self.shard_of = {t: s for s, (lo, hi) in enumerate(self.shards)
                         for t in self.term_order[lo:hi]}

    def heartbeat(self, shard: int, step: int, now: float | None = None):
        """One liveness beat from a logical shard (tests drive sim time)."""
        self.detector.heartbeat(f"shard{shard}", step,
                                self.clock() if now is None else now)

    def check_health(self, now: float | None = None) -> dict:
        """Classify shards via the straggler detector; newly-'dead' shards
        are killed (their terms drop from queries until :meth:`heal`)."""
        report = self.detector.stragglers(
            self.clock() if now is None else now)
        for host, state in report.items():
            if state == "dead" and host.startswith("shard"):
                self.dead_shards.add(int(host[len("shard"):]))
        return report

    def kill_shard(self, shard: int):
        """Simulate losing one logical shard."""
        self.dead_shards.add(int(shard))

    def heal(self):
        """Re-partition term ownership over the surviving shards.

        Uses :func:`repro_torch.ft.elastic.reshard_plan` to map each new
        interval onto slices of the old partition (returned for
        inspection), then reassigns every term to a live owner — after
        healing no query is degraded by shard loss (the terms stayed
        resident on the device all along; what died was the logical
        serving owner).
        """
        from repro_torch.ft import reshard_plan, shard_intervals

        if not self.dead_shards:
            return []
        n_alive = self.n_shards - len(self.dead_shards)
        if n_alive <= 0:
            raise RuntimeError("no live shards left to heal onto")
        plan = reshard_plan(len(self.term_order), self.n_shards, n_alive)
        for s in self.dead_shards:
            self.detector.hosts.pop(f"shard{s}", None)
        self.n_shards = n_alive
        self._assign_shards(shard_intervals(len(self.term_order), n_alive))
        self.dead_shards = set()
        return plan

    # -- queries -----------------------------------------------------------
    def _run_query(self, terms, mode: str, stats, deadline):
        from repro_torch.index import conjunctive, disjunctive, topk

        if not terms:  # everything quarantined / dead: empty, well-typed
            empty = np.zeros(0, np.uint32)
            return (empty if mode in ("and", "or")
                    else (empty, np.zeros(0, np.int32)))
        kw = dict(plan=self.plan, stats=stats, deadline=deadline)
        if mode == "and":
            return conjunctive(self.index, terms,
                               probe_width=self.probe_width, **kw)
        if mode == "or":
            return disjunctive(self.index, terms, **kw)
        if mode in ("topk", "topk_driver", "topk_maxscore"):
            sub = {"topk": "or", "topk_driver": "driver",
                   "topk_maxscore": "maxscore"}[mode]
            return topk(self.index, terms, self.top_k, mode=sub,
                        probe_width=self.probe_width, **kw)
        raise ValueError(f"unknown query mode {mode!r}")

    def search(self, terms, mode: str = "and", *, stats=None, deadline=None):
        """One query. ``mode``: 'and' | 'or' → sorted uint32 docids;
        'topk' (disjunctive TAAT) | 'topk_maxscore' (block-max pruned,
        bit-identical results) | 'topk_driver' (required-term DAAT) →
        (docids, int32 scores), ordered (score desc, docid asc).

        Hardened path: quarantined / dead-shard terms are dropped (query
        flagged ``degraded`` via ``stats``), unsafe-bound terms force
        ``topk_maxscore`` → exhaustive TAAT, a :class:`DecodeError` raised
        mid-answer is retried up to ``max_retries`` times (term-coordinate
        failures quarantine the segment first), and an expired ``deadline``
        (or ``deadline_s`` default) yields a smaller, flagged result. The
        query never hangs and never returns silently-wrong data.
        """
        from repro_torch.index import QueryStats
        from repro_torch.robustness import Deadline, DecodeError

        with _obs_trace("request", mode=mode, terms=len(terms)) as rspan:
            with _obs_trace("admission"):
                qst = QueryStats()  # per-call: the degraded flag is per query
                if deadline is None and self.deadline_s is not None:
                    deadline = Deadline(self.deadline_s, clock=self.clock)
                live = []
                for t in dict.fromkeys(terms):
                    if t in self.quarantined:
                        qst.mark_degraded(f"quarantined-term:{t}")
                        tp = self.index.terms.get(t)
                        qst.quarantined_blocks += tp.n_blocks if tp else 0
                    elif self.shard_of.get(t) in self.dead_shards:
                        qst.mark_degraded(f"dead-shard:{self.shard_of[t]}")
                    else:
                        live.append(t)
                eff = mode
                if mode == "topk_maxscore" and any(t in self.bound_unsafe
                                                   for t in live):
                    eff = "topk"  # exhaustive TAAT: exact without bounds
                    qst.bound_fallbacks += 1
                    self._bump("bound_fallbacks")
            with _obs_trace("execute", mode=eff):
                # retrying transient decode errors
                attempt = 0
                while True:
                    try:
                        if self.fault_hook is not None:
                            self.fault_hook(attempt, live, eff)
                        out = self._run_query(live, eff, qst, deadline)
                        break
                    except DecodeError as e:
                        qst.errors += 1
                        self._bump("errors", error=type(e).__name__)
                        term = getattr(e, "term", None)
                        if term is not None and term in live:
                            # the segment itself is bad — quarantine it and
                            # answer the query from the remaining terms
                            self._quarantine(term, str(e))
                            live = [t for t in live if t != term]
                            qst.mark_degraded(f"quarantined-term:{term}")
                        elif attempt >= self.max_retries:
                            qst.mark_degraded("retries-exhausted")
                            out = self._run_query([], eff, qst, deadline)
                            break
                        else:
                            attempt += 1
                            qst.retries += 1
                            self._bump("retries")
                            if self.backoff_s:
                                time.sleep(self.backoff_s * attempt)
            with _obs_trace("finalize"):
                _obs_counter_inc("serve_requests_total", mode=mode,
                                 engine="search")
                if qst.degraded:
                    self._bump("degraded_responses")
                    for r in qst.degraded_reasons:
                        cat, _, where = r.partition(":")
                        _obs_counter_inc("serve_degraded_total", reason=cat,
                                         engine="search")
                        if cat == "deadline":
                            _obs_counter_inc("serve_deadline_hits_total",
                                             where=where, engine="search")
                if rspan:
                    rspan.set(mode_effective=eff, degraded=qst.degraded,
                              n_results=int(len(out[0]) if isinstance(
                                  out, tuple) else len(out)))
                if stats is not None:
                    stats.merge(qst)
            return out

    def warmup(self, queries):
        """Run each (mode, terms) query once."""
        for mode, terms in queries:
            self.search(terms, mode)

    def run_workload(self, queries, *, record: list | None = None) -> dict:
        """Drive (mode, terms) queries sequentially; aggregate QPS/latency
        plus the skip-table decode accounting over the whole workload. A
        query's latency ends when its result is on the host. ``record``, a
        list, receives each query's ``(result, QueryStats, seconds)``.
        Each query posts a heartbeat for every live logical shard, so a
        silenced shard goes stale and ``check_health`` classifies it
        dead."""
        from repro_torch.index import QueryStats

        st = QueryStats()
        serve_before = dict(self.serve_stats)
        lat = []
        n_results = 0
        step = 0
        t_start = time.perf_counter()
        for mode, terms in queries:
            qst = st if record is None else QueryStats()
            t0 = time.perf_counter()
            out = self.search(terms, mode, stats=qst)
            lat.append(time.perf_counter() - t0)
            if record is not None:
                record.append((out, qst, lat[-1]))
                st.merge(qst)
            n_results += len(out[0] if isinstance(out, tuple) else out)
            for s in range(self.n_shards):
                if s not in self.dead_shards:
                    self.heartbeat(s, step)
            step += 1
        wall = time.perf_counter() - t_start
        # blocks considered = decoded + skip-table-skipped (per pass) +
        # threshold-pruned (never decoded by any pass)
        total_blocks = (st.blocks_decoded + st.blocks_skipped
                        + st.blocks_pruned)
        total_postings = st.ints_decoded + st.postings_pruned
        return {
            "n_queries": len(queries),
            "device": (torch.cuda.get_device_name(self.device)
                       if self.device.type == "cuda" else "cpu"),
            **latency_summary(lat, wall, len(queries)),
            "n_results": int(n_results),
            "blocks_decoded": st.blocks_decoded,
            "block_skip_rate": round(st.blocks_skipped / total_blocks, 3)
                               if total_blocks else 0.0,
            "pruned_block_rate": round(st.blocks_pruned / total_blocks, 3)
                                 if total_blocks else 0.0,
            "pruned_impact_rate": round(st.postings_pruned / total_postings,
                                        3) if total_postings else 0.0,
            "probes_pruned": st.probes_pruned,
            "rows_gathered": st.rows_gathered,
            "ints_decoded": st.ints_decoded,
            "impact_ints_decoded": st.impact_ints_decoded,
            "decode_calls": st.decode_calls,
            "decoded_ints_per_s": round(st.ints_decoded / wall, 1),
            "index": self.index.stats(),
            # robustness accounting over this workload
            "errors": st.errors,
            "retries": st.retries,
            "degraded_responses": (self.serve_stats["degraded_responses"]
                                   - serve_before["degraded_responses"]),
            "quarantined_terms": self.serve_stats["quarantined_terms"],
            "quarantined_blocks": self.serve_stats["quarantined_blocks"],
            "bound_fallbacks": st.bound_fallbacks,
            "dead_shards": sorted(self.dead_shards),
        }


def search_queries(rng, index, n_queries: int, *,
                   terms_per_query=(1, 2, 3, 5),
                   modes=("and", "or", "topk", "topk_driver",
                          "topk_maxscore")) -> list:
    """Synthetic query mix over an index's terms: (mode, terms) pairs."""
    term_ids = sorted(index.terms)
    out = []
    for i in range(n_queries):
        k = int(rng.choice(terms_per_query))
        terms = [int(t) for t in
                 rng.choice(term_ids, size=min(k, len(term_ids)),
                            replace=False)]
        out.append((modes[i % len(modes)], terms))
    return out


def stage_latency_summary(tracer, stages=("decode", "gallop", "merge",
                                          "score", "topk", "topk-select",
                                          "seed", "request", "admission",
                                          "execute")) -> dict:
    """Per-stage latency block from a tracer's finished spans: for each
    stage name with ≥1 span, count + p50/p99/mean milliseconds (host
    time, as every span measures)."""
    from repro_torch.obs.stats import percentile

    out = {}
    for name in stages:
        ds = [d * 1e3 for d in tracer.durations(name)]
        if ds:
            out[name] = {"count": len(ds),
                         "p50_ms": round(percentile(ds, 50), 3),
                         "p99_ms": round(percentile(ds, 99), 3),
                         "mean_ms": round(sum(ds) / len(ds), 3)}
    return out


def write_metrics_out(tele, out_dir: str) -> dict:
    """Export one telemetry capture: Prometheus exposition
    (``metrics.prom``), the JSONL span log (``trace.jsonl``), and the
    Chrome/Perfetto trace (``trace-chrome.json``). Returns the paths."""
    os.makedirs(out_dir, exist_ok=True)
    paths = {"prometheus": os.path.join(out_dir, "metrics.prom"),
             "jsonl": os.path.join(out_dir, "trace.jsonl"),
             "chrome": os.path.join(out_dir, "trace-chrome.json")}
    with open(paths["prometheus"], "w") as f:
        f.write(tele.registry.to_prometheus())
    tele.tracer.write_jsonl(paths["jsonl"])
    tele.tracer.write_chrome_trace(paths["chrome"])
    return paths


def search_lists(rng, groups: dict, *, universe: int):
    """Synthetic posting lists and tfs: for each paper length group K in
    ``groups`` (K → number of lists), lists with lengths in [2^K, 2^{K+1})
    of docids from ``universe``, with Zipf term frequencies."""
    from repro_torch.data.synthetic import posting_list_group, posting_tfs

    lists = {}
    for k, n_lists in groups.items():
        for lst in posting_list_group(rng, k, n_lists, universe=universe):
            lists[len(lists)] = lst
    tfs = {t: posting_tfs(rng, len(v)) for t, v in lists.items()}
    return lists, tfs


def serve_search(*, queries: int, group_k: int = 10, n_lists: int = 16,
                 top_k: int = 10, seed: int = 0, device=None,
                 metrics_out: str | None = None) -> dict:
    """Build a synthetic posting-list index and drive a query workload.

    ``metrics_out=DIR`` installs a telemetry capture around the measured
    workload and writes the three exports there (see
    :func:`write_metrics_out`); the per-stage latency breakdown comes back
    under ``observability``. Nothing is recorded to a benchmark file.
    """
    from repro_torch import obs
    from repro_torch.index import build_index

    rng = np.random.default_rng(seed)
    universe = 1 << 22
    lists, tfs = search_lists(rng, {group_k: n_lists}, universe=universe)
    index = build_index(lists, tfs=tfs, n_docs=universe, device=device)
    print(f"index: {index.n_terms} terms, {index.n_postings} postings, "
          f"{index.bits_per_int:.2f} bits/int on {index.device}")
    engine = SearchEngine(index, top_k=top_k, device=device)
    qs = search_queries(rng, index, queries)
    engine.warmup(qs)
    tele = obs.Telemetry() if metrics_out else None
    if tele is not None:
        obs.install(tele)
    try:
        stats = engine.run_workload(qs)
    finally:
        if tele is not None:
            obs.uninstall()
    print(f"served {stats['n_queries']} queries on {stats['device']}: "
          f"{stats['qps']} QPS, p50 {stats['p50_ms']} ms, "
          f"p99 {stats['p99_ms']} ms, block skip rate "
          f"{stats['block_skip_rate']}, pruned block rate "
          f"{stats['pruned_block_rate']}")
    if tele is not None:
        paths = write_metrics_out(tele, metrics_out)
        obs_stats = {"n_queries": len(qs),
                     "n_traces": len(tele.tracer.trees()),
                     "stages": stage_latency_summary(tele.tracer)}
        print(f"telemetry capture -> {metrics_out} "
              f"({obs_stats['n_traces']} span trees)")
        stats = dict(stats, observability=obs_stats, metrics_paths=paths)
    return stats


class SimClock:
    """A deterministic clock for the degraded-serving drills: every reading
    advances it by ``tick`` seconds, like a real clock, and ``advance``
    moves it on by more."""

    def __init__(self, tick: float = 1e-3):
        self.t = 0.0
        self.tick = tick

    def __call__(self) -> float:
        self.t += self.tick
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _same(a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def shard_loss_drill(engine: SearchEngine, queries, clock: SimClock, *,
                     victim: int = 3) -> dict:
    """Lose one logical shard mid-workload and heal, on a served engine
    built with ``n_shards`` and ``clock``.

    1. A healthy workload (``run_workload``: every query beats every
       shard); no response may be degraded.
    2. The victim goes silent while the survivors keep beating, until
       ``check_health`` (not a manual kill) classifies it dead.
    3. Every query again: those touching the victim's terms must come back
       flagged ``degraded`` (an OR answer a subset of the healthy one), all
       others bit-identical to the healthy answers.
    4. ``heal()`` re-partitions ownership over the survivors; every answer
       must be bit-identical to the healthy one and unflagged.

    Raises ``AssertionError`` on any violation. Returns the counts and each
    step's seconds, and the healthy answers under ``"healthy"``.
    """
    from repro_torch.index import QueryStats

    lo, hi = engine.shards[victim]
    victim_terms = set(engine.term_order[lo:hi])
    t0 = time.perf_counter()
    record: list = []
    healthy = engine.run_workload(queries, record=record)
    _check(healthy["degraded_responses"] == 0, f"healthy run: {healthy}")
    clean = [out for out, _, _ in record]
    t1 = time.perf_counter()

    for i in range(5):
        clock.advance(1.0)
        for s in range(engine.n_shards):
            if s != victim:
                engine.heartbeat(s, 1000 + i)
    report = engine.check_health()
    _check(report.get(f"shard{victim}") == "dead", f"health: {report}")
    _check(engine.dead_shards == {victim},
           f"dead shards {engine.dead_shards}")
    degraded = 0
    for (mode, terms), ref in zip(queries, clean):
        st = QueryStats()
        out = engine.search(terms, mode, stats=st)
        touched = any(t in victim_terms for t in terms)
        _check(st.degraded == touched, f"flag on {mode} {terms}")
        if touched:
            degraded += 1
            if mode == "or":  # the surviving terms' exact union
                _check(bool(np.isin(out, ref).all()),
                       f"or {terms}: not a subset of the healthy answer")
        else:
            _check(_same(out, ref), f"{mode} {terms} changed by shard loss")
    _check(degraded > 0, "no query touched the lost shard")
    t2 = time.perf_counter()

    plan = engine.heal()
    _check(engine.dead_shards == set() and len(plan) == engine.n_shards,
           f"heal: dead {engine.dead_shards}, plan {len(plan)} shards")
    for (mode, terms), ref in zip(queries, clean):
        st = QueryStats()
        out = engine.search(terms, mode, stats=st)
        _check(not st.degraded and _same(out, ref),
               f"{mode} {terms} differs after heal")
    return {"n_queries": len(queries), "victim_shard": victim,
            "degraded_responses": degraded,
            "healed_shards": engine.n_shards,
            "seconds": {"healthy": t1 - t0, "degraded": t2 - t1,
                        "healed": time.perf_counter() - t2},
            "healthy": clean}


def serve_search_degraded(*, queries: int = 32, group_k: int = 8,
                          n_lists: int = 16, n_shards: int = 8,
                          top_k: int = 10, seed: int = 0,
                          device=None) -> dict:
    """Degraded-serving smoke: a checksummed index served over
    ``n_shards`` logical shards with ``validate=True`` (nothing may be
    quarantined), then :func:`shard_loss_drill` — one shard silenced until
    the straggler detector calls it dead, flagged partial results, then
    ``heal()`` and bit-identical answers. Raises ``AssertionError`` on any
    violation; records to no file."""
    from repro_torch.index import build_index

    rng = np.random.default_rng(seed)
    universe = 1 << 20
    lists, tfs = search_lists(rng, {group_k: n_lists}, universe=universe)
    index = build_index(lists, tfs=tfs, n_docs=universe, checksum=True,
                        device=device)
    clock = SimClock()
    engine = SearchEngine(index, top_k=top_k, validate=True,
                          n_shards=n_shards, clock=clock, device=device)
    print(f"degraded smoke: {index.n_terms} terms over {n_shards} logical "
          f"shards on {engine.device}, validate=True "
          f"(quarantined={engine.serve_stats['quarantined_terms']})")
    _check(not engine.quarantined and not engine.bound_unsafe,
           f"clean index failed its gate: {engine.quarantined} "
           f"{engine.bound_unsafe}")
    victim = 3
    lo, _ = engine.shards[victim]
    qs = search_queries(rng, index, queries)
    qs.append(("or", [engine.term_order[lo]]))  # at least one query is hit
    engine.warmup(qs)
    drill = shard_loss_drill(engine, qs, clock, victim=victim)
    print(f"killed shard {victim}: {drill['degraded_responses']}/{len(qs)} "
          "responses flagged degraded, the rest bit-identical to healthy")
    print(f"healed onto {engine.n_shards} shards: all {len(qs)} responses "
          "bit-identical to healthy — degraded-serving smoke OK")
    return {"n_queries": len(qs), "n_shards": n_shards,
            "device": str(engine.device),
            "degraded_responses": drill["degraded_responses"],
            "healed_shards": engine.n_shards, **engine.serve_stats}


class LiveSearchEngine:
    """Serving facade over a mutable :class:`repro_torch.index.LiveIndex`.

    The static ``SearchEngine`` serves one immutable index; this one serves
    the live logical state (main segment − tombstones ∪ delta) and surfaces
    the ingestion layer's degraded states as the rest of serving does:

    * ``replaying`` — the index is still replaying its WAL after a
      restart; answers are correct for the replayed prefix and flagged
      degraded via ``QueryStats``.
    * ``merge_in_progress`` — a merge is draining the delta; queries keep
      full fidelity (bit-identical to quiescent), the flag is reported in
      workload stats.

    Mutations (``add``/``delete``) proxy to the live index and are durable
    (WAL-appended + fsynced) before they return.
    """

    def __init__(self, live, *, top_k: int = 10):
        self.live = live
        self.top_k = top_k

    def add(self, doc, terms):
        self.live.add(doc, terms)

    def delete(self, doc):
        self.live.delete(doc)

    def search(self, terms, mode: str = "and", *, stats=None):
        with _obs_trace("request", mode=mode, terms=len(terms),
                        engine="live") as rspan:
            _obs_counter_inc("serve_requests_total", mode=mode,
                             engine="live")
            if mode == "topk":
                out = self.live.search(terms, mode="topk", k=self.top_k,
                                       stats=stats)
            else:
                out = self.live.search(terms, mode=mode, stats=stats)
            if rspan and stats is not None:
                rspan.set(degraded=stats.degraded, state=self.live.state)
            return out

    def run_workload(self, queries, *, record: list | None = None) -> dict:
        """Drive (mode, terms) queries; aggregate QPS/latency plus the
        live-index accounting (delta-sourced hits, tombstone suppressions,
        merge/replay states). ``record``, a list, receives each query's
        ``(result, QueryStats, seconds)``."""
        from repro_torch.index import QueryStats

        st = QueryStats()
        lat = []
        n_results = 0
        degraded = 0
        merging = 0
        t_start = time.perf_counter()
        for mode, terms in queries:
            q = QueryStats()
            t0 = time.perf_counter()
            out = self.search(terms, mode, stats=q)
            lat.append(time.perf_counter() - t0)
            if record is not None:
                record.append((out, q, lat[-1]))
            n_results += len(out[0] if isinstance(out, tuple) else out)
            degraded += int(q.degraded)
            merging += int(self.live.state == "merge_in_progress")
            st.merge(q)
        wall = time.perf_counter() - t_start
        return {
            "n_queries": len(queries),
            **latency_summary(lat, wall, len(queries)),
            "n_results": int(n_results),
            "epoch": self.live.epoch,
            "state": self.live.state,
            "merge_in_progress_queries": merging,
            "n_delta_docs": self.live.n_delta_docs,
            "pending_ops": self.live.n_pending,
            "doc_count": self.live.doc_count(),
            "blocks_decoded": st.blocks_decoded,
            "ints_decoded": st.ints_decoded,
            "delta_postings": st.delta_postings,
            "delta_hits": st.delta_hits,
            "tombstones_applied": st.tombstones_applied,
            "degraded_responses": degraded,
        }


def _ingest_ops(rng, *, n_ops: int, universe: int, n_terms: int):
    """A seeded add/delete op stream plus the resulting logical state (the
    reference's draws, in the reference's order)."""
    state: dict[int, dict[int, int]] = {}
    ops = []
    for _ in range(n_ops):
        if state and rng.random() < 0.25:
            doc = int(rng.choice(sorted(state)))
            ops.append(("del", doc, None))
            del state[doc]
        else:
            doc = int(rng.integers(universe))
            if doc in state:
                continue
            k = int(rng.integers(1, 5))
            terms = {int(t): int(rng.integers(1, 5))
                     for t in rng.choice(n_terms, size=k, replace=False)}
            ops.append(("add", doc, terms))
            state[doc] = terms
    return ops, state


def _rebuild_oracle(state: dict, *, universe: int, block_size: int = 128,
                    device=None):
    """Rebuilt-from-scratch index over a logical doc→terms state — the
    definition of correct the live index is compared against."""
    from repro_torch.index import build_index

    lists: dict[int, list] = {}
    tfs: dict[int, list] = {}
    for doc in sorted(state):
        for t, tf in state[doc].items():
            lists.setdefault(t, []).append(doc)
            tfs.setdefault(t, []).append(tf)
    return build_index(
        {t: np.asarray(v, np.int64) for t, v in lists.items()},
        tfs={t: np.asarray(v, np.int64) for t, v in tfs.items()},
        format="auto", n_docs=universe, block_size=block_size,
        checksum=True, device=device)


def serve_ingest_smoke(*, ops: int = 200, queries: int = 24,
                       top_k: int = 10, seed: int = 0, device=None) -> dict:
    """End-to-end ingestion smoke, the reference's: ingest a seeded
    add/delete stream into a WAL-backed ``LiveIndex`` on ``device``,
    **crash** a merge at a seeded named crash point, recover by reopening
    the directory, and hold AND/OR/top-k bit-identical to an index rebuilt
    from scratch from the acknowledged logical state — before and after
    the crash, at every crash point of the retried merge, after it
    commits, and after a restart whose replay-time query must be flagged
    ``replaying``. Raises ``AssertionError`` on any divergence; records to
    no file."""
    import shutil
    import tempfile

    from repro_torch.index import (CRASH_POINTS, CrashPoint, LiveIndex,
                                   QueryStats)
    from repro_torch.index import query as iq

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    universe = 50_000
    n_terms = 12
    workdir = tempfile.mkdtemp(prefix="ingest_smoke_")
    try:
        live = LiveIndex(workdir, n_docs=universe, fsync=False, device=dev)
        stream, state = _ingest_ops(rng, n_ops=ops, universe=universe,
                                    n_terms=n_terms)
        for kind, doc, terms in stream:
            (live.add(doc, terms) if kind == "add" else live.delete(doc))

        qs = []
        for _ in range(queries):
            k = int(rng.integers(1, 4))
            terms = [int(t) for t in rng.choice(n_terms, size=k,
                                                replace=False)]
            qs.append((("and", "or", "topk")[int(rng.integers(3))], terms))

        def assert_parity(ix, tag):
            oracle = _rebuild_oracle(state, universe=universe, device=dev)
            for mode, terms in qs:
                if mode == "and":
                    a, b = ix.search(terms, mode="and"), \
                        iq.conjunctive(oracle, terms)
                elif mode == "or":
                    a, b = ix.search(terms, mode="or"), \
                        iq.disjunctive(oracle, terms)
                else:
                    a = ix.search(terms, mode="topk", k=top_k)
                    b = iq.topk(oracle, terms, top_k, mode="or")
                _check(_same(a, b), f"{tag}: {mode} {terms}")

        assert_parity(live, "pre-crash")
        crash_at = str(rng.choice(CRASH_POINTS))
        try:
            live.merge(crash_at=crash_at)
            raise AssertionError("injected crash did not fire")
        except CrashPoint:
            pass
        live.close()
        print(f"ingested {len(stream)} ops ({live.counters['acked_ops']} "
              f"acked) on {dev}, crashed merge at {crash_at!r}")

        live = LiveIndex(workdir, fsync=False, device=dev)  # recovery
        assert_parity(live, f"recovered({crash_at})")
        # retry the merge; queries at every named point stay bit-identical
        live.merge(step_hook=lambda name: assert_parity(
            live, f"mid-merge({name})"))
        assert_parity(live, "post-merge")

        engine = LiveSearchEngine(live, top_k=top_k)
        wl = engine.run_workload(qs)
        # a live write, then a restart that replays it: a query issued
        # *during* replay is flagged degraded("replaying")
        doc = int(rng.integers(universe))
        while doc in state:
            doc = int(rng.integers(universe))
        engine.add(doc, {0: 1})
        state[doc] = {0: 1}
        assert_parity(live, "post-workload-write")
        live.close()
        replay_flags = []

        def replay_probe(ix, i, op):
            q = QueryStats()
            ix.search([0], mode="or", stats=q)
            replay_flags.append((q.degraded, list(q.degraded_reasons)))

        live = LiveIndex(workdir, fsync=False, replay_hook=replay_probe,
                         device=dev)
        _check(bool(replay_flags) and all(
            d and r == ["replaying"] for d, r in replay_flags),
            f"replay flags {replay_flags}")
        assert_parity(live, "post-restart")
        stats = {
            "n_ops": len(stream),
            "n_queries": len(qs),
            "device": str(dev),
            "crash_point": crash_at,
            "recovered_replayed_ops": live.counters["replayed_ops"],
            "rolled_forward": live.counters["rolled_forward"],
            **{k: wl[k] for k in ("qps", "p50_ms", "p99_ms", "delta_hits",
                                  "tombstones_applied", "doc_count",
                                  "epoch") if k in wl},
        }
        live.close()
        print(f"recovery parity OK at {crash_at!r} + all "
              f"{len(CRASH_POINTS)} mid-merge points — ingest smoke OK")
        return stats
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def serve_engine(cfg, *, requests: int, candidates: int, top_k: int = 10,
                 seed: int = 0, device=None) -> dict:
    """Build the two-tower engine over a synthetic candidate corpus and
    drive a synthetic workload, then the embedding-bag endpoint."""
    from repro_torch.core import CompressedIntArray
    from repro_torch.models import recsys

    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    params = recsys.init_params(cfg, seed=seed, device=dev)
    n_cand = min(candidates, cfg.n_items - 1)
    cands = np.sort(rng.choice(np.arange(1, cfg.n_items), n_cand,
                               replace=False)).astype(np.uint64)
    corpus = CompressedIntArray.encode(cands, differential=True, device=dev)
    print(f"corpus: {corpus.n} candidate ids, {corpus.bits_per_int:.2f} "
          f"bits/int ({corpus.compression_ratio:.2f}x vs uint32), "
          f"{corpus.n_blocks} blocks on {dev}")
    engine = ServingEngine(params, cfg, corpus, top_k=top_k, device=dev)
    engine.warmup()
    reqs = [(int(rng.integers(1, max(cfg.n_users, 2))),
             rng.integers(1, cfg.n_items, cfg.seq_len).astype(np.int32))
            for _ in range(requests)]
    stats = engine.run_workload(reqs)
    print(f"served {stats['n_requests']} requests on {stats['device']}: "
          f"{stats['qps']} QPS, p50 {stats['p50_ms']} ms, "
          f"p99 {stats['p99_ms']} ms (top-{top_k} of {stats['corpus_n']} "
          "compressed candidates)")
    bags = [np.sort(rng.choice(np.arange(1, cfg.n_items),
                               rng.integers(1, cfg.seq_len + 1),
                               replace=False)) for _ in range(5)]
    emb = engine.embed_bags(bags)
    print(f"embedding-bag endpoint: {len(bags)} bags -> {tuple(emb.shape)}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=["search", "two-tower-retrieval"])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--candidates", type=int, default=1 << 16,
                    help="two-tower: candidate corpus size")
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--metrics-out", default=None, metavar="DIR",
                    help="search arch: capture telemetry over the workload "
                         "and write metrics.prom / trace.jsonl / "
                         "trace-chrome.json to DIR")
    ap.add_argument("--degraded-smoke", action="store_true",
                    help="search arch: kill one logical shard mid-workload "
                         "and assert flagged partial results + healing")
    ap.add_argument("--ingest-smoke", action="store_true",
                    help="search arch: ingest a WAL-backed live index, "
                         "crash the merge at a seeded point, recover, and "
                         "assert query parity vs a rebuilt index")
    args = ap.parse_args(argv)
    if args.arch == "search" and args.ingest_smoke:
        stats = serve_ingest_smoke(ops=max(args.requests, 50),
                                   top_k=args.top_k, device=args.device)
    elif args.arch == "search" and args.degraded_smoke:
        stats = serve_search_degraded(queries=args.requests,
                                      top_k=args.top_k, device=args.device)
    elif args.arch == "search":
        stats = serve_search(queries=args.requests, top_k=args.top_k,
                             device=args.device,
                             metrics_out=args.metrics_out)
    else:
        # the reference's CLI serves the reduced config of the architecture
        from repro_torch.models import registry

        stats = serve_engine(registry.reduced_config(args.arch),
                             requests=args.requests,
                             candidates=args.candidates, top_k=args.top_k,
                             device=args.device)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
