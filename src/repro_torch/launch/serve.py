"""Serving on the card: :class:`ServingEngine` (two-tower retrieval and
embedding bags over compressed id lists) and :class:`SearchEngine`
(queries over a resident compressed index).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch search --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch search --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch two-tower-retrieval --device cpu --requests 32

The port of the single-device paths of ``repro/launch/serve.py``. The
search index's compressed streams live on the card for the engine's
lifetime, skip tables prune on the host, and every decode runs through
the CUDA kernels (``plan="auto"``). ``run_workload`` reports QPS, p50/p99
latency and the decode-vs-skip-vs-pruned block accounting.

``--arch two-tower-retrieval`` runs :class:`ServingEngine` at the
reference's reduced config: a compressed candidate corpus resident on
the card, requests microbatched to buckets 1/2/4/8, scored by kernel 2's
``dot_score`` epilogue against an item table computed once, and the
``bag_sum`` embedding-bag endpoint. The mesh-sharded engines, the
hardened search mode (validation, quarantine, retries, fault hooks,
logical shards) and telemetry spans are still to port (ROADMAP queue 1
items 9, 11 and 13); the port writes no benchmark file.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
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
            uid = np.full(b, 1, np.int32)
            hist = np.ones((b, self.cfg.seq_len), np.int32)
            for j, (u, h) in enumerate(chunk):
                uid[j] = u
                hist[j] = h
            top_s, top_i = self.retrieve(torch.as_tensor(uid),
                                         torch.as_tensor(hist))
            self._sync()
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
    """

    def __init__(self, index, *, top_k: int = 10, plan="auto",
                 probe_width: int = 512, device=None):
        self.device = resolve_device(device)
        self.index = index.to(self.device)  # no copy where it already lives
        self.top_k = top_k
        self.plan = plan
        self.probe_width = probe_width

    def search(self, terms, mode: str = "and", *, stats=None, deadline=None):
        """One query. ``mode``: 'and' | 'or' → sorted uint32 docids;
        'topk' (disjunctive TAAT) | 'topk_maxscore' (block-max pruned,
        bit-identical results) | 'topk_driver' (required-term DAAT) →
        (docids, int32 scores), ordered (score desc, docid asc)."""
        from repro_torch.index import conjunctive, disjunctive, topk

        terms = list(dict.fromkeys(terms))
        if not terms:  # empty, well-typed
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

    def warmup(self, queries):
        """Run each (mode, terms) query once."""
        for mode, terms in queries:
            self.search(terms, mode)

    def run_workload(self, queries, *, record: list | None = None) -> dict:
        """Drive (mode, terms) queries sequentially; aggregate QPS/latency
        plus the skip-table decode accounting over the whole workload. A
        query's latency ends when its result is on the host. ``record``, a
        list, receives each query's ``(result, QueryStats, seconds)``."""
        from repro_torch.index import QueryStats

        st = QueryStats()
        lat = []
        n_results = 0
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
                 top_k: int = 10, seed: int = 0, device=None) -> dict:
    """Build a synthetic posting-list index and drive a query workload."""
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
    stats = engine.run_workload(qs)
    print(f"served {stats['n_queries']} queries on {stats['device']}: "
          f"{stats['qps']} QPS, p50 {stats['p50_ms']} ms, "
          f"p99 {stats['p99_ms']} ms, block skip rate "
          f"{stats['block_skip_rate']}, pruned block rate "
          f"{stats['pruned_block_rate']}")
    return stats


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
    args = ap.parse_args(argv)
    if args.arch == "search":
        stats = serve_search(queries=args.requests, top_k=args.top_k,
                             device=args.device)
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
