"""Search serving on the card: :class:`SearchEngine` over a resident index.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch search --requests 64
    PYTHONPATH=src python -m repro_torch.launch.serve --arch search --device cpu

The port of the single-device search path of ``repro/launch/serve.py``:
the index's compressed streams live on the card for the engine's lifetime,
skip tables prune on the host, and every decode runs through the CUDA
kernels (``plan="auto"``). ``run_workload`` reports QPS, p50/p99 latency
and the decode-vs-skip-vs-pruned block accounting. The mesh-sharded
engine, the hardened mode (validation, quarantine, retries, fault hooks,
logical shards) and telemetry spans are still to port (ROADMAP queue 1
items 9, 11 and 13).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.obs.stats import latency_summary


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


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=["search"])
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--top-k", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    stats = serve_search(queries=args.requests, top_k=args.top_k,
                         device=args.device)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
