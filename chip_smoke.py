#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                       # the full run
    python3 chip_smoke.py --queries 4 --svb-queries 3 --vbyte-queries 3 \
        --k20-lists 2 --profile-queries 2 --tt-requests 32 --tt-bags 16 \
        --gin-scale 0.05 --live-ops 2000        # a short one, every path

Drives the port (``src/repro_torch``) through the entry points a user
calls, on the card, and fails (exit code ≠ 0, no result line) on any
fault. One JSON line per phase:

1. device — the card's name, count and power limit; no card: exit 2.
2. build — the five CUDA libraries compiled from the kernel packages'
   ``csrc/`` in parallel (one nvcc per source), with the compiler's
   register / shared-memory report.
3. kernel parity — each kernel against its plain torch version on the
   same device tensors at the main path's block layout (B=128, 4096
   blocks, count-0 blocks, ragged tails, differential both ways): kernel 1
   (vbyte decode) at strides 128 and 640 with all five byte lengths;
   kernel 3 (Stream-VByte decode) at stride 128 and at its widest (512)
   with all four byte lengths; kernel 4 (binpack decode) at stride 128 and
   with every width 0..32; kernel 2 (fused decode → each of its 11
   epilogues) on the vbyte, streamvbyte and binpack cores. Integer outputs
   bit for bit; ``bag_sum`` and ``dot_score`` (bf16 [V, 256] and f32
   [V, 128] tables, V = 2^23 + 512, 1- and 8-row queries) within one bf16
   ulp / 1e-5, or the f32 sums' rounding bound where a sum cancels, on
   garbage ids (clamped) and, timed, on sorted item ids — beside the
   bound, the plain version and the unfused chain (the decode kernel,
   then one PyTorch call); ``bag_sum`` also at B=50; ``dot_score`` also
   at the two_tower path's shape (phase ``parity_dot_score_path``: the
   serving corpus of 2^20 distinct sorted ids, 8,192 full blocks, every
   query bucket 1, 2, 4, 8 on the bf16 table and 8 rows on the f32 one)
   and the probe epilogues at the search path's shape (phase
   ``parity_probe_path``: 1, 4, 16 and 512 blocks gathered from a K=20
   list, the broadcast forms with 512 probes, the ``*_rows`` forms with
   one probe a block).
   Then phase ``parity_decode_scale``: kernels 1, 3 and 4 over every
   posting of the search index (the lists of phase 4) in one launch each,
   held bit for bit and timed beside the bound, in billions of integers a
   second. Times from CUDA events with the L2 flushed before every launch.
4. search paths — a ClueWeb09-sized posting index (50M-doc universe, 16
   lists from each of the paper's length groups K=12, 16, 20, Zipf tfs,
   block_size 128, per-block checksum columns) built onto the card three
   ways, each served by
   ``SearchEngine(plan="auto")`` with every launch count set to 0 just
   before its workload and read just after: ``format="vbyte"`` (the
   first 25 queries), ``format="auto"`` (the first 50; its per-list
   partition DPs run in worker processes, one ``build_index`` call per
   term, merged on the card) and ``format="streamvbyte"`` (the first 25).
   Every query's result and ``QueryStats`` is then held equal to the plain
   ``plan="torch"`` engine's on the card (the replay runs in 6 spawned
   worker processes, each placing the index on the card from its numpy
   leaves without the checksum columns the indexes are built with: the
   same answers, accounting and bits/int, so the column is off the request
   path), and 10 AND/OR answers per path against numpy set operations
   on the host lists. A profiler window gives each path's device busy
   share.
   Then phase ``hardened_search`` over the three indexes, the launch
   counts set to 0 just before it and read just after: the startup gate
   (``SearchEngine(validate=True, n_shards=8)`` over all 48 terms: host
   validators, then kernel 2's ``checksum`` epilogue over every posting
   and impact list; 0 quarantined, 0 unsafe bounds; ``deep_validate`` over
   the K=12 terms); every stream corruption class that applies, on one
   K=16 term (seed 0): the checked decode on the card raises the plain
   plan's class at its block, and fresh engines (card and plain plan)
   quarantine exactly that term and answer a query over it and a clean
   term with the clean term's answer, flagged; ``max_impact`` understated
   on a K=12 term: ``topk_maxscore`` falls back to TAAT with the clean
   engine's answers; a transient fault retried to the exact answer, a
   persistent one empty and flagged after 3 errors; and, in one worker
   process per path, the shard-loss drill over the path's first 25
   queries (``serve.shard_loss_drill``: healthy, shard 3 silenced until
   the detector calls it dead, exactly the queries over its terms
   flagged and the rest bit-identical, then ``heal()`` and every answer
   bit-identical; the healthy answers equal the main path's). Then
   ``parity_checksum_path``: the ``checksum`` epilogue on one whole list
   of each group K=12, 16, 20 of each index, held bit for bit and timed
   beside its bound and the format's decode kernel on the same list.
   Then phase ``telemetry``: the reference's overhead measurement
   (``benchmarks/serving.py::_obs_overhead``: seed 7, a K=8 group of 8
   lists over 2^20 docs, 48 queries, 12 interleaved null / capture pairs)
   on the card in a process of its own, gated at
   ``null_path_overhead_pct`` < 3 and ``overhead_pct`` < 15; then one
   full capture over the ``vbyte`` path's
   first 25 queries with ``Telemetry(torch_annotations=True)`` and
   ``torch.profiler`` on: the three exports, the per-stage table and the
   report CLI's; every answer bit for bit the main path's, the summed
   ``decode_calls_total`` equal to the ``dispatch.decode`` calls (and the
   kernel launches at least that), every kernel of the port in the
   profiler's trace under a ``decode`` range whose span names its format
   and epilogue, ``serve_*_total`` mirroring ``serve_stats``.
   Then phase ``live_index``: a ``LiveIndex`` on local disk
   (``fsync=True``) on the card whose main segment is the ``auto`` path's
   index (48 terms, epoch 1 committed with ``ingest.write_epoch``, the
   commit ``merge`` makes); 20,000 acknowledged ops through ``LiveSearchEngine`` (adds of
   new docs with 1–4 of the 48 terms at tf 1–4, deletes with p 0.2 over
   the main segment's and the delta's docs); the ``auto`` path's first 25
   queries as and / or / topk, each answer equal to the materialize()
   oracle and to ``plan="torch"`` on the card; a restart replaying the
   whole WAL (a query during replay flagged ``replaying``; load, CRC,
   upload and replay seconds); one full-size merge (its phase seconds and
   launches), answers unchanged. The ``plan="torch"`` answers and the
   oracle come from a spawned worker on a copy of the directory, and the
   crash-point sweep runs over the K=12 ∪ K=16 terms (2,000 more ops) in
   another, both while this process serves: a merge crashed at a seeded
   point with 50 writes racing it, recovery, the retried merge checked at
   all 8 crash points and after commit.
5. path ``two_tower`` — two-tower-retrieval at full width (2^23 users and
   items) served by ``ServingEngine`` over 2^20 compressed candidates:
   256 requests drained at most 8, 4, 2 and 1 at a time, then 64 bags
   through ``embed_bags``; every top-k and bag held against the plain
   engine's, 5 requests against scores computed on the host.
6. path ``gin`` — gin-tu at full width over an ogbn-products-sized graph
   made from ``--seed``, adjacency compressed: both decodes of
   ``decode_compressed_edges``, ``forward`` and ``loss_fn`` (GIN's
   aggregation through ``owner_sum``); edges held bit for bit against the
   raw CSR and the plain plan, a second forward's logits bit for bit
   against the first, and the logits over the raw adjacency (the same
   edges in CSR order) bit for bit against the compressed one's. Then
   ``owner_sum`` at the graph's layer shapes, held bit for bit against
   its plain version on the CPU over a sample of owners (the 64 with the
   most edges and 2^16 more) and timed beside its bound, the plain
   version's ops on the card and cuSPARSE SpMM; and kernel 1 over the
   graph's gap stream, then kernel 2's adjacency_rebase over it with the
   forward's ``edge_base`` (beside kernel 1, the plain version and the
   unfused chain).
7. the ``kernels`` line, the card line, and the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import hashlib
import json
import multiprocessing as mp
import os
import subprocess
import sys
import time
from collections import Counter
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12  # CUDA-core rate of the data sheet's float32 line
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores (data sheet)
BF16_FLOPS_PER_S = 989e12  # bf16 tensor cores, dense (data sheet)
L2_FLUSH_BYTES = 64 << 20  # > the 50 MB L2: every timed launch starts cold
BLOCK = 128
N_PARITY_BLOCKS = 4096
REPLAY_WORKERS = 6  # processes replaying the main paths' torch plan (and
#                    building the auto index's terms)
CARD = ""  # "name, power limit" from nvidia-smi; set in phase 1
# decode kernel and kernel 2 core each main path must launch
PATH_KERNELS = {"vbyte": ("vbyte_decode_blocked", "vbyte"),
                "auto": ("binpack_decode_blocked", "binpack"),
                "streamvbyte": ("stream_decode_blocked", "streamvbyte")}
# the gather epilogues' tables: (label, dtype name, width) — the serving
# engine's bf16 item table [V, 256] and an f32 id-embedding table [V, 128],
# V = the two-tower vocabulary (2^23 items rounded to 512 rows)
GATHER_TABLES = (("bf16", "bfloat16", 256), ("f32", "float32", 128))
GATHER_ROWS = -(-((1 << 23) + 2) // 512) * 512
QUERY_ROWS = (1, 8)  # dot_score query rows: the smallest and largest bucket
DOT_PATH_ROWS = (1, 2, 4, 8)  # and every bucket, at the path's shape
BAG_BLOCK = 50  # embed_bags: one bag of seq_len = 50 slots per block
GATHER_EPILOGUES = ("bag_sum", "dot_score", "adjacency_rebase")
# kernel 2's broadcast epilogues, and the block counts of their launches on
# the search path: 1-16 gathered hit blocks per probe chunk, and 512
PROBE_EPILOGUES = ("membership", "bm25_accum", "bm25_weighted")
PATH_ROWS = (1, 4, 16, 512)
# and its row-aligned forms: one gathered block per probe, probe t against
# block t only (index/query.py's skip-pruned chunks)
ROWS_EPILOGUES = ("membership_rows", "bm25_accum_rows", "bm25_weighted_rows")
# GIN logits over compressed vs raw adjacency, per node, relative to the
# node's largest |logit|: printed as the bound a changed order of the f32
# sums would be held to (a bf16 rounding moved by one ulp, 2^-8 relative,
# in each of 5 layers); the run requires 0, since both forwards give
# owner_sum the same edges in the same (CSR) order
GIN_RTOL = 2.0**-4
# owner_sum's plain version on the CPU over these owners of the full graph:
# the top GIN_SAMPLE_TOP by in-degree and GIN_SAMPLE_OTHERS more
GIN_SAMPLE_TOP = 64
GIN_SAMPLE_OTHERS = 1 << 16
# the search index's length groups (K -> lists; K=20's count is a flag)
SEARCH_GROUPS = {12: 16, 16: 16}
# phase hardened_search: the shard-loss drill serves each search path's
# first HARDENED_QUERIES queries over HARDENED_SHARDS logical shards and
# loses shard VICTIM_SHARD; the retry checks allow RETRIES retries
HARDENED_QUERIES = 25
HARDENED_SHARDS = 8
VICTIM_SHARD = 3
RETRIES = 2


def emit(phase: str, **fields):
    print(json.dumps({"phase": phase, "card": CARD, **fields}), flush=True)


def die(msg: str, code: int = 1):
    print(json.dumps({"phase": "error", "card": CARD, "error": msg}),
          flush=True)
    sys.exit(code)


# ---------------------------------------------------------------------------
# phase 1: the device
# ---------------------------------------------------------------------------
def phase_device(torch):
    global CARD
    if not torch.cuda.is_available():
        die("torch.cuda.is_available() is False: this smoke runs on a GPU "
            "only", 2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if smi.returncode != 0:
        die(f"nvidia-smi failed: {smi.stderr.strip()}")
    CARD = smi.stdout.strip().splitlines()[0]
    emit("device", kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(),
         capability=list(torch.cuda.get_device_capability(0)),
         torch=torch.__version__, cuda=torch.version.cuda,
         python=sys.version.split()[0], host_cpus=os.cpu_count())
    return CARD


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def phase_build():
    from repro_torch.kernels import segment_sum
    from repro_torch.kernels.vbyte_decode import _build

    t0 = time.perf_counter()
    built = _build.build((*_build.SOURCES, segment_sum.SOURCE))
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         libraries={n: {"seconds": round(r.seconds, 3), "ptxas": r.ptxas}
                    for n, r in built.items()})


# ---------------------------------------------------------------------------
# phase 3: kernel parity and timing
# ---------------------------------------------------------------------------
class ColdTimer:
    """Per-launch CUDA-event timing with the L2 flushed before each launch.

    The host needs tens of microseconds to issue one launch, longer than
    the kernels run, so for every launch the card is first held in a sleep
    kernel while the host queues (flush, start event, call, end event);
    the card then runs them back to back and the start→end interval is
    device time only. One call per sleep keeps a plain version's hundreds
    of small ops inside CUDA's pending-launch queue. If queueing outlasted
    the sleep, the sleep is doubled and the launch measured again.
    """

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")
        self.sleep_cycles = 1 << 24

    def ms(self, fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        return sum(self._once(fn) for _ in range(reps)) / reps

    def ms_sync(self, fn, reps: int, warmup: int = 1) -> float:
        """CUDA events around each call of a function that synchronises
        with the host inside (a plain version that sizes an output from
        device data): device time plus the host's gaps, the L2 flushed
        before each call. For yardsticks that take milliseconds."""
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / reps

    def _once(self, fn) -> float:
        torch = self.torch
        for _ in range(8):
            torch.cuda.synchronize()
            s0, s1, start, end = (torch.cuda.Event(enable_timing=True)
                                  for _ in range(4))
            s0.record()
            torch.cuda._sleep(self.sleep_cycles)
            s1.record()
            t0 = time.perf_counter()
            self.flush.zero_()
            start.record()
            fn()
            end.record()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if host_ms < s0.elapsed_time(s1):
                return start.elapsed_time(end)
            self.sleep_cycles *= 2
        die("could not queue a timed launch ahead of the card")


def _encoders():
    from repro_torch.core.vbyte import binpack, encode, stream_vbyte

    return {"vbyte": encode.encode_ragged_blocked,
            "streamvbyte": stream_vbyte.encode_ragged_blocked,
            "binpack": binpack.encode_ragged_blocked}


def _dataset(np, rng, fmt, *, n_blocks: int, bits):
    """Ragged blocked operands of ``fmt``: every 7th block empty, block 1
    full at the widest bit length (so the stride reaches its widest), the
    rest with 1..B values of ``bits(i)`` bits, plus an aligned impact
    stream (< 2^8, as the index's) of the same format and counts."""
    enc_fn = _encoders()[fmt]
    lists = []
    for i in range(n_blocks):
        n = 0 if i % 7 == 0 else (BLOCK if i == 1 else
                                  int(rng.integers(1, BLOCK + 1)))
        lists.append(rng.integers(0, 2**bits(i), size=n, dtype=np.uint64))
    enc = enc_fn(lists, block_size=BLOCK)
    w_enc = enc_fn(
        [rng.integers(1, 256, size=len(l), dtype=np.uint64) for l in lists],
        block_size=BLOCK)
    bases = rng.integers(0, 2**32, size=n_blocks, dtype=np.uint64)
    return enc, w_enc, bases.astype(np.uint32).view(np.int32)


def _extras(np, torch, rng, grid, counts, w_ops, dev):
    """Epilogue operands on the card: a 512-wide sorted probe set (half
    drawn from the decoded values, padded with -1), one probe per block
    for the *_rows forms (some -1), an impact, the weight stream."""
    nb = grid.shape[0]
    valid = grid[np.arange(BLOCK)[None, :] < counts[:, None]]
    valid = valid[valid >= 0]
    probe = np.unique(np.concatenate([rng.choice(valid, 300),
                                      rng.integers(0, 2**31, 150)]))[:480]
    probe_b = np.full((1, 512), -1, np.int32)
    probe_b[0, :probe.size] = probe
    pick = grid[np.arange(nb), rng.integers(0, BLOCK, nb)]
    rows = np.where(rng.random(nb) < 0.25, -1, pick).astype(np.int32)[:, None]
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    return {"probe_b": t(probe_b), "probe_r": t(rows),
            "impact": t(np.array([[7]], np.int32)),
            "weights": {f"w_{k}": t(v) for k, v in w_ops.items()}}


def _bound(*, bytes_moved: float, ops: float,
           ops_per_s: float = INT_OPS_PER_S) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _bf16_ulps(torch, a, b) -> int:
    """The largest distance between ``a`` and ``b`` in bf16 steps (both hold
    bf16 values: bf16 tensors, or float32 ones that are exact bf16)."""
    def ordinal(x):
        v = x.to(torch.bfloat16).view(torch.int16).to(torch.int32)
        return torch.where(v < 0, -(v & 0x7FFF), v)

    return int((ordinal(a) - ordinal(b)).abs().max()) if a.numel() else 0


def _float_close(torch, o, r, *, bf16: bool, terms: int, s_abs,
                 ulps: int = 1):
    """Elementwise: ``o`` and ``r`` — two f32 sums of ``terms`` products,
    taken in different orders, each rounded once (to bf16 when ``bf16``) —
    agree within one bf16 ulp (bf16) or rtol = atol = 1e-5 (f32), or, where
    the sum cancels towards 0, within the two f32 sums' worst-case rounding
    error 2·terms·2^-24·Σ|product| (``s_abs``, the same sum over absolute
    values), plus one bf16 ulp (``ulps`` where the value was rounded that
    many times). Returns (ok, max abs err, max bf16 ulps, elements past
    the ulps / past rtol)."""
    of, rf = o.float(), r.float()
    diff = (of - rf).abs()
    if bf16:
        _, e = torch.frexp(torch.maximum(of.abs(), rf.abs()))
        ulp = torch.ldexp(torch.ones_like(diff), e - 8) * ulps
    else:
        ulp = 1e-5 + 1e-5 * rf.abs()
    near = diff <= ulp
    bound = ulp + 2.0 * terms * 2.0**-24 * s_abs.float() * 1.01
    ok = bool((diff <= bound).all())
    err = float(diff.max()) if diff.numel() else 0.0
    max_ulps = _bf16_ulps(torch, o, r) if bf16 else 0
    return ok, err, max_ulps, int((~near).sum())


def _hold(torch, outs, refs, table_label, what: str, *, terms: int = 0,
          s_abs=None) -> tuple[float, int]:
    """Hold a kernel's outputs against its plain version's: integer outputs
    bit for bit, float outputs by :func:`_float_close` (``s_abs`` the
    float output's sum over absolute values). Dies beyond that; returns
    (max abs error, max bf16 ulps)."""
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    err, ulps = 0.0, 0
    for o, r in zip(outs, refs):
        if o.shape != r.shape or o.dtype != r.dtype:
            die(f"{what}: shape/dtype {tuple(o.shape)} {o.dtype} != "
                f"{tuple(r.shape)} {r.dtype}")
        if not o.is_floating_point():
            if not torch.equal(o, r):
                die(f"{what}: integer output differs from the plain version")
            continue
        ok, e, u, past = _float_close(torch, o, r, bf16=table_label == "bf16",
                                      terms=terms, s_abs=s_abs)
        err, ulps = max(err, e), max(ulps, u)
        if not ok:
            die(f"{what}: beyond the stated tolerance of the plain version "
                f"(max abs err {e}, {u} bf16 ulps, {past} past one ulp)")
    return err, ulps


def _abs_sums(epilogues, ops, name, extras, kw):
    """The plain version over |table| and |query|: Σ|product| per output."""
    ex = {k: v.abs() for k, v in extras.items()}
    out = epilogues.fused_decode_plain(ops, ex, epilogue=name, **kw)
    return out[1] if name == "dot_score" else out


def _terms(name, extras, B):
    return extras["table"].shape[1] if name == "dot_score" else B


def _gather_tables(torch):
    """The gather epilogues' tables and query matrices on the card: bf16
    rows and queries of norm 1 (as the item tower's outputs), f32 rows at
    the id embeddings' scale (stddev 0.02)."""
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    tables, queries = {}, {}
    for label, dtype_name, d in GATHER_TABLES:
        dtype = getattr(torch, dtype_name)
        t = torch.randn(GATHER_ROWS, d, device="cuda", generator=g)
        q = torch.randn(max(QUERY_ROWS), d, device="cuda", generator=g)
        if label == "bf16":
            t = t.div_(t.norm(dim=1, keepdim=True))
            q = q.div_(q.norm(dim=1, keepdim=True))
        else:
            t = t.mul_(0.02)
        tables[label] = t.to(dtype)
        queries[label] = q.to(dtype)
        del t
    return tables, queries


def _gather_variants(tables, queries, edge_base):
    """(record key, epilogue, extras, table label) of every variant of the
    gather epilogues, and of adjacency_rebase when ``edge_base`` is given."""
    out = []
    for label, table in tables.items():
        out.append((f"bag_sum/{label}", "bag_sum", {"table": table}, label))
        for nq in QUERY_ROWS:
            out.append((f"dot_score/{label}/q{nq}", "dot_score",
                        {"table": table, "query": queries[label][:nq]}, label))
    if edge_base is not None:
        out.append(("adjacency_rebase", "adjacency_rebase",
                    {"edge_base": edge_base}, None))
    return out


def _max_err(outs, refs) -> int:
    outs = outs if isinstance(outs, tuple) else (outs,)
    refs = refs if isinstance(refs, tuple) else (refs,)
    if not all(o.shape == r.shape for o, r in zip(outs, refs)):
        return -1
    return max(int((o.long() - r.long()).abs().max()) if o.numel() else 0
               for o, r in zip(outs, refs))


# (format, decode-kernel record name, datasets: label → bits(rng, i));
# the first dataset of each format is the one kernel 2 is timed on, at
# stride 128 like the main path's narrowest lists
def _parity_plan(rng):
    return (
        ("vbyte", "vbyte_decode_blocked", (
            ("S128", lambda i: 7 if i == 1 else int(rng.integers(1, 8))),
            ("S640", lambda i: 32 if i == 1 else int(rng.integers(1, 33))))),
        ("streamvbyte", "stream_decode_blocked", (
            ("S128", lambda i: 8 if i == 1 else int(rng.integers(1, 9))),
            ("S512", lambda i: 32 if i == 1 else int(rng.integers(1, 33))))),
        ("binpack", "binpack_decode_blocked", (
            ("S128", lambda i: 8 if i == 1 else int(rng.integers(0, 9))),
            ("W0-32", lambda i: 32 if i == 1 else i % 33))),
    )


def phase_parity(np, torch, timer):
    """Every kernel against its plain version; returns timing records and
    the largest difference seen per kernel."""
    from repro_torch.kernels.vbyte_decode import epilogues
    from repro_torch.kernels.vbyte_decode.dispatch import CUDA_DECODERS

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    records = {"fused_decode": {}}
    max_err = {"fused_decode": 0, "fused_decode_float": 0.0}
    tables, queries = _gather_tables(torch)
    for fmt, kname, datasets in _parity_plan(rng):
        records[kname], max_err[kname] = {}, 0
        decode, plain = CUDA_DECODERS[fmt], epilogues.PLAIN_DECODERS[fmt]
        for label, bits in datasets:
            enc, w_enc, bases = _dataset(np, rng, fmt,
                                         n_blocks=N_PARITY_BLOCKS, bits=bits)
            names = epilogues.FORMAT_OPERANDS[fmt]
            leaves = [torch.as_tensor(np.ascontiguousarray(getattr(enc, k)),
                                      device=dev) for k in names]
            c = torch.as_tensor(enc.counts, device=dev)
            b = torch.as_tensor(bases, device=dev)
            nb, S = leaves[-1].shape
            n_ints = int(enc.counts.sum())
            need = enc.payload_bytes + 8 * nb  # consumed bytes + count/base
            if label == "W0-32" and set(range(33)) - set(
                    enc.widths.reshape(-1).tolist()):
                die("the binpack parity data misses a width in 0..32")
            for differential in (False, True):
                kw = dict(block_size=BLOCK, differential=differential)
                out = decode(*leaves, c, b, **kw)
                ref = plain(*leaves, c, b, **kw)
                torch.cuda.synchronize()
                err = _max_err(out, ref)
                max_err[kname] = max(max_err[kname], abs(err))
                if err or not torch.equal(out, ref):
                    die(f"{kname} differs from its plain version: {fmt} "
                        f"{label} differential={differential} "
                        f"max_abs_err={err}")
                rec = {"format": fmt, "n_blocks": nb, "stride": S,
                       "differential": differential, "max_abs_err": err}
                if differential or label == datasets[1][0]:
                    bound, by = _bound(
                        bytes_moved=need + 4 * nb * BLOCK,
                        ops=enc.payload_bytes if fmt == "vbyte" else n_ints)
                    rec.update(
                        ms=timer.ms(lambda: decode(*leaves, c, b, **kw),
                                    reps=50),
                        plain_ms=timer.ms(lambda: plain(*leaves, c, b, **kw),
                                          reps=10),
                        bound_ms=bound, bound_by=by)
                records[kname][f"{label}/diff={int(differential)}"] = rec
                emit(f"parity_{kname}", dataset=label, **rec)

                grid = ref.cpu().numpy()
                w_ops = {k: np.ascontiguousarray(getattr(w_enc, k))
                         for k in names}
                ex = _extras(np, torch, rng, grid, enc.counts, w_ops, dev)
                ops = dict(zip(names, leaves), counts=c, bases=b)
                for name, ep in epilogues.EPILOGUES.items():
                    if name in GATHER_EPILOGUES:
                        continue  # below, and timed in phase_gather
                    extras = {}
                    if "probe" in ep.extras:
                        extras["probe"] = (ex["probe_r"] if "probe" in
                                           ep.tiled_extras else ex["probe_b"])
                    if "impact" in ep.extras:
                        extras["impact"] = ex["impact"]
                    if name.startswith("bm25_weighted"):
                        extras.update(ex["weights"])
                    kw2 = dict(format=fmt, epilogue=name, block_size=BLOCK,
                               differential=differential)
                    outs = epilogues.fused_decode(ops, extras, **kw2)
                    refs = epilogues.fused_decode_plain(ops, extras, **kw2)
                    torch.cuda.synchronize()
                    err = _max_err(outs, refs)
                    max_err["fused_decode"] = max(max_err["fused_decode"],
                                                  abs(err))
                    if err:
                        die(f"kernel 2 [{fmt}/{name}] differs from its plain "
                            f"version: {label} differential={differential} "
                            f"max_abs_err={err}")
                    rec = {"format": fmt, "epilogue": name, "n_blocks": nb,
                           "stride": S, "differential": differential,
                           "max_abs_err": err}
                    # timed: every epilogue on sorted rows, and the
                    # broadcast ones on unsorted rows (their slot-by-slot
                    # branch)
                    if label == datasets[0][0] and (
                            differential or name in PROBE_EPILOGUES):
                        P = (extras["probe"].shape[-1] if "probe" in extras
                             else 0)
                        outs_t = outs if isinstance(outs, tuple) else (outs,)
                        out_bytes = sum(o.numel() * 4 for o in outs_t)
                        in_bytes = need + (
                            4 * extras["probe"].numel() if "probe" in extras
                            else 0) + (w_enc.payload_bytes
                                       if name.startswith("bm25_weighted")
                                       else 0)
                        n_ops = enc.payload_bytes + nb * P + n_ints
                        bound, by = _bound(bytes_moved=in_bytes + out_bytes,
                                           ops=n_ops)
                        rec.update(
                            ms=timer.ms(lambda: epilogues.fused_decode(
                                ops, extras, **kw2), reps=50),
                            plain_ms=timer.ms(
                                lambda: epilogues.fused_decode_plain(
                                    ops, extras, **kw2), reps=5),
                            bound_ms=bound, bound_by=by)
                        suffix = "" if differential else "/unsorted"
                        records["fused_decode"][f"{fmt}/{name}{suffix}"] = rec
                    emit("parity_fused_decode", dataset=label, **rec)
                # the gather epilogues on these values as ids: most lie
                # past the table or below 0 as int32 and are clamped
                eb = (torch.as_tensor(rng.integers(-2**31, 2**31, (nb, BLOCK))
                                      .astype(np.int32), device=dev)
                      if differential else None)
                for key, name, extras, tl in _gather_variants(
                        tables, queries, eb):
                    kw1 = dict(format=fmt, block_size=BLOCK,
                               differential=differential)
                    kw2 = dict(epilogue=name, **kw1)
                    err, ulps = _hold(
                        torch, epilogues.fused_decode(ops, extras, **kw2),
                        epilogues.fused_decode_plain(ops, extras, **kw2), tl,
                        f"kernel 2 [{fmt}/{key}] {label} "
                        f"differential={differential}",
                        terms=_terms(name, extras, BLOCK),
                        s_abs=(_abs_sums(epilogues, ops, name, extras, kw1)
                               if tl else None))
                    max_err["fused_decode_float"] = max(
                        max_err["fused_decode_float"], err)
                    emit("parity_fused_decode", dataset=label, format=fmt,
                         epilogue=key, ids="garbage", n_blocks=nb,
                         differential=differential, max_abs_err=err,
                         max_bf16_ulps=ulps)
    phase_gather(np, torch, timer, tables, queries, records, max_err)
    phase_dot_score_path(np, torch, timer, tables, queries, records, max_err)
    phase_probe_path(np, torch, timer, records, max_err)
    return records, max_err


def _id_lists(np, rng, n_blocks: int, B: int):
    """Ragged bags of sorted item ids in [1, GATHER_ROWS): every 7th empty,
    the rest 1..B ids, distinct within the whole set."""
    counts = [0 if i % 7 == 0 else int(rng.integers(1, B + 1))
              for i in range(n_blocks)]
    ids = rng.choice(np.arange(1, GATHER_ROWS, dtype=np.int64),
                     sum(counts), replace=False)
    out, at = [], 0
    for n in counts:
        out.append(np.sort(ids[at:at + n]).astype(np.uint64))
        at += n
    return out


def gather_stats(np, torch, fmt, ops, payload_bytes: int, B: int,
                 differential: bool) -> dict:
    """What the gather epilogues' bounds count over these blocks: the
    compressed bytes + 8 B a block (count and base), the valid ids, the
    distinct valid ids, and those plus row 0 where any slot is a pad."""
    from repro_torch.kernels.vbyte_decode import epilogues
    from repro_torch.kernels.vbyte_decode.dispatch import CUDA_DECODERS

    leaves = [ops[k] for k in epilogues.FORMAT_OPERANDS[fmt]]
    c, b = ops["counts"], ops["bases"]
    nb = c.shape[0]
    grid = CUDA_DECODERS[fmt](*leaves, c, b, block_size=B,
                              differential=differential)
    valid = torch.arange(B, device=grid.device)[None, :] < c[:, None]
    n_valid = int(valid.sum())
    distinct = int(torch.unique(grid[valid]).numel())
    return {"fmt": fmt, "B": B, "differential": differential, "nb": nb,
            "stride": leaves[-1].shape[1], "need": payload_bytes + 8 * nb,
            "valid": valid, "n_valid": n_valid, "distinct_valid": distinct,
            "distinct_all": distinct + int(n_valid < nb * B)}


def gather_bound(name, extras, tl, st) -> tuple[float, str]:
    """The least time of one gather epilogue launch: every compressed byte
    and count/base, each distinct table row and the query read once, the
    outputs written once; or its products at the table type's peak rate."""
    t = extras.get("table")
    es = t.element_size() if t is not None else 0
    d = t.shape[1] if t is not None else 0
    nb, B = st["nb"], st["B"]
    if name == "bag_sum":
        return _bound(bytes_moved=st["need"] + (st["distinct_valid"] + nb)
                      * d * es, ops=st["n_valid"] * d,
                      ops_per_s=F32_FLOPS_PER_S)
    if name == "dot_score":
        nq = extras["query"].shape[0]
        return _bound(bytes_moved=st["need"] + st["distinct_all"] * d * es
                      + nq * d * es + nb * B * 4 * (1 + nq),
                      ops=2 * nb * B * nq * d,
                      ops_per_s=(BF16_FLOPS_PER_S if tl == "bf16"
                                 else F32_FLOPS_PER_S))
    return _bound(bytes_moved=st["need"] + 2 * nb * B * 4, ops=st["n_valid"])


def gather_chain(torch, name, extras, ops, st):
    """The unfused chain: the format's decode kernel, then one PyTorch call
    (``F.embedding_bag``; index + ``einsum``; the torch body of
    adjacency_rebase). A yardstick, never called by the port."""
    import torch.nn.functional as F

    from repro_torch.kernels.vbyte_decode import epilogues
    from repro_torch.kernels.vbyte_decode.dispatch import (CUDA_DECODERS,
                                                           DecodePlan, decode)

    fmt = st["fmt"]
    kw = dict(block_size=st["B"], differential=st["differential"])
    leaves = [ops[k] for k in epilogues.FORMAT_OPERANDS[fmt]]
    c, b = ops["counts"], ops["bases"]
    t = extras.get("table")
    if name == "bag_sum":
        w = st["valid"].to(t.dtype)
        return lambda: F.embedding_bag(
            CUDA_DECODERS[fmt](*leaves, c, b, **kw), t, mode="sum",
            per_sample_weights=w)
    if name == "dot_score":
        q = extras["query"]
        eq = "tbd,d->tb" if q.shape[0] == 1 else "tbd,qd->tbq"
        qq = q[0] if q.shape[0] == 1 else q
        return lambda: torch.einsum(
            eq, t[CUDA_DECODERS[fmt](*leaves, c, b, **kw)], qq)
    return lambda: decode(ops, format=fmt, epilogue=name,
                          epilogue_operands=extras,
                          plan=DecodePlan("cuda", fused=False), **kw)


def hold_gather(torch, key, name, extras, tl, ops, st, fused, plain):
    """A gather epilogue's launch against its plain version (ids bit for
    bit, floats by :func:`_float_close`); returns (max abs err, ulps)."""
    from repro_torch.kernels.vbyte_decode import epilogues

    kw1 = dict(format=st["fmt"], block_size=st["B"],
               differential=st["differential"])
    return _hold(torch, fused(), plain(), tl,
                 f"kernel 2 [{st['fmt']}/{key}] B={st['B']} nb={st['nb']}",
                 terms=_terms(name, extras, st["B"]),
                 s_abs=(_abs_sums(epilogues, ops, name, extras, kw1)
                        if tl else None))


def time_gather(torch, timer, key, name, extras, tl, ops, st,
                max_err) -> dict:
    """Hold one gather variant against its plain version, then time it (L2
    cold) beside the bound, the plain version and the unfused chain."""
    from repro_torch.kernels.vbyte_decode import epilogues

    kw2 = dict(format=st["fmt"], epilogue=name, block_size=st["B"],
               differential=st["differential"])
    fused = lambda: epilogues.fused_decode(ops, extras, **kw2)  # noqa: E731
    plain = lambda: epilogues.fused_decode_plain(ops, extras, **kw2)  # noqa: E731
    err, ulps = hold_gather(torch, key, name, extras, tl, ops, st, fused,
                            plain)
    max_err["fused_decode_float"] = max(max_err["fused_decode_float"], err)
    chain = gather_chain(torch, name, extras, ops, st)
    # the yardstick computes the same function (recorded, not held: it is
    # not the port's)
    want = plain()
    want = want[1] if name == "dot_score" else want
    got = chain()
    chain_err = (float((got.float() - want.float()).abs().max())
                 if got.is_floating_point() else float((got != want).sum()))
    del want, got
    bound, by = gather_bound(name, extras, tl, st)
    return {"format": st["fmt"], "epilogue": key, "block_size": st["B"],
            "n_blocks": st["nb"], "stride": st["stride"],
            "differential": st["differential"], "n_ids": st["n_valid"],
            "distinct_ids": st["distinct_valid"], "max_abs_err": err,
            "max_bf16_ulps": ulps,
            "ms": timer.ms(fused, reps=30),
            "plain_ms": timer.ms(plain, reps=5),
            "unfused_chain_ms": timer.ms(chain, reps=10),
            "unfused_chain_max_abs_err": chain_err,
            "bound_ms": bound, "bound_by": by}


def gather_parity_cases(np, torch, tables, queries):
    """bag_sum, dot_score (1- and 8-row queries) and adjacency_rebase over
    realistic ids (the retrieval corpus's layout: sorted item ids, per-bag
    differential, 4096 blocks of B = 128, count-0 blocks and ragged tails)
    on each core, plus bag_sum over the embedding-bag endpoint's B = 50
    bags. Yields ``(ops, stats, variants)``."""
    from repro_torch.kernels.vbyte_decode import epilogues

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    cases = [(fmt, BLOCK, True) for fmt in ("vbyte", "streamvbyte",
                                            "binpack")]
    cases.append(("vbyte", BAG_BLOCK, False))  # embed_bags' layout
    for fmt, B, differential in cases:
        lists = _id_lists(np, rng, N_PARITY_BLOCKS, B)
        enc = _encoders()[fmt](lists, block_size=B, differential=differential)
        names = epilogues.FORMAT_OPERANDS[fmt]
        ops = {k: torch.as_tensor(np.ascontiguousarray(getattr(enc, k)),
                                  device=dev) for k in names}
        ops["counts"] = torch.as_tensor(enc.counts, device=dev)
        ops["bases"] = torch.as_tensor(enc.bases.view(np.int32), device=dev)
        st = gather_stats(np, torch, fmt, ops, enc.payload_bytes, B,
                          differential)
        eb = torch.as_tensor(rng.integers(0, 2**31, (st["nb"], B))
                             .astype(np.int32), device=dev)
        variants = _gather_variants(tables, queries,
                                    eb if differential else None)
        if B == BAG_BLOCK:
            variants = [v for v in variants if v[1] == "bag_sum"]
        yield ops, st, variants


def phase_gather(np, torch, timer, tables, queries, records, max_err):
    """The gather epilogues at the parity shape (:func:`gather_parity_cases`),
    held against their plain versions and timed (:func:`time_gather`)."""
    for ops, st, variants in gather_parity_cases(np, torch, tables, queries):
        for key, name, extras, tl in variants:
            rec = time_gather(torch, timer, key, name, extras, tl, ops, st,
                              max_err)
            suffix = "" if st["B"] == BLOCK else f"/B{st['B']}"
            records["fused_decode"][f"{st['fmt']}/{key}{suffix}"] = rec
            emit("parity_fused_decode_gather", **rec)


def dot_path_case(np, torch, tables, queries):
    """``dot_score`` at the two_tower path's shape: the serving corpus as
    :func:`run_two_tower` builds it (2^20 distinct sorted candidate ids in
    [1, GATHER_ROWS), vbyte, differential, block 128: 8,192 full blocks)
    against the bf16 item table ``[GATHER_ROWS, 256]`` with every query
    bucket (1, 2, 4, 8 rows) and the f32 table with 8 rows. Returns
    ``(ops, stats, variants)``."""
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.core import CompressedIntArray

    rng = np.random.default_rng(4)
    n_cand = RECSYS_SHAPES["retrieval_cand"].dims["n_candidates"]
    cands = np.sort(rng.choice(np.arange(1, GATHER_ROWS, dtype=np.int64),
                               n_cand, replace=False)).astype(np.uint64)
    arr = CompressedIntArray.encode(cands, differential=True, device="cuda")
    ops = arr.device_operands()
    st = gather_stats(np, torch, "vbyte", ops, arr.payload_bytes, BLOCK, True)
    if st["nb"] * BLOCK != n_cand or st["distinct_valid"] != n_cand:
        die("dot_score path data: not 2^20 distinct ids in full blocks")
    variants = [(f"dot_score/bf16/q{nq}", "dot_score",
                 {"table": tables["bf16"], "query": queries["bf16"][:nq]},
                 "bf16") for nq in DOT_PATH_ROWS]
    variants.append(("dot_score/f32/q8", "dot_score",
                     {"table": tables["f32"], "query": queries["f32"][:8]},
                     "f32"))
    return ops, st, variants


def phase_dot_score_path(np, torch, timer, tables, queries, records,
                         max_err):
    """``dot_score`` at the two_tower path's shape (:func:`dot_path_case`),
    held against its plain version and timed (:func:`time_gather`)."""
    from repro_torch.kernels.vbyte_decode.dispatch import CUDA_DECODERS

    ops, st, variants = dot_path_case(np, torch, tables, queries)
    ids = CUDA_DECODERS["vbyte"](ops["payload"], ops["counts"], ops["bases"],
                                 block_size=BLOCK, differential=True)
    ids = ids.reshape(-1).long()
    # a yardstick for the row gather alone: one index_select of the same
    # rows (reads them and writes them once), per table
    gather_ms = {tl: timer.ms(lambda t=t: t.index_select(0, ids), reps=10)
                 for tl, t in tables.items()}
    records["dot_score_path"] = {}
    for key, name, extras, tl in variants:
        rec = time_gather(torch, timer, key, name, extras, tl, ops, st,
                          max_err)
        rec["index_select_ms"] = gather_ms[tl]
        records["dot_score_path"][key] = rec
        emit("parity_dot_score_path", **rec)


def _gap_bytes(np, fmt: str, gaps, counts) -> int:
    """Compressed bytes a decode of ``fmt`` reads for ``gaps`` (uint64
    [nb, B], 0 past each count): VByte 1-5 bytes per value, Stream VByte
    1-4 data bytes per value plus B/4 control bytes per block, binpack one
    width byte plus count x width bits per block."""
    B = gaps.shape[1]
    valid = np.arange(B)[None, :] < counts[:, None]
    if fmt == "vbyte":
        n = 1 + sum((gaps >= 1 << (7 * k)).astype(np.int64)
                    for k in range(1, 5))
        return int(n[valid].sum())
    if fmt == "streamvbyte":
        n = 1 + sum((gaps >= 1 << (8 * k)).astype(np.int64)
                    for k in range(1, 4))
        return int(n[valid].sum()) + gaps.shape[0] * (B // 4)
    widths = np.array([int(x).bit_length() for x in
                       np.where(valid, gaps, 0).max(axis=1)], np.int64)
    return int(gaps.shape[0] + ((counts * widths + 7) // 8).sum())


def probe_path_cases(np, torch, rng):
    """Kernel 2's probe launches at the search path's shapes, per core:
    a K=20 posting list (as the search paths draw them, ClueWeb09-sized
    universe) and its per-posting impacts (< 2^8, as the index's) encoded
    in the core's format (d-gaps, block 128) on the card; for each of
    ``PATH_ROWS`` block counts, that many distinct blocks gathered from it
    in ascending order (``take_blocks``, as ``_probe_pass`` gathers its hit
    blocks). The broadcast epilogues take a 512-wide probe set: 256 docids
    drawn from the gathered blocks and 256 from the docid window they
    span, sorted, distinct, padded with -1. The ``*_rows`` forms take one
    probe per block (``[nb, 1]``, as ``_probe_pass`` builds it for probes
    that route to distinct blocks): a docid of the block or, for half the
    blocks, one drawn from the block's docid window (the same probes for
    every core, from their own generator). Yields ``(fmt, nb, ops, extras
    by epilogue, bytes in by epilogue, values decoded)``."""
    from repro_torch.core import CompressedIntArray
    from repro_torch.data.synthetic import CLUEWEB_DOCS, posting_list_group
    from repro_torch.kernels.vbyte_decode.ops import normalize_probe

    docs = posting_list_group(rng, 20, 1, universe=CLUEWEB_DOCS)[0]
    docs = docs.astype(np.uint64)
    impacts = rng.integers(1, 256, docs.size).astype(np.uint64)
    n_blocks = -(-docs.size // BLOCK)
    gaps = np.diff(docs, prepend=np.uint64(0))  # block bases: the docid before
    pad = n_blocks * BLOCK - docs.size
    blocks = {k: np.pad(v, (0, pad)).reshape(n_blocks, BLOCK)
              for k, v in (("docs", docs), ("gaps", gaps), ("imp", impacts))}
    counts = np.minimum(BLOCK, docs.size - BLOCK * np.arange(n_blocks))
    for fmt in ("vbyte", "streamvbyte", "binpack"):
        arr = CompressedIntArray.encode(docs, format=fmt, block_size=BLOCK,
                                        differential=True, device="cuda")
        imp = CompressedIntArray.encode(impacts, format=fmt,
                                        block_size=BLOCK, device="cuda")
        for nb in PATH_ROWS:
            rows = np.sort(rng.choice(n_blocks, nb, replace=False))
            c = counts[rows]
            host = blocks["docs"][rows]
            sub = arr.take_blocks(rows)
            ops = sub.device_operands()
            grid = sub.decode_blocked(plan="cuda")
            valid = np.arange(BLOCK)[None, :] < c[:, None]
            if not np.array_equal(grid.cpu().numpy().view(np.uint32)[valid],
                                  host[valid].astype(np.uint32)):
                die(f"probe path data: {fmt} blocks decode to other docids")
            ids = host[valid]
            lo, hi = int(ids.min()), int(ids.max())
            probe = np.unique(np.concatenate([rng.choice(ids, 256),
                                              rng.integers(lo, hi + 1, 256)]))
            probe = torch.as_tensor(normalize_probe(probe[:512], 512),
                                    device="cuda")
            w_ops = {f"w_{k}": v for k, v in
                     imp.take_blocks(rows).device_operands().items()
                     if k in ("payload", "control", "data", "widths")}
            main = _gap_bytes(np, fmt, blocks["gaps"][rows], c) + 8 * nb
            extras = {
                "membership": {"probe": probe},
                "bm25_accum": {"probe": probe, "impact": torch.tensor(
                    [[7]], dtype=torch.int32, device="cuda")},
                "bm25_weighted": {"probe": probe, **w_ops}}
            w_bytes = _gap_bytes(np, fmt, blocks["imp"][rows], c)
            in_bytes = {"membership": main + 4 * 512,
                        "bm25_accum": main + 4 * 512 + 4,
                        "bm25_weighted": main + 4 * 512 + w_bytes}
            rrng = np.random.default_rng(1000 + nb)
            at = np.arange(nb)
            pick = host[at, rrng.integers(0, c)]
            window = rrng.integers(host[:, 0], host[at, c - 1] + 1)
            probe_r = torch.as_tensor(
                np.where(rrng.random(nb) < 0.5, pick, window)
                .astype(np.int32)[:, None], device="cuda")
            extras.update({
                "membership_rows": {"probe": probe_r},
                "bm25_accum_rows": {"probe": probe_r, "impact":
                                    extras["bm25_accum"]["impact"]},
                "bm25_weighted_rows": {"probe": probe_r, **w_ops}})
            in_bytes.update({"membership_rows": main + 4 * nb,
                             "bm25_accum_rows": main + 4 * nb + 4,
                             "bm25_weighted_rows": main + 4 * nb + w_bytes})
            yield fmt, nb, ops, extras, in_bytes, int(c.sum())


def phase_probe_path(np, torch, timer, records, max_err):
    """The broadcast epilogues and their ``*_rows`` forms at the search
    path's shapes (:func:`probe_path_cases`): held bit for bit against
    their plain versions and timed (L2 cold) beside the bound and the
    plain version."""
    from repro_torch.kernels.vbyte_decode import epilogues

    rng = np.random.default_rng(3)
    records["probe_path"] = {}
    for fmt, nb, ops, extras, in_bytes, n_ints in probe_path_cases(np, torch,
                                                                 rng):
        for name in PROBE_EPILOGUES + ROWS_EPILOGUES:
            ex = extras[name]
            kw = dict(format=fmt, epilogue=name, block_size=BLOCK,
                      differential=True)
            out = epilogues.fused_decode(ops, ex, **kw)
            ref = epilogues.fused_decode_plain(ops, ex, **kw)
            torch.cuda.synchronize()
            err = _max_err(out, ref)
            max_err["fused_decode"] = max(max_err["fused_decode"], abs(err))
            if err or not torch.equal(out, ref):
                die(f"kernel 2 [{fmt}/{name}] differs from its plain version "
                    f"at the path's shape: nb={nb} max_abs_err={err}")
            P = ex["probe"].shape[-1]
            bound, by = _bound(bytes_moved=in_bytes[name] + 4 * nb * P,
                               ops=in_bytes[name] + nb * P + n_ints)
            rec = {"format": fmt, "epilogue": name, "n_blocks": nb,
                   "P": P, "hits": int((ref != 0).sum()),
                   "max_abs_err": err,
                   "ms": timer.ms(lambda: epilogues.fused_decode(ops, ex,
                                                                 **kw),
                                  reps=50),
                   "plain_ms": timer.ms(lambda: epilogues.fused_decode_plain(
                       ops, ex, **kw), reps=5),
                   "bound_ms": bound, "bound_by": by}
            records["probe_path"][f"{fmt}/{name}/nb{nb}"] = rec
            emit("parity_probe_path", **rec)


DECODE_KERNELS = (("vbyte", "vbyte_decode_blocked"),
                  ("streamvbyte", "stream_decode_blocked"),
                  ("binpack", "binpack_decode_blocked"))


def search_index_lists(np, seed: int, k20_lists: int) -> dict:
    """The search paths' posting lists (``phase_main_paths`` draws the same
    ones from the same seed): term -> sorted uint32 docids."""
    from repro_torch.data.synthetic import CLUEWEB_DOCS
    from repro_torch.launch.serve import search_lists

    lists, _ = search_lists(np.random.default_rng(seed),
                            {**SEARCH_GROUPS, 20: k20_lists},
                            universe=CLUEWEB_DOCS)
    return lists


def decode_stats(fmt: str, ops: dict, payload_bytes: int,
                 n_ints: int) -> dict:
    """What a decode kernel's bound counts over these blocks: the
    compressed bytes (``payload_bytes``: Stream VByte's control bytes and
    binpack's width bytes included), 8 B a block of count and base, 4·B
    output bytes a block; one operation per compressed byte (vbyte) or
    value."""
    nb = ops["counts"].shape[0]
    main = ops["payload" if fmt == "vbyte" else "data"]
    bound, by = _bound(bytes_moved=payload_bytes + 8 * nb + 4 * nb * BLOCK,
                       ops=payload_bytes if fmt == "vbyte" else n_ints)
    return {"format": fmt, "n_blocks": nb, "stride": main.shape[1],
            "n_ints": n_ints, "payload_bytes": payload_bytes,
            "bound_ms": bound, "bound_by": by}


def scale_case(np, torch, fmt: str, lists: dict, *, stride: int = 0):
    """Every posting of the search index in one operand set on the card:
    each list encoded in ``fmt`` on its own (d-gaps, block 128, the docid
    before a block as its base, as the index stores it), the lists' blocks
    concatenated and every row padded to the widest list's stride (or to
    ``stride``, if wider). Returns ``(ops, stats)``."""
    from repro_torch.core import CompressedIntArray
    from repro_torch.kernels.vbyte_decode import epilogues

    names = epilogues.FORMAT_OPERANDS[fmt]
    main = names[-1]
    parts, payload_bytes, n_ints = [], 0, 0
    for t in sorted(lists):
        arr = CompressedIntArray.encode(lists[t].astype(np.uint64),
                                        format=fmt, block_size=BLOCK,
                                        differential=True, device="cpu")
        parts.append(arr.leaves_numpy())
        payload_bytes += arr.payload_bytes
        n_ints += arr.n
    S = max([stride] + [p[main].shape[1] for p in parts])
    leaves = {k: np.concatenate([
        np.pad(p[k], ((0, 0), (0, S - p[k].shape[1]))) if k == main
        else p[k] for p in parts]) for k in names + ("counts", "bases")}
    leaves["bases"] = leaves["bases"].view(np.int32)
    ops = {k: torch.as_tensor(np.ascontiguousarray(v), device="cuda")
           for k, v in leaves.items()}
    return ops, decode_stats(fmt, ops, payload_bytes, n_ints)


def time_decode(torch, timer, fmt: str, ops: dict, st: dict, *,
                reps: int, plain_reps: int) -> dict:
    """A decode kernel held bit for bit against its plain version on
    ``ops`` (differential), then timed (L2 cold) beside both; with
    billions of integers a second, the paper's unit."""
    from repro_torch.kernels.vbyte_decode import epilogues
    from repro_torch.kernels.vbyte_decode.dispatch import CUDA_DECODERS

    leaves = [ops[k] for k in epilogues.FORMAT_OPERANDS[fmt]]
    c, b = ops["counts"], ops["bases"]
    kw = dict(block_size=BLOCK, differential=True)
    dec = CUDA_DECODERS[fmt]
    plain = epilogues.PLAIN_DECODERS[fmt]
    out, ref = dec(*leaves, c, b, **kw), plain(*leaves, c, b, **kw)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    if err or not torch.equal(out, ref):
        die(f"{fmt} decode differs from its plain version at "
            f"{st['n_blocks']} blocks: max_abs_err={err}")
    del out, ref
    ms = timer.ms(lambda: dec(*leaves, c, b, **kw), reps=reps)
    plain_ms = timer.ms(lambda: plain(*leaves, c, b, **kw), reps=plain_reps)
    return {**st, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "gints_per_s": st["n_ints"] / ms / 1e6,
            "plain_gints_per_s": st["n_ints"] / plain_ms / 1e6}


def phase_decode_scale(np, torch, timer, records, max_err, args):
    """Kernels 1, 3 and 4 over every posting of the search index in one
    launch each (:func:`scale_case`): held bit for bit against their plain
    versions and timed beside the bound; the kernels line's ``scale``."""
    lists = search_index_lists(np, args.seed, args.k20_lists)
    for fmt, kname in DECODE_KERNELS:
        ops, st = scale_case(np, torch, fmt, lists)
        rec = time_decode(torch, timer, fmt, ops, st, reps=10, plain_reps=2)
        records[kname]["scale"] = rec
        max_err[kname] = max(max_err[kname], rec["max_abs_err"])
        emit("parity_decode_scale", kernel=kname, **rec)
        del ops
    del lists
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 4: the main paths at full width
# ---------------------------------------------------------------------------
def _results_equal(np, a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def _index_state(index, *, checksums: bool = True) -> dict:
    """The index as host numpy leaves: the arguments of
    ``repro_torch.convert.index_from_numpy``, sent to the worker processes;
    ``checksums=False`` leaves the checksum columns out."""
    def stream(a):
        return {**a.leaves_numpy(), "n": a.n, "format": a.format,
                "payload_bytes": a.payload_bytes,
                "checksums": a.checksums if checksums else None}

    return {"terms": {t: {"df": tp.df, "first_doc": tp.first_doc,
                          "last_doc": tp.last_doc,
                          "max_impact": tp.max_impact,
                          "arr": stream(tp.arr),
                          "impacts": stream(tp.impacts)}
                      for t, tp in index.terms.items()},
            "n_docs": index.n_docs, "block_size": index.block_size,
            "format": index.format, "impact_bits": index.impact_bits,
            "has_tf": index.has_tf}


def _replay(state: dict, queries: list) -> dict:
    """A replay worker (a spawned process): place the index on the card
    from its numpy leaves and answer ``queries`` through the plain torch
    plan. Returns the index's bits/int and ``(result, QueryStats as a
    dict, seconds)`` per query."""
    sys.path.insert(0, str(SRC))
    from repro_torch.convert import index_from_numpy
    from repro_torch.index import QueryStats
    from repro_torch.launch.serve import SearchEngine

    index = index_from_numpy(**state)
    engine = SearchEngine(index, top_k=10, plan="torch", probe_width=512,
                          device=index.device)
    out = []
    for mode, terms in queries:
        st = QueryStats()
        t0 = time.perf_counter()
        res = engine.search(terms, mode, stats=st)
        out.append((res, dataclasses.asdict(st), time.perf_counter() - t0))
    return {"bits_per_int": index.bits_per_int, "answers": out}


def _launch_counters():
    from repro_torch.kernels import segment_sum
    from repro_torch.kernels.vbyte_decode import (binpack_kernel, epilogues,
                                                  kernel, stream_kernel)

    return {"vbyte_decode_blocked": kernel.launches,
            "stream_decode_blocked": stream_kernel.launches,
            "binpack_decode_blocked": binpack_kernel.launches,
            "fused_decode": epilogues.launches,
            "owner_sum": segment_sum.launches}


def _reset(torch, counters):
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for cnt in counters.values():
        cnt.reset()


def _read(torch, counters) -> dict:
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    launches["fused_decode_by"] = dict(counters["fused_decode"].by)
    return launches


def _build_terms(lists: dict, tfs: dict, n_docs: int) -> dict:
    """A build worker (a spawned process): ``build_index(format="auto")``
    of a few terms on the host, returned as numpy leaves."""
    sys.path.insert(0, str(SRC))
    from repro_torch.index import build_index

    return _index_state(build_index(lists, tfs=tfs, n_docs=n_docs,
                                    format="auto", checksum=True,
                                    device="cpu"))


def _build(name: str, lists: dict, tfs: dict, pool):
    """The path's index on the card, with the checksum columns the
    hardened phase checks. ``format="auto"`` spends seconds of host DP per
    long list, and a term's partition depends only on its own list and
    ``n_docs``: each term is built by its own ``build_index`` call in
    ``pool`` (longest lists first) and the terms are merged."""
    from repro_torch.convert import index_from_numpy
    from repro_torch.data.synthetic import CLUEWEB_DOCS
    from repro_torch.index import build_index

    if name != "auto":
        return build_index(lists, tfs=tfs, n_docs=CLUEWEB_DOCS, format=name,
                           checksum=True)
    jobs = {t: pool.submit(_build_terms, {t: lists[t]}, {t: tfs[t]},
                           CLUEWEB_DOCS)
            for t in sorted(lists, key=lambda t: -lists[t].size)}
    states = {t: jobs[t].result() for t in lists}
    state = next(iter(states.values()))
    return index_from_numpy(**{**state, "terms": {
        t: st["terms"][t] for t, st in states.items()}}, device="cuda")


def run_path(np, torch, name: str, lists: dict, tfs: dict, qs: list, *,
             groups: dict, profile_queries: int, pool,
             workers: int) -> dict:
    """Build one index onto the card, serve ``qs`` through the kernels with
    the launch counts read around the workload, replay every query through
    the plain torch plan in ``pool``'s worker processes, and profile a few
    queries."""
    from repro_torch.launch.serve import SearchEngine

    t_path = time.perf_counter()
    t0 = time.perf_counter()
    index = _build(name, lists, tfs, pool)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    idx_stats = index.stats()
    emit("index", path=name, n_terms=index.n_terms,
         n_postings=index.n_postings, n_blocks=idx_stats["n_blocks"],
         bits_per_int=idx_stats["bits_per_int"],
         codec_mix=dict(Counter(tp.arr.format
                                for tp in index.terms.values())),
         resident_bytes=sum(tp.arr.resident_bytes + tp.impacts.resident_bytes
                            for tp in index.terms.values()),
         device=str(index.device), build_seconds=round(t_build, 3),
         groups={f"K{k}": v for k, v in groups.items()})

    engine = SearchEngine(index, top_k=10, plan="auto", probe_width=512)
    t0 = time.perf_counter()
    engine.warmup(qs[:5])
    t_warm = time.perf_counter() - t0
    counters = _launch_counters()
    _reset(torch, counters)
    record = []
    stats = engine.run_workload(qs, record=record)
    launches = _read(torch, counters)
    peak = torch.cuda.max_memory_allocated()
    emit("main_path", path=name, queries=len(qs), qps=stats["qps"],
         p50_ms=stats["p50_ms"], p99_ms=stats["p99_ms"],
         mean_ms=stats["mean_ms"], n_results=stats["n_results"],
         block_skip_rate=stats["block_skip_rate"],
         pruned_block_rate=stats["pruned_block_rate"],
         pruned_impact_rate=stats["pruned_impact_rate"],
         blocks_decoded=stats["blocks_decoded"],
         ints_decoded=stats["ints_decoded"],
         impact_ints_decoded=stats["impact_ints_decoded"],
         decode_calls=stats["decode_calls"],
         peak_device_bytes=peak, warmup_seconds=round(t_warm, 3),
         launches=launches,
         launches_per_query={k: round(v / len(qs), 2)
                             for k, v in launches.items()
                             if isinstance(v, int)})
    decode_kernel, core = PATH_KERNELS[name]
    core_launches = sum(v for k, v in launches["fused_decode_by"].items()
                        if k.startswith(core + "/"))
    if not launches[decode_kernel] or not core_launches:
        die(f"path {name} did not launch {decode_kernel} and kernel 2's "
            f"{core} core: {launches}")

    # every query again through the plain torch plan on the card, split
    # over the pool's worker processes (the replay is host-bound and as
    # long as the workload several times over), on the index without its
    # checksum columns: identical results, accounting and bits/int, so the
    # column is off the request path; AND/OR also against numpy set
    # operations
    t0 = time.perf_counter()
    parts = [list(range(i, len(qs), workers)) for i in range(workers)]
    state = _index_state(index, checksums=False)
    replayed = {}
    for part, rep in zip(parts, pool.map(
            _replay, [state] * workers, [[qs[i] for i in p] for p in parts])):
        if rep["bits_per_int"] != index.bits_per_int:
            die(f"{name}: bits/int {index.bits_per_int} with the checksum "
                f"columns, {rep['bits_per_int']} without")
        replayed.update(zip(part, rep["answers"]))
    del state
    oracle = 0
    by_mode = {}  # mode -> [n, kernel-plan seconds, torch-plan seconds]
    for i, ((mode, terms), (a, sa, secs)) in enumerate(zip(qs, record)):
        b, sb, secs_b = replayed[i]
        acc = by_mode.setdefault(mode, [0, 0.0, 0.0])
        acc[0] += 1
        acc[1] += secs
        acc[2] += secs_b
        if not _results_equal(np, a, b):
            die(f"{name}: kernel plan and torch plan disagree on {mode} "
                f"{terms}")
        if dataclasses.asdict(sa) != sb:
            die(f"{name}: QueryStats differ on {mode} {terms}")
        if mode in ("and", "or") and oracle < 10:
            op = np.intersect1d if mode == "and" else np.union1d
            want = lists[terms[0]]
            for t in terms[1:]:
                want = op(want, lists[t])
            if not np.array_equal(a, want.astype(np.uint32)):
                die(f"{name}: {mode} {terms} differs from the numpy oracle")
            oracle += 1
    emit("main_path_parity", path=name, queries=len(qs),
         oracle_checked=oracle, seconds=round(time.perf_counter() - t0, 3),
         replay_workers=workers, equal=True,
         mean_ms_by_mode={m: {"n": n, "kernels": round(ka / n * 1e3, 3),
                              "torch_plan": round(kb / n * 1e3, 3)}
                          for m, (n, ka, kb) in by_mode.items()})
    prof_qs = qs[:profile_queries]
    _profile(torch, name,
             lambda: [engine.search(terms, mode) for mode, terms in prof_qs],
             len(prof_qs))
    seconds = time.perf_counter() - t_path
    emit("path_done", path=name, seconds=round(seconds, 3))
    digests = [_digest(out) for out, _, _ in record]
    del engine, record, replayed
    gc.collect()
    torch.cuda.empty_cache()
    # the index stays on the card for phase hardened_search
    return {"launches": launches, "seconds": seconds, "index": index,
            "digests": digests}


def _digest(out) -> str:
    """A query answer's arrays (dtype, shape, bytes) as one SHA-256."""
    h = hashlib.sha256()
    for a in out if isinstance(out, tuple) else (out,):
        h.update(f"{a.dtype}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


def _profile(torch, name, work, units: int, unit: str = "queries"):
    """Device busy share and device time by kernel over ``work()`` (a few
    requests of the path's workload), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    if not units:
        return None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        work()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = []
    for e in prof.key_averages():
        # device-side rows only (kernels, copies, memsets): the host ops
        # that launched them carry the same time again
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us:
            rows.append((dev_us, e.key, e.count))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    share = round(busy / wall_us, 4) if busy else None
    emit("profile", path=name, **{unit: units},
         wall_ms=round(wall_us / 1e3, 3),
         device_busy_ms=round(busy / 1e3, 3),
         device_busy_share=share,
         top_device=[{"name": k[:80], "ms": round(us / 1e3, 3), "count": c}
                     for us, k, c in rows[:8]])
    return share


def phase_main_paths(np, torch, args) -> dict:
    """The three main paths over the same lists and query stream."""
    from repro_torch.data.synthetic import CLUEWEB_DOCS
    from repro_torch.launch.serve import search_lists, search_queries

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    groups = {**SEARCH_GROUPS, 20: args.k20_lists}
    lists, tfs = search_lists(rng, groups, universe=CLUEWEB_DOCS)
    # one query stream over the index's terms (the lists' keys); each path
    # serves its first queries
    qs = search_queries(rng, SimpleNamespace(terms=lists), max(
        args.queries, args.vbyte_queries, args.svb_queries))
    emit("data", seconds=round(time.perf_counter() - t0, 3),
         n_lists=len(lists), n_postings=int(sum(v.size
                                                for v in lists.values())))
    paths = {}
    workers = max(1, min(os.cpu_count() or 1, REPLAY_WORKERS))
    path_queries = {"vbyte": args.vbyte_queries, "auto": args.queries,
                    "streamvbyte": args.svb_queries}
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=mp.get_context("spawn")) as pool:
        for name, n_queries in path_queries.items():
            paths[name] = run_path(
                np, torch, name, lists, tfs, qs[:n_queries], groups=groups,
                profile_queries=args.profile_queries, pool=pool,
                workers=workers)
        hardened = phase_hardened(np, torch, paths, qs, groups, path_queries,
                                  pool)
    telemetry = phase_telemetry(np, torch, paths, qs, args)
    live_index = phase_live_index(np, torch, paths, lists, tfs, qs, groups,
                                  args)
    for name in path_queries:  # free the indexes
        del paths[name]["index"], paths[name]["digests"]
    paths["hardened_search"] = hardened
    paths["telemetry"] = telemetry
    paths["live_index"] = live_index
    gc.collect()
    torch.cuda.empty_cache()
    return paths


# ---------------------------------------------------------------------------
# phase hardened_search: the hardened engine over the search paths' indexes
# ---------------------------------------------------------------------------
def _group_terms(groups: dict) -> dict:
    """K -> the term ids of that length group (``search_lists`` numbers
    the lists group by group, in ``groups``' order)."""
    out, at = {}, 0
    for k, n in groups.items():
        out[k] = list(range(at, at + n))
        at += n
    return out


def _sub_index(index, terms, replaced=None):
    """The same index over ``terms`` only, the ``TermPostings`` in
    ``replaced`` (term -> postings) swapped in; no stream moves."""
    return dataclasses.replace(index, terms={
        **{t: index.terms[t] for t in terms}, **(replaced or {})})


def _detect(arr, plan, term):
    """The reference's detection stack: host validators, then the checked
    decode (kernel 2's checksum epilogue for ``plan="cuda"``). Returns the
    typed error, or ``None``."""
    from repro_torch.robustness import (DecodeError, decode_checked,
                                        validate_array)

    try:
        validate_array(arr, term=term)
        decode_checked(arr, plan=plan, term=term)
        return None
    except DecodeError as e:
        return e


def _err(e):
    return None if e is None else {"class": type(e).__name__,
                                   "block": e.block}


def _merge_launches(a: dict, b: dict) -> dict:
    out = {k: v + b[k] for k, v in a.items() if isinstance(v, int)}
    out["fused_decode_by"] = dict(Counter(a["fused_decode_by"])
                                  + Counter(b["fused_decode_by"]))
    return out


def _drill(state: dict, queries: list, victim: int) -> dict:
    """A drill worker (a spawned process): place the index on the card from
    its numpy leaves, checksum columns included, gate it with
    ``validate=True`` over ``HARDENED_SHARDS`` logical shards on a
    simulated clock, and run ``serve.shard_loss_drill`` over ``queries``
    and one OR query of the victim shard's first term. Raises on any
    violation; returns the drill's counts and seconds, the healthy
    answers' digests and the launches."""
    sys.path.insert(0, str(SRC))
    import torch

    from repro_torch.convert import index_from_numpy
    from repro_torch.launch.serve import (SearchEngine, SimClock,
                                          shard_loss_drill)

    index = index_from_numpy(**state, device="cuda")
    counters = _launch_counters()
    _reset(torch, counters)
    clock = SimClock()
    engine = SearchEngine(index, validate=True, n_shards=HARDENED_SHARDS,
                          clock=clock)
    if engine.quarantined or engine.bound_unsafe:
        raise AssertionError(f"clean index gated: {engine.quarantined} "
                             f"{engine.bound_unsafe}")
    lo, _ = engine.shards[victim]
    qs = list(queries) + [("or", [engine.term_order[lo]])]
    out = shard_loss_drill(engine, qs, clock, victim=victim)
    launches = _read(torch, counters)
    return {**{k: v for k, v in out.items() if k != "healthy"},
            "digests": [_digest(a) for a in out["healthy"]],
            "launches": launches}


def hardened_checks(np, torch, name: str, index, t_groups: dict) -> None:
    """The hardened engine on one path's index, in this process: the
    startup gate over every term (and the deep gate over the K=12 terms),
    detection of every stream corruption class on a K=16 term, the
    unsafe-bound fallback, and retries. Dies on any violation."""
    from repro_torch.index import QueryStats
    from repro_torch.kernels.vbyte_decode import epilogues
    from repro_torch.launch.serve import SearchEngine, SimClock
    from repro_torch.robustness import ChecksumError, faultgen

    k12, k16 = t_groups[12], t_groups[16]
    # startup gate: every term at full size, then deep over K=12
    before = dict(epilogues.launches.by)
    t0 = time.perf_counter()
    eng = SearchEngine(index, validate=True, n_shards=HARDENED_SHARDS,
                       clock=SimClock())
    gate_s = time.perf_counter() - t0
    gate_launches = {k: v - before.get(k, 0)
                     for k, v in epilogues.launches.by.items()
                     if v != before.get(k, 0)}
    if eng.quarantined or eng.bound_unsafe:
        die(f"hardened {name}: the clean index failed its gate: "
            f"{eng.quarantined} {eng.bound_unsafe}")
    t0 = time.perf_counter()
    deep = SearchEngine(_sub_index(index, k12), validate=True,
                        deep_validate=True)
    deep_s = time.perf_counter() - t0
    if deep.quarantined or deep.bound_unsafe:
        die(f"hardened {name}: the K=12 terms failed the deep gate: "
            f"{deep.quarantined} {deep.bound_unsafe}")
    emit("hardened_gate", path=name, n_terms=index.n_terms, seconds=gate_s,
         validators_s=eng.validate_seconds["validators"],
         checked_decode_s=eng.validate_seconds["checked_decode"],
         launches=gate_launches, deep_terms=len(k12), deep_seconds=deep_s,
         quarantined=0, bound_unsafe=0)

    # detection: each class on one K=16 term, seed 0; the card's checked
    # decode against the plain plan's on the card, then a fresh engine
    # over the K=12 and K=16 terms must quarantine exactly that term
    victim, other = k16[0], k16[1]
    tp = index.terms[victim]
    want = eng.search([other], "or")
    detection = {}
    for cls in sorted(faultgen.STREAM_CLASSES):
        c = faultgen.corrupt(tp.arr, cls, 0)
        if c is None:
            continue  # does not apply to this term's format
        card, plain = _detect(c.arr, "cuda", victim), _detect(
            c.arr, "torch", victim)
        if type(card) is not type(plain) or (
                card is not None and (card.block, str(card))
                != (plain.block, str(plain))):
            die(f"hardened {name}: {cls} ({c.detail}): the card says "
                f"{card!r}, the plain plan {plain!r}")
        bad = _sub_index(index, k12 + k16,
                         {victim: dataclasses.replace(tp, arr=c.arr)})
        gated = [SearchEngine(bad, validate=True, plan=plan)
                 for plan in ("auto", "torch")]
        if (list(gated[0].quarantined) != [victim]
                or gated[0].quarantined != gated[1].quarantined):
            die(f"hardened {name}: {cls} ({c.detail}) quarantined "
                f"{gated[0].quarantined} on the card, "
                f"{gated[1].quarantined} on the plain plan")
        st = QueryStats()
        got = gated[0].search([victim, other], "or", stats=st)
        if not st.degraded or not _results_equal(np, got, want):
            die(f"hardened {name}: {cls}: the query over the quarantined "
                "term is not the clean term's flagged answer")
        reason = gated[0].quarantined[victim]
        detection[cls] = {
            "format": c.arr.format, "block": c.block, "card": _err(card),
            "plain": _err(plain),
            "caught_by": ("checksum" if isinstance(card, ChecksumError)
                          else "validators" if card is not None
                          else "skip_table" if reason.startswith("skip table")
                          else reason)}
    emit("hardened_detection", path=name, term=victim, seed=0,
         classes=detection)

    # unsafe bound: max_impact understated on a K=12 term
    t12 = k12[0]
    bad = _sub_index(index, k12,
                     {t12: faultgen.corrupt_max_impact(index.terms[t12], 0)})
    be = SearchEngine(bad, validate=True, deep_validate=True)
    if be.bound_unsafe != {t12} or be.quarantined:
        die(f"hardened {name}: max_impact_under marked {be.bound_unsafe}, "
            f"quarantined {be.quarantined}")
    fallbacks = 0
    for terms in ([t12, k12[1]], [t12, k12[2], k12[3]]):
        st = QueryStats()
        got = be.search(terms, "topk_maxscore", stats=st)
        if (not _results_equal(np, got, eng.search(terms, "topk_maxscore"))
                or st.bound_fallbacks != 1 or st.degraded):
            die(f"hardened {name}: the TAAT fallback over {terms} is not "
                "the clean engine's answer")
        fallbacks += st.bound_fallbacks

    # retries: a transient fault is retried to the exact answer, a
    # persistent one gives an empty flagged answer after max_retries + 1
    def transient(attempt, terms, mode):
        if attempt == 0:
            raise ChecksumError("injected", format=tp.arr.format, block=0)

    def persistent(attempt, terms, mode):
        raise ChecksumError("persistent")

    q = [k16[2], k16[3]]
    st = QueryStats()
    got = SearchEngine(index, fault_hook=transient, max_retries=RETRIES
                       ).search(q, "topk_maxscore", stats=st)
    if (not _results_equal(np, got, eng.search(q, "topk_maxscore"))
            or (st.retries, st.errors, st.degraded) != (1, 1, False)):
        die(f"hardened {name}: the transient fault was not retried to the "
            f"exact answer: {st}")
    st2 = QueryStats()
    got = SearchEngine(index, fault_hook=persistent, max_retries=RETRIES
                       ).search(q, "or", stats=st2)
    if (got.size or not st2.degraded or st2.errors != RETRIES + 1
            or "retries-exhausted" not in st2.degraded_reasons):
        die(f"hardened {name}: the persistent fault gave {got.size} ids, "
            f"{st2}")
    emit("hardened_faults", path=name, bound_unsafe_term=t12,
         bound_fallbacks=fallbacks, transient={"retries": st.retries,
                                               "errors": st.errors},
         persistent={"errors": st2.errors, "degraded": st2.degraded})


def checksum_path_case(np, torch, timer, arr) -> dict:
    """Kernel 2's ``checksum`` epilogue on one whole posting list of the
    index, as the startup gate launches it: held bit for bit against its
    plain version, timed (L2 cold) beside its bound — the compressed
    bytes, count and base read, the grid and the column written — and
    beside the format's decode kernel on the same list (the price of a
    checked decode over a plain one)."""
    from repro_torch.kernels.vbyte_decode import epilogues
    from repro_torch.kernels.vbyte_decode.dispatch import CUDA_DECODERS

    fmt, B, nb = arr.format, arr.block_size, arr.n_blocks
    ops = arr.device_operands()
    kw = dict(format=fmt, epilogue="checksum", block_size=B,
              differential=arr.differential)
    out = epilogues.fused_decode(ops, {}, **kw)
    ref = epilogues.fused_decode_plain(ops, {}, **kw)
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    if err or not all(torch.equal(o, r) for o, r in zip(out, ref)):
        die(f"kernel 2 [{fmt}/checksum] differs from its plain version on "
            f"a whole list: max_abs_err={err}")
    bound, by = _bound(
        bytes_moved=arr.payload_bytes + 8 * nb + 4 * nb * B + 4 * nb,
        ops=(arr.payload_bytes if fmt == "vbyte" else arr.n) + 2 * arr.n)
    leaves = [ops[k] for k in epilogues.FORMAT_OPERANDS[fmt]]
    dec = CUDA_DECODERS[fmt]
    ms = timer.ms(lambda: epilogues.fused_decode(ops, {}, **kw), reps=20)
    decode_ms = timer.ms(lambda: dec(*leaves, ops["counts"], ops["bases"],
                                     block_size=B,
                                     differential=arr.differential), reps=20)
    plain_ms = timer.ms(lambda: epilogues.fused_decode_plain(ops, {}, **kw),
                        reps=5)
    return {"format": fmt, "n_blocks": nb, "stride": arr.stride,
            "n_ints": arr.n, "payload_bytes": arr.payload_bytes,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": by, "decode_kernel_ms": decode_ms,
            "checked_over_decode": ms / decode_ms}


def phase_hardened(np, torch, paths: dict, qs: list, groups: dict,
                   path_queries: dict, pool) -> dict:
    """Phase ``hardened_search`` over the three search paths' indexes (still
    on the card, checksum columns built with them). The shard-loss drills
    run in worker processes, one per path, while this process runs
    :func:`hardened_checks` on each index; the launch counts of both are
    summed. Then kernel 2's ``checksum`` epilogue is held and timed on the
    indexes' whole lists (``checksum_path``)."""
    t_phase = time.perf_counter()
    t_groups = _group_terms(groups)
    names = tuple(path_queries)
    drill_qs = {n: qs[:min(HARDENED_QUERIES, path_queries[n])]
                for n in names}
    jobs = {n: pool.submit(_drill, _index_state(paths[n]["index"]),
                           drill_qs[n], VICTIM_SHARD) for n in names}
    counters = _launch_counters()
    _reset(torch, counters)
    for n in names:
        hardened_checks(np, torch, n, paths[n]["index"], t_groups)
    launches = _read(torch, counters)
    for n in names:
        try:
            d = jobs[n].result()
        except Exception as e:  # the worker's violation, with its message
            die(f"hardened {n}: shard-loss drill failed: {e!r}")
        k = len(drill_qs[n])
        if d["digests"][:k] != paths[n]["digests"][:k]:
            die(f"hardened {n}: the drill's healthy answers differ from the "
                "main path's")
        launches = _merge_launches(launches, d.pop("launches"))
        d.pop("digests")
        emit("hardened_drill", path=n, **d, main_path_answers_equal=True)
    for n in names:
        core = paths[n]["index"].terms[t_groups[12][0]].arr.format
        if not launches["fused_decode_by"].get(f"{core}/checksum"):
            die(f"hardened {n}: kernel 2's {core} checksum epilogue was "
                f"never launched: {launches}")
    seconds = time.perf_counter() - t_phase

    timer = ColdTimer(torch)
    cases = {}
    for n in names:
        index = paths[n]["index"]
        for k in (12, 16, 20):
            if t_groups.get(k):
                arr = index.terms[t_groups[k][0]].arr
                cases[f"{arr.format}/K{k}"] = rec = checksum_path_case(
                    np, torch, timer, arr)
                emit("parity_checksum_path", case=f"{arr.format}/K{k}",
                     path=n, **rec)
    del timer
    emit("hardened_done", seconds=round(seconds, 3),
         launches_checksum={k: v for k, v in
                            launches["fused_decode_by"].items()
                            if k.endswith("/checksum")})
    return {"launches": launches, "seconds": seconds,
            "checksum_path": cases}


# ---------------------------------------------------------------------------
# phase telemetry: spans, counters and exporters over the search path
# ---------------------------------------------------------------------------
OBS_SEED = 7  # the reference's overhead measurement: seed, lists, queries
OBS_QUERIES = 48
OBS_PAIRS = 12  # interleaved null / capture passes
TELEMETRY_QUERIES = 25  # the vbyte path's first queries, captured
NULL_PATH_GATE_PCT = 3.0  # the reference's gates
CAPTURE_GATE_PCT = 15.0
PORT_KERNELS = ("vbyte_decode_blocked", "stream_decode_blocked",
                "binpack_decode_blocked", "fused_decode")


def obs_overhead(np, torch, detail: bool = False) -> dict:
    """The reference's telemetry overhead measurement
    (``benchmarks/serving.py::_obs_overhead``, full size) on the card: a
    K=8 group of 8 lists over 2^20 docs, 48 queries, best p50 of 12
    interleaved null / full-capture passes (``overhead_pct``), and the
    sites a captured query hits times the null site's cost over the null
    p50 (``null_path_overhead_pct``). Beside the gates: every pass's p50
    (``null_p50s_ms``, ``instrumented_p50s_ms``) and the garbage
    collector's passes and seconds during the null and the capture passes
    (``gc``), to tell the estimator's spread from a cost of the capture.
    ``detail`` (``tools/obs_overhead.py``) adds, under ``detail``, each
    query's best latency over the null and the capture passes beside the
    sites it hits, and three control schedules of 12 pairs on the same
    engine: null / null (``aa``), capture / null (``swapped``) and null /
    capture with the garbage collector off (``gc_off``)."""
    from repro_torch import obs
    from repro_torch.data.synthetic import posting_list_group, posting_tfs
    from repro_torch.index import build_index
    from repro_torch.launch.serve import SearchEngine, search_queries
    from repro_torch.obs.stats import percentile

    rng = np.random.default_rng(OBS_SEED)
    universe = 1 << 20
    lists = dict(enumerate(posting_list_group(rng, 8, 8, universe=universe)))
    tfs = {t: posting_tfs(rng, len(v)) for t, v in lists.items()}
    index = build_index(lists, tfs=tfs, n_docs=universe)
    engine = SearchEngine(index)
    qs = search_queries(rng, index, OBS_QUERIES)
    engine.warmup(qs)

    gc_runs = {"null": [0, 0, 0, 0.0], "capture": [0, 0, 0, 0.0]}
    gc_at = {}

    def on_gc(phase, info):  # collections and their seconds, per pass kind
        if phase == "start":
            gc_at["t0"] = time.perf_counter()
        elif "kind" in gc_at:
            acc = gc_runs[gc_at["kind"]]
            acc[info["generation"]] += 1
            acc[3] += time.perf_counter() - gc_at["t0"]

    lats = {"null": [], "capture": []}

    def pass_p50(kind=None):
        lat = []
        if kind:
            gc_at["kind"] = kind
        for mode, terms in qs:
            t0 = time.perf_counter()
            engine.search(terms, mode)
            lat.append(time.perf_counter() - t0)
        gc_at.pop("kind", None)
        if kind:
            lats[kind].append(lat)
        return percentile([s * 1e3 for s in lat], 50)

    tele = obs.Telemetry()
    pass_p50()
    with obs.install(tele):
        pass_p50()
    nulls, ons = [], []
    gc.callbacks.append(on_gc)
    try:
        for _ in range(OBS_PAIRS):
            nulls.append(pass_p50("null"))
            with obs.install(tele):
                ons.append(pass_p50("capture"))
    finally:
        gc.callbacks.remove(on_gc)
    null_p50, on_p50 = min(nulls), min(ons)
    cap = obs.Telemetry()

    def n_sites():
        return sum(1 for r in cap.tracer.spans if r["type"] == "span") + sum(
            m["count"] if m["type"] == "histogram" else m["value"]
            for m in cap.registry.snapshot()["metrics"].values())

    sites = []
    with obs.install(cap):
        for mode, terms in qs:
            before = n_sites()
            engine.search(terms, mode)
            sites.append(n_sites() - before)
    sites_per_query = sum(sites) / len(qs)
    n_micro = 200_000
    t0 = time.perf_counter()
    for _ in range(n_micro):
        with obs.trace("x", a=1):
            pass
    null_site_ms = (time.perf_counter() - t0) / n_micro * 1e3
    more = {}
    if detail:
        def pct(a, b):
            return round((min(b) - min(a)) / min(a) * 100, 2)

        def schedule(first, second, gc_off=False):
            a, b = [], []
            if gc_off:
                gc.disable()
            try:
                for _ in range(OBS_PAIRS):
                    for on, out in ((first, a), (second, b)):
                        with obs.install(tele) if on else \
                                contextlib.nullcontext():
                            out.append(pass_p50())
            finally:
                gc.enable()
            nul, cpt = (a, b) if not first else (b, a)
            return {"overhead_pct": pct(nul, cpt),
                    "first_p50s_ms": [round(x, 4) for x in a],
                    "second_p50s_ms": [round(x, 4) for x in b]}

        best = {k: np.min(np.asarray(v), 0) * 1e6 for k, v in lats.items()}
        more = {"detail": {
            "sites": sites,
            "null_best_us": [round(float(x), 1) for x in best["null"]],
            "capture_best_us": [round(float(x), 1)
                                for x in best["capture"]],
            "aa": schedule(False, False),
            "swapped": schedule(True, False),
            "gc_off": schedule(False, True, gc_off=True)}}
    return {"n_queries": len(qs), "pairs": OBS_PAIRS,
            "null_p50_ms": round(null_p50, 4),
            "instrumented_p50_ms": round(on_p50, 4),
            "overhead_pct": round((on_p50 - null_p50) / null_p50 * 100, 2),
            "sites_per_query": round(sites_per_query, 1),
            "null_site_us": round(null_site_ms * 1e3, 3),
            "null_path_overhead_pct": round(
                sites_per_query * null_site_ms / null_p50 * 100, 2),
            "null_p50s_ms": [round(x, 4) for x in nulls],
            "instrumented_p50s_ms": [round(x, 4) for x in ons],
            "gc": {k: {"collections": v[:3], "seconds": round(v[3], 6)}
                   for k, v in gc_runs.items()}, **more}


def _overhead_worker(detail: bool = False) -> dict:
    """:func:`obs_overhead` in a fresh (spawned) process, as the reference
    measures it in a benchmark process of its own: the smoke's own heap,
    millions of objects by this phase, makes every allocation's garbage
    collection dearer and would be charged to the spans."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    gc.collect()
    return {**obs_overhead(np, torch, detail),
            "gc_objects": len(gc.get_objects())}


def _counter_sum(metrics: dict, name: str) -> int:
    return sum(v["value"] for k, v in metrics.items()
               if k == name or k.startswith(name + "{"))


def phase_telemetry(np, torch, paths: dict, qs: list, args) -> dict:
    """Phase ``telemetry``: the reference's overhead gates on the card, then
    one full capture (``torch_annotations=True``, ``torch.profiler`` on)
    over the ``vbyte`` path's first queries: its three exports, the
    per-stage table and the report CLI's; answers bit for bit against the
    main path's (no telemetry), one ``decode_calls_total`` per
    ``dispatch.decode`` call and at least one kernel launch each, every
    kernel of the port in the profiler's trace under a ``decode`` range
    whose span names its format and epilogue, and ``serve_*_total``
    mirroring ``serve_stats``."""
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch import obs
    from repro_torch.kernels.vbyte_decode import dispatch
    from repro_torch.launch.serve import (SearchEngine, stage_latency_summary,
                                          write_metrics_out)
    from repro_torch.obs.attribution import attribute_kernels

    t_phase = time.perf_counter()
    with ProcessPoolExecutor(max_workers=1,
                             mp_context=mp.get_context("spawn")) as pool:
        gates = pool.submit(_overhead_worker).result()
    emit("telemetry_overhead", **gates, process="spawned",
         smoke_gc_objects=len(gc.get_objects()),
         gates={"null_path_overhead_pct": NULL_PATH_GATE_PCT,
                "overhead_pct": CAPTURE_GATE_PCT})
    if not (gates["null_path_overhead_pct"] < NULL_PATH_GATE_PCT
            and gates["overhead_pct"] < CAPTURE_GATE_PCT):
        die(f"telemetry overhead over its gates: {gates}")

    n = min(TELEMETRY_QUERIES, len(paths["vbyte"]["digests"]))
    cap_qs = qs[:n]
    engine = SearchEngine(paths["vbyte"]["index"], top_k=10, plan="auto",
                          probe_width=512)
    serve_before = dict(engine.serve_stats)
    calls = [0]
    real_decode = dispatch.decode

    def counted(*a, **kw):
        calls[0] += 1
        return real_decode(*a, **kw)

    tele = obs.Telemetry(torch_annotations=True)
    counters = _launch_counters()
    outs = []
    _reset(torch, counters)
    dispatch.decode = counted
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with obs.install(tele):
                t0 = time.perf_counter()
                for mode, terms in cap_qs:
                    outs.append(engine.search(terms, mode))
                capture_s = time.perf_counter() - t0
            torch.cuda.synchronize()
    finally:
        dispatch.decode = real_decode
    launches = _read(torch, counters)

    tmp = tempfile.mkdtemp(prefix="telemetry_")
    try:
        t0 = time.perf_counter()
        out_dir = args.metrics_out or os.path.join(tmp, "capture")
        exports = write_metrics_out(tele, out_dir)
        prof_path = os.path.join(tmp, "profiler.json")
        prof.export_chrome_trace(prof_path)
        with open(prof_path) as f:
            events = json.load(f)["traceEvents"]
        export_s = time.perf_counter() - t0
        attr = attribute_kernels(events, tele.tracer.spans)
        del events, prof
        report = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.report",
             exports["jsonl"], "--top", "5"],
            env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True,
            text=True, timeout=300)
        sizes = {k: os.path.getsize(p) for k, p in exports.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if report.returncode:
        die(f"telemetry: report CLI failed: {report.stderr[-2000:]}")

    if [_digest(o) for o in outs] != paths["vbyte"]["digests"][:n]:
        die("telemetry: answers under the capture differ from the main "
            "path's")
    metrics = tele.registry.snapshot()["metrics"]
    decode_calls = _counter_sum(metrics, "decode_calls_total")
    decode_spans = len(tele.tracer.durations("decode"))
    kernel_launches = sum(launches[k] for k in PORT_KERNELS)
    if not (decode_calls == decode_spans == calls[0]):
        die(f"telemetry: decode_calls_total {decode_calls}, decode spans "
            f"{decode_spans}, dispatch.decode calls {calls[0]}")
    if kernel_launches < decode_calls:
        die(f"telemetry: {kernel_launches} kernel launches for "
            f"{decode_calls} decode calls")
    if not (attr["kernels"] == attr["attributed"] == kernel_launches
            and attr["ranges"] == attr["spans"] == decode_spans):
        die(f"telemetry: kernels not under a matching decode range "
            f"({kernel_launches} launched): {attr}")
    serve = {k: _counter_sum(metrics, f"serve_{k}_total")
             for k in engine.serve_stats}
    if serve != {k: v - serve_before[k]
                 for k, v in engine.serve_stats.items()} or \
            _counter_sum(metrics, "serve_requests_total") != n:
        die(f"telemetry: serve counters {serve} != serve_stats "
            f"{engine.serve_stats}")
    if not launches["vbyte_decode_blocked"] or not launches["fused_decode"]:
        die(f"telemetry: the path did not launch kernels 1 and 2: "
            f"{launches}")
    stages = stage_latency_summary(tele.tracer)
    emit("telemetry_capture", queries=n, capture_seconds=round(capture_s, 3),
         export_seconds=round(export_s, 3), export_bytes=sizes,
         n_traces=len(tele.tracer.trees()), decode_calls=decode_calls,
         kernel_launches=kernel_launches, launches=launches,
         attribution={k: v for k, v in attr.items() if k != "examples"},
         serve_counters=serve, answers_equal=True)
    emit("telemetry_stages", stages=stages)
    print(report.stdout.rstrip("\n"), flush=True)
    seconds = time.perf_counter() - t_phase
    emit("telemetry_done", seconds=round(seconds, 3))
    return {"launches": launches, "seconds": seconds, "overhead": gates,
            "stages": stages}


# ---------------------------------------------------------------------------
# phase live_index: crash-safe ingestion over the auto path's index
# ---------------------------------------------------------------------------
LIVE_QUERIES = 25  # the auto path's first queries, as and / or / topk
SWEEP_GROUPS = (12, 16)  # the crash-point sweep's terms
RACING_OPS = 50  # acknowledged writes racing the crashed merge


class _Tally:
    """Launch counts of the path's own runs, summed; comparisons against
    the plain plan and the oracle run between them, or under
    :meth:`aside` inside a tallied run (a merge's step hook), uncounted."""

    def __init__(self, torch):
        self.torch = torch
        self.counters = _launch_counters()
        self.total = self.last = None

    def run(self, fn):
        _reset(self.torch, self.counters)
        try:
            out = fn()
        finally:  # a crashed merge's launches count too
            got = self.last = _read(self.torch, self.counters)
            self.total = got if self.total is None else _merge_launches(
                self.total, got)
        return out, got

    @contextlib.contextmanager
    def aside(self):
        """Launches made inside the block are taken back out of the
        counts when it ends."""
        saved = {k: (c.count, dict(c.by)) for k, c in self.counters.items()}
        try:
            yield
        finally:
            for k, c in self.counters.items():
                c.count = saved[k][0]
                c.by.clear()
                c.by.update(saved[k][1])


def _int_launches(launches: dict) -> dict:
    return {k: v for k, v in launches.items() if isinstance(v, int)}


def _live_ops(np, rng, n_ops: int, universe: int, terms, main_docs,
              p_del: float = 0.2) -> list:
    """``benchmarks/ingestion.py::_make_ops``'s stream over a live index
    that already holds ``main_docs``: adds of docs not present, each with
    1–4 of ``terms`` at tf 1–4, and with probability ``p_del`` a delete of
    a uniformly drawn present doc (main segment or delta)."""
    exists = np.zeros(universe, bool)
    exists[main_docs] = True
    pool = np.empty(main_docs.size + n_ops, np.int64)
    pool[:main_docs.size] = main_docs
    n = main_docs.size
    terms = np.asarray(terms)
    ops = []
    while len(ops) < n_ops:
        if n and rng.random() < p_del:
            i = int(rng.integers(n))
            doc = int(pool[i])
            pool[i] = pool[n - 1]
            n -= 1
            exists[doc] = False
            ops.append(("del", doc, None))
        else:
            doc = int(rng.integers(universe))
            if exists[doc]:
                continue
            ops.append(("add", doc, {
                int(t): int(rng.integers(1, 5))
                for t in rng.choice(terms, rng.integers(1, 5),
                                    replace=False)}))
            exists[doc] = True
            pool[n] = doc
            n += 1
    return ops


def _write_main(directory: str, index, tfs: dict, all_docs) -> None:
    """Epoch 1 of a live index over ``index``: committed with
    ``ingest.write_epoch``, the commit ``LiveIndex.merge`` makes."""
    from repro_torch.index import ingest

    os.makedirs(directory)
    ingest.write_epoch(directory, index, {t: tfs[t] for t in index.terms},
                       all_docs, epoch=1)


def _oracle(np, live, queries, k: int = 10) -> list:
    """Every answer recomputed from ``live.materialize()`` (the logical
    state's lists and tfs) with ``impact_value`` / ``quantize_impacts``;
    the main lists are decoded by the plain plan, so the oracle does not
    lean on the kernels under test."""
    from repro_torch.index import impact_value, quantize_impacts

    prev, live.plan = live.plan, "torch"
    try:
        lists, tfs = live.materialize()
    finally:
        live.plan = prev
    empty = np.zeros(0, np.int64)
    out = []
    for mode, terms in queries:
        terms = list(dict.fromkeys(terms))
        docs = [lists.get(t, empty) for t in terms]
        if mode == "and":
            res = docs[0]
            for d in docs[1:]:
                res = np.intersect1d(res, d, assume_unique=True)
            out.append(res.astype(np.uint32))
        elif mode == "or":
            out.append(np.unique(np.concatenate(docs)).astype(np.uint32))
        else:
            cand = np.unique(np.concatenate(docs))
            scores = np.zeros(cand.size, np.int64)
            for t, d in zip(terms, docs):
                if d.size:
                    base = impact_value(live.n_docs, int(d.size),
                                        live.impact_bits)
                    scores[np.searchsorted(cand, d)] += quantize_impacts(
                        base, tfs[t], live.impact_bits)
            order = np.lexsort((cand, -scores))[:k]
            out.append((cand[order].astype(np.uint32),
                        scores[order].astype(np.int32)))
    return out


def _answers(engine, queries, plan=None) -> list:
    live = engine.live
    prev = live.plan
    live.plan = prev if plan is None else plan
    try:
        return [engine.search(terms, mode) for mode, terms in queries]
    finally:
        live.plan = prev


def _live_hold(np, got, want, what: str) -> None:
    """Every answer of ``got`` equals ``want``'s, dtype and all; raises
    ``AssertionError`` (the phase, or the worker's caller, reports it)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} answers, {len(want)} "
                             "expected")
    for i, (a, b) in enumerate(zip(got, want)):
        if not _results_equal(np, a, b):
            raise AssertionError(f"{what}: answer {i} differs")


def _live_hold_all(np, engine, queries, want, what: str) -> None:
    """The card's answers, the plain plan's on the card and the
    materialize() oracle's all equal ``want``."""
    _live_hold(np, _answers(engine, queries), want, f"{what} (card)")
    _live_hold(np, _answers(engine, queries, "torch"), want,
               f"{what} (plan='torch')")
    _live_hold(np, _oracle(np, engine.live, queries), want,
               f"{what} (oracle)")


def _replay_probe(flags: list, term: int):
    """A replay hook issuing one query during the replay of the first op."""
    from repro_torch.index import QueryStats

    def probe(ix, i, op):
        if i == 0:
            st = QueryStats()
            ix.search([term], mode="or", stats=st)
            flags.append((ix.state, st.degraded, list(st.degraded_reasons)))

    return probe


def _phase_hist(tele, name: str) -> dict:
    out = {}
    for k, m in tele.registry.snapshot()["metrics"].items():
        if k.startswith(name + "{"):
            out[k[len(name) + 1:-1]] = round(m["sum"], 6)
    return out


def _pct_us(np, xs) -> dict:
    return {"p50_us": round(float(np.percentile(xs, 50)) * 1e6, 1),
            "p99_us": round(float(np.percentile(xs, 99)) * 1e6, 1)}


def _apply_ops(engine, ops) -> list:
    """Apply ops through the engine; each op's ack latency (seconds)."""
    lat = []
    for kind, doc, terms in ops:
        t0 = time.perf_counter()
        if kind == "add":
            engine.add(doc, terms)
        else:
            engine.delete(doc)
        lat.append(time.perf_counter() - t0)
    return lat


def _live_plain_worker(directory: str, queries: list) -> dict:
    """A spawned worker: open a copy of the live index on the card with
    ``plan="torch"`` (the plain decoders) and answer ``queries`` through
    it, then from its ``materialize()`` (the oracle)."""
    sys.path.insert(0, str(SRC))
    import numpy as np

    from repro_torch.index import LiveIndex
    from repro_torch.launch.serve import LiveSearchEngine

    live = LiveIndex(directory, fsync=True, plan="torch")
    engine = LiveSearchEngine(live, top_k=10)
    t0 = time.perf_counter()
    plain = _answers(engine, queries)
    t1 = time.perf_counter()
    oracle = _oracle(np, live, queries)
    t2 = time.perf_counter()
    live.close()
    return {"torch": plain, "oracle": oracle,
            "seconds": {"torch_plan": round(t1 - t0, 3),
                        "oracle": round(t2 - t1, 3)}}


def _live_sweep_worker(directory: str, ops: list, racing_ops: list,
                       queries: list, crash_at: str, probe_term: int) -> dict:
    """A spawned worker, the crash-point sweep on the card: ``ops``, then a
    merge crashed at ``crash_at`` with ``racing_ops`` acknowledged while
    it runs, recovery (a query during replay flagged ``replaying``), and
    the retried merge checked at every crash point and after commit — each
    time the card, ``plan="torch"`` and the materialize() oracle alike.
    Returns the records to emit and the worker's launch counts."""
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    from repro_torch.index import CRASH_POINTS, CrashPoint, LiveIndex
    from repro_torch.launch.serve import LiveSearchEngine

    tally = _Tally(torch)
    live = LiveIndex(directory, fsync=True)
    engine = LiveSearchEngine(live, top_k=10)
    _apply_ops(engine, ops)
    pre, _ = tally.run(lambda: _answers(engine, queries))
    _live_hold_all(np, engine, queries, pre, "before the crash")
    racing = {}

    def race(name):
        # acknowledged writes racing the merge (the rotated WAL and the
        # active delta), so a crash at any point leaves ops to replay
        if racing or name not in ("after_rotate", crash_at):
            return
        with tally.aside():  # the merge's launches alone are counted
            _apply_ops(engine, racing_ops)
            racing["at"] = name
            racing["want"] = _answers(engine, queries)
            _live_hold_all(np, engine, queries, racing["want"],
                           f"writes racing the merge at {name}")

    try:
        tally.run(lambda: live.merge(crash_at=crash_at, step_hook=race))
        raise AssertionError(f"the crash at {crash_at!r} did not fire")
    except CrashPoint:
        pass
    crashed_launches = tally.last
    want = racing["want"]
    live.close()
    flags = []
    t0 = time.perf_counter()
    live = LiveIndex(directory, fsync=True,
                     replay_hook=_replay_probe(flags, probe_term))
    t_recover = time.perf_counter() - t0
    engine = LiveSearchEngine(live, top_k=10)
    if flags != [("replaying", True, ["replaying"])]:
        raise AssertionError(f"the replay-time query was not flagged: "
                             f"{flags}")
    got, _ = tally.run(lambda: _answers(engine, queries))
    _live_hold(np, got, want, f"after recovery from {crash_at}")
    _live_hold_all(np, engine, queries, want,
                   f"after recovery from {crash_at}")
    recovery = {"kind": "crash", "scope": "K12+K16", "crash_point": crash_at,
                "seconds": round(t_recover, 3),
                "steps": {k: round(v, 3)
                          for k, v in live.recovery_seconds.items()},
                "replayed_ops": live.counters["replayed_ops"],
                "rolled_forward": live.counters["rolled_forward"],
                "wal_bytes_truncated": live.counters["wal_bytes_truncated"],
                "replay_query_flagged": "replaying", "answers_equal": True}
    checked = []

    def at_point(name):
        with tally.aside():
            _live_hold_all(np, engine, queries, want, f"mid-merge at {name}")
        checked.append(name)

    t0 = time.perf_counter()
    info, retried_launches = tally.run(
        lambda: live.merge(step_hook=at_point))
    t_retry = time.perf_counter() - t0
    if checked != list(CRASH_POINTS):
        raise AssertionError(f"the step hook ran at {checked}")
    _live_hold_all(np, engine, queries, want,
                   "after the retried merge's commit")
    live.close()
    sweep = {"scope": "K12+K16", "ops": len(ops),
             "racing_ops": len(racing_ops), "racing_at": racing["at"],
             "queries": len(queries), "crash_point": crash_at,
             "checked_points": checked,
             "retried_merge_seconds": round(t_retry, 3), **info,
             "merge_launches": {
                 "crashed": _int_launches(crashed_launches),
                 "retried": _int_launches(retried_launches)},
             "answers_equal": True}
    return {"recovery": recovery, "sweep": sweep, "launches": tally.total}


def phase_live_index(np, torch, paths: dict, lists: dict, tfs: dict,
                     qs: list, groups: dict, args) -> dict:
    """Phase ``live_index``: a ``LiveIndex`` on local disk (``fsync=True``)
    on the card, its main segment the ``auto`` path's index (committed as
    epoch 1 with ``ingest.write_epoch``, the commit ``merge`` makes), then
    ``--live-ops`` acknowledged ops through ``LiveSearchEngine``, a
    restart replaying the whole WAL (a query during replay flagged
    ``replaying``), the ``auto`` path's first queries as and / or / topk
    (every answer equal to ``plan="torch"`` on the card and to the
    materialize() oracle, both computed in a spawned worker on a copy of
    the directory while this process serves), and one full-size merge,
    after which the answers are unchanged. The crash-point sweep — a merge
    crashed at a seeded point with writes racing it, recovery, then the
    retried merge checked at all 8 points and after commit — runs over the
    K=12 ∪ K=16 terms in another spawned worker, at the same time."""
    import shutil
    import tempfile

    from repro_torch import obs
    from repro_torch.index import CRASH_POINTS, LiveIndex
    from repro_torch.launch.serve import LiveSearchEngine

    t_phase = time.perf_counter()
    index = paths["auto"]["index"]
    t_groups = _group_terms(groups)
    probe_term = t_groups[12][0]
    rng = np.random.default_rng(args.seed)
    lq = [({"and": "and", "or": "or"}.get(m, "topk"), t)
          for m, t in qs[:LIVE_QUERIES]]
    tally = _Tally(torch)
    tele = obs.Telemetry()
    workdir = tempfile.mkdtemp(prefix="live_index_")
    obs.install(tele)
    try:
        with ProcessPoolExecutor(max_workers=2,
                                 mp_context=mp.get_context("spawn")) as pool:
            # the sweep's live index over the K=12 ∪ K=16 terms, started
            # first: it runs beside the full-size work below
            sweep = sorted(t for k in SWEEP_GROUPS
                           for t in t_groups.get(k, []))
            sub = dataclasses.replace(index, terms={t: index.terms[t]
                                                    for t in sweep})
            sub_docs = np.unique(np.concatenate([lists[t] for t in sweep]))
            d_sw = os.path.join(workdir, "sweep")
            _write_main(d_sw, sub, tfs, sub_docs)
            n_sweep = max(1, args.live_ops // 10)
            sweep_ops = _live_ops(np, rng, n_sweep + RACING_OPS,
                                  index.n_docs, sweep, sub_docs)
            in_sweep = set(sweep)
            sq = [(m, [t for t in terms if t in in_sweep])
                  for m, terms in lq]
            sq = [(m, terms) for m, terms in sq if terms]
            crash_at = str(np.random.default_rng(args.seed).choice(
                CRASH_POINTS))
            sweep_job = pool.submit(_live_sweep_worker, d_sw,
                                    sweep_ops[:n_sweep], sweep_ops[n_sweep:],
                                    sq, crash_at, probe_term)

            # 1. the main segment: the auto path's index at epoch 1
            t0 = time.perf_counter()
            all_docs = np.unique(np.concatenate(
                [lists[t] for t in index.terms])).astype(np.int64)
            d_full = os.path.join(workdir, "full")
            _write_main(d_full, index, tfs, all_docs)
            t_write = time.perf_counter() - t0
            t0 = time.perf_counter()
            live = LiveIndex(d_full, fsync=True)
            t_open = time.perf_counter() - t0
            engine = LiveSearchEngine(live, top_k=10)
            emit("live_segment", terms=index.n_terms,
                 postings=index.n_postings, docs=int(all_docs.size),
                 universe=live.n_docs, device=str(live.device),
                 segment_bytes=os.path.getsize(os.path.join(
                     d_full, "segments", "seg_00000001", "postings.npz")),
                 write_seconds=round(t_write, 3),
                 open_seconds=round(t_open, 3),
                 open_steps={k: round(v, 3)
                             for k, v in live.recovery_seconds.items()},
                 written_by="ingest.write_epoch, merge's commit")

            # 2. acknowledged ops (WAL appended and fsynced before each ack)
            ops = _live_ops(np, rng, args.live_ops, live.n_docs,
                            sorted(index.terms), all_docs)
            t0 = time.perf_counter()
            ack = _apply_ops(engine, ops)
            t_ops = time.perf_counter() - t0
            hist = tele.registry.histogram("wal_append_seconds", fsync=True)
            acked = (live.doc_count(), live.n_delta_docs, live.n_pending)
            emit("live_ingest", ops=len(ops),
                 adds=sum(k == "add" for k, _, _ in ops),
                 deletes=sum(k == "del" for k, _, _ in ops),
                 seconds=round(t_ops, 3),
                 acked_ops_per_s=round(len(ops) / t_ops, 1),
                 ack_latency=_pct_us(np, ack),
                 wal_append_seconds={
                     "count": hist.count,
                     "p50_bucket_us": hist.quantile(0.5) * 1e6,
                     "p99_bucket_us": hist.quantile(0.99) * 1e6,
                     "mean_us": round(hist.mean * 1e6, 1)},
                 fsync=True, n_delta_docs=live.n_delta_docs,
                 tombstones=live.n_pending - live.n_delta_docs,
                 doc_count=live.doc_count())

            # 3. restart: load, CRC-check, upload, replay every acked op
            live.close()
            flags = []
            t0 = time.perf_counter()
            live = LiveIndex(d_full, fsync=True,
                             replay_hook=_replay_probe(flags, probe_term))
            t_reopen = time.perf_counter() - t0
            engine = LiveSearchEngine(live, top_k=10)
            if flags != [("replaying", True, ["replaying"])]:
                raise AssertionError(f"the replay-time query was not "
                                     f"flagged: {flags}")
            if (live.doc_count(), live.n_delta_docs, live.n_pending) \
                    != acked:
                raise AssertionError("the restart did not replay every "
                                     "acked op")
            emit("live_recovery", kind="restart", scope="full",
                 seconds=round(t_reopen, 3),
                 steps={k: round(v, 3)
                        for k, v in live.recovery_seconds.items()},
                 replayed_ops=live.counters["replayed_ops"],
                 replay_query_flagged="replaying", state_equal=True)

            # 4. queries on the card; plan="torch" and the oracle in a
            #    worker, on a copy of the directory
            d_plain = os.path.join(workdir, "plain")
            shutil.copytree(d_full, d_plain)
            plain_job = pool.submit(_live_plain_worker, d_plain, lq)
            rec = []
            wl, q_launches = tally.run(
                lambda: engine.run_workload(lq, record=rec))
            card = [o for o, _, _ in rec]
            if not q_launches["binpack_decode_blocked"]:
                raise AssertionError(f"the queries launched no kernel 4: "
                                     f"{q_launches}")

            # 5. the full-size merge; the logical state and answers stay
            t0 = time.perf_counter()
            info, m_launches = tally.run(live.merge)
            t_merge = time.perf_counter() - t0
            phases = _phase_hist(tele, "ingest_merge_phase_seconds")
            after, _ = tally.run(lambda: _answers(engine, lq))
            _live_hold(np, after, card, "after the full merge")
            live.close()

            plain = plain_job.result()
            _live_hold(np, plain["torch"], card, "plan='torch'")
            _live_hold(np, plain["oracle"], card, "materialize() oracle")
            emit("live_queries", queries=len(lq),
                 modes=dict(Counter(m for m, _ in lq)),
                 **{k: wl[k] for k in ("qps", "p50_ms", "p99_ms", "mean_ms",
                                       "n_results", "blocks_decoded",
                                       "ints_decoded", "delta_postings",
                                       "delta_hits", "tombstones_applied",
                                       "degraded_responses")},
                 launches=q_launches,
                 launches_per_query={k: round(v / len(lq), 2)
                                     for k, v in q_launches.items()
                                     if isinstance(v, int)},
                 oracle_equal=True, torch_plan_equal=True,
                 worker_seconds=plain["seconds"])
            emit("live_merge", scope="full", seconds=round(t_merge, 3),
                 phase_seconds=phases, launches=m_launches, **info,
                 answers_equal=True)

            # 6. the crash-point sweep's results
            sw = sweep_job.result()
            emit("live_recovery", **sw["recovery"])
            emit("live_sweep", terms=len(sweep), postings=sub.n_postings,
                 **sw["sweep"], launches=sw["launches"])
    except AssertionError as e:
        die(f"live_index: {e}")
    finally:
        obs.uninstall()
        shutil.rmtree(workdir, ignore_errors=True)
    launches = _merge_launches(tally.total, sw["launches"])
    if not launches["binpack_decode_blocked"]:
        die(f"live_index: kernel 4 was never launched: {launches}")
    seconds = time.perf_counter() - t_phase
    emit("live_index_done", seconds=round(seconds, 3), launches=launches)
    return {"launches": launches, "seconds": seconds}


def _topk_agree(torch, got_s, got_i, want_s, want_i, what: str) -> int:
    """Top-k lists agree: scores rank by rank within one bf16 ulp, and every
    id of ``want`` whose score is not within one ulp of its k-th score is in
    ``got`` (ids may trade places only among near-ties). Returns the
    number of near-tie ids that differ."""
    if _bf16_ulps(torch, got_s, want_s) > 1:
        die(f"{what}: top-k scores differ by more than one bf16 ulp")
    near = (want_s - want_s[:, -1:]).abs() <= want_s.abs() * 2.0**-7
    swapped = 0
    for r in range(want_i.shape[0]):
        g = set(got_i[r].tolist())
        if not set(want_i[r][~near[r]].tolist()) <= g:
            die(f"{what}: row {r} top-k ids differ beyond the near-ties")
        swapped += len(set(want_i[r].tolist()) - g)
    return swapped


def run_two_tower(np, torch, args) -> dict:
    """Path ``two_tower``: the two-tower-retrieval config at full width
    (2^23 users and items, id_dim 128, towers 1024-512-256, seq_len 50)
    served by ``ServingEngine`` over a resident corpus of 2^20 sorted
    candidate ids (vbyte, differential, block 128 — the retrieval_cand
    shape), top-10, buckets 1/2/4/8; then the embedding-bag endpoint."""
    import copy

    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.core import CompressedIntArray
    from repro_torch.ft import StragglerDetector
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import recsys, registry

    t_path = time.perf_counter()
    cfg = registry.resolve_config("two-tower-retrieval", "retrieval_cand")
    rng = np.random.default_rng(args.seed)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = recsys.init_params(cfg, seed=args.seed, device="cuda")
    n_cand = RECSYS_SHAPES["retrieval_cand"].dims["n_candidates"]
    cands = np.sort(rng.choice(np.arange(1, cfg.n_items, dtype=np.int64),
                               n_cand, replace=False)).astype(np.uint64)
    corpus = CompressedIntArray.encode(cands, differential=True,
                                       device="cuda")
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine = ServingEngine(params, cfg, corpus, top_k=10, device="cuda")
    torch.cuda.synchronize()
    t_table = time.perf_counter() - t0
    # the plain engine shares the item table and parameters (one copy of
    # 13 GB on the card) and decodes + scores with the torch plan
    plain = copy.copy(engine)
    plain.plan, plain.detector = "torch", StragglerDetector()
    emit("two_tower_build", n_items=cfg.n_items, n_users=cfg.n_users,
         param_count=cfg.param_count(), corpus_n=corpus.n,
         corpus_blocks=corpus.n_blocks, corpus_stride=corpus.stride,
         bits_per_int=round(corpus.bits_per_int, 4),
         item_table=list(engine.item_table.shape),
         data_seconds=round(t_data, 3), item_table_seconds=round(t_table, 3),
         peak_device_bytes=torch.cuda.max_memory_allocated())
    t0 = time.perf_counter()
    engine.warmup()
    plain.warmup()
    t_warm = time.perf_counter() - t0

    reqs = [(int(rng.integers(1, cfg.n_users)),
             rng.integers(1, cfg.n_items, cfg.seq_len).astype(np.int32))
            for _ in range(args.tt_requests)]
    # the requests in four equal parts, drained at most 8, 4, 2 and 1 at a
    # time: every bucket shape, the 1-row query (scores [nb, B]) included
    parts = [(mb, reqs[i::4]) for i, mb in enumerate((8, 4, 2, 1))]
    bags = [np.sort(rng.choice(np.arange(1, cfg.n_items, dtype=np.int64),
                               int(n), replace=False))
            for n in rng.integers(0, cfg.seq_len + 1, args.tt_bags)]
    counters = _launch_counters()
    _reset(torch, counters)
    t0 = time.perf_counter()
    runs, got = [], []
    for mb, part in parts:
        rec = []
        runs.append(dict(engine.run_workload(part, max_batch=mb, record=rec),
                         max_batch=mb))
        got.append(rec)
    t_serve = time.perf_counter() - t0
    t0 = time.perf_counter()
    emb = [engine.embed_bags(bags[i:i + 8]) for i in range(0, len(bags), 8)]
    torch.cuda.synchronize()
    t_bags = time.perf_counter() - t0
    launches = _read(torch, counters)
    peak = torch.cuda.max_memory_allocated()
    by = launches["fused_decode_by"]
    emit("two_tower_path", requests=len(reqs), bags=len(bags),
         by_max_batch={r["max_batch"]: {k: r[k] for k in (
             "n_requests", "qps", "p50_ms", "p99_ms", "mean_ms")}
             for r in runs},
         qps=round(len(reqs) / t_serve, 1),
         serve_seconds=round(t_serve, 3), embed_bags_seconds=round(t_bags, 3),
         warmup_seconds=round(t_warm, 3), peak_device_bytes=peak,
         stragglers=runs[-1]["stragglers"], launches=launches,
         dot_score_launches_per_request=round(
             by.get("vbyte/dot_score", 0) / len(reqs), 4),
         bag_sum_launches_per_bag=round(
             by.get("vbyte/bag_sum", 0) / max(len(bags), 1), 4))
    if not by.get("vbyte/dot_score") or not by.get("vbyte/bag_sum"):
        die(f"two_tower did not launch kernel 2's dot_score and bag_sum: "
            f"{launches}")

    # every request and bag again through the plain torch plan on the
    # card; 5 requests also against scores computed on the host in f64
    t0 = time.perf_counter()
    swapped = 0
    for (mb, part), rec in zip(parts, got):
        want = []
        plain.run_workload(part, max_batch=mb, record=want)
        for (gs, gi), (ws, wi) in zip(rec, want):
            swapped += _topk_agree(torch, gs, gi, ws, wi,
                                   f"two_tower max_batch={mb}")
    bag_ulps = 0
    for i, e in zip(range(0, len(bags), 8), emb):
        w = plain.embed_bags(bags[i:i + 8])
        # the mean rounds twice (the sum, then the division by the count)
        s_abs = torch.stack([
            engine.bag_table[torch.as_tensor(bg.astype(np.int64),
                                             device="cuda")].float().abs()
            .sum(0) / max(len(bg), 1) for bg in bags[i:i + 8]])
        ok, _, u, _ = _float_close(torch, e, w, bf16=True,
                                   terms=cfg.seq_len, s_abs=s_abs, ulps=2)
        bag_ulps = max(bag_ulps, u)
        if not ok:
            die(f"embed_bags: beyond the stated tolerance of the torch "
                f"plan ({u} bf16 ulps)")
    table = engine.item_table[torch.as_tensor(cands.astype(np.int64),
                                              device="cuda")].double().cpu()
    first = parts[0][1][:8]  # the first microbatch, padded as served
    uid = np.full(8, 1, np.int32)
    hist = np.ones((8, cfg.seq_len), np.int32)
    for j, (uj, hj) in enumerate(first):
        uid[j], hist[j] = uj, hj
    uid, hist = torch.as_tensor(uid), torch.as_tensor(hist)
    with torch.inference_mode():  # the first microbatch's exact inputs
        u = recsys.user_tower(engine.params, uid.cuda(), hist.cuda(), cfg,
                              dtype=engine.dtype).double().cpu()[:5]
    host = (table @ u.T).T.float().to(torch.bfloat16).float()  # [5, C]
    hs, hi = recsys.topk_lower_index(host, engine.top_k)
    host_ids = torch.as_tensor(cands.astype(np.int64))[hi].to(torch.int32)
    gs, gi = got[0][0]
    swapped_host = _topk_agree(torch, gs[:5], gi[:5], hs, host_ids,
                               "two_tower vs host scores")
    emit("two_tower_parity", requests=len(reqs), bags=len(bags),
         near_tie_ids_swapped=swapped, host_checked=5,
         host_near_tie_ids_swapped=swapped_host, bag_max_bf16_ulps=bag_ulps,
         seconds=round(time.perf_counter() - t0, 3), equal=True)
    prof = parts[0][1][:16]
    share = _profile(torch, "two_tower",
                     lambda: engine.run_workload(prof, max_batch=8),
                     len(prof), unit="requests")
    seconds = time.perf_counter() - t_path
    emit("path_done", path="two_tower", seconds=round(seconds, 3))
    del engine, plain, params, corpus, table, emb
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": seconds, "peak": peak,
            "busy_share": share}


def run_gin(np, torch, args) -> dict:
    """Path ``gin``: gin-tu at full width (5 layers, d_hidden 64) over a
    graph made from ``--seed`` at the ogbn-products shape (2,449,029 nodes,
    61,859,140 edges, d_feat 100, 47 classes), adjacency compressed
    (vbyte, block 128): both decodes of ``decode_compressed_edges``, the
    forward pass and the loss; then owner_sum and kernel 1 held and timed
    at the graph's shapes."""
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.data.graph import compress_adjacency
    from repro_torch.data.sampler import CSRGraph
    from repro_torch.data.synthetic import random_graph
    from repro_torch.models import gnn, registry
    from repro_torch.nn.gnn import decode_compressed_edges

    t_path = time.perf_counter()
    cfg = registry.resolve_config("gin-tu", "ogb_products")
    dims = GNN_SHAPES["ogb_products"].dims
    N = int(dims["raw_nodes"] * args.gin_scale)
    E = int(dims["raw_edges"] * args.gin_scale)
    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    g = random_graph(rng, N, E, cfg.d_feat, cfg.n_classes)
    csr = CSRGraph.from_edges(g["edge_src"], g["edge_dst"], N)
    del g["edge_src"], g["edge_dst"]
    t_graph = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    comp = compress_adjacency(csr, device="cuda")
    t_comp = time.perf_counter() - t0
    own = torch.repeat_interleave(
        torch.arange(N, dtype=torch.int32, device="cuda"),
        torch.as_tensor(csr.degrees(), device="cuda"))
    raw_nbr = torch.as_tensor(csr.indices, device="cuda")
    feats = torch.as_tensor(g.pop("feats"), device="cuda")
    labels = torch.as_tensor(g.pop("labels"), device="cuda")
    params = gnn.init_params(cfg, seed=args.seed, device="cuda")
    gaps = comp["gaps"]
    emit("gin_build", nodes=N, edges=E, d_feat=cfg.d_feat,
         n_classes=cfg.n_classes, n_layers=cfg.n_layers,
         d_hidden=cfg.d_hidden, max_in_degree=int(csr.degrees().max()),
         gap_blocks=gaps.n_blocks, gap_stride=gaps.stride,
         bits_per_edge=round(comp["_bits_per_edge"], 4),
         gap_bits_per_int=round(gaps.bits_per_int, 4),
         resident_gap_bytes=gaps.resident_bytes,
         graph_seconds=round(t_graph, 3), compress_seconds=round(t_comp, 3))
    batch = {"feats": feats, "labels": labels,
             **{k: v for k, v in comp.items() if not k.startswith("_")}}
    args_dec = (gaps, comp["row_offsets"], E)

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    decode_compressed_edges(*args_dec, row_gap_bases=comp["row_gap_bases"])
    counters = _launch_counters()
    _reset(torch, counters)
    (nbr_f, own_f), t_fused = timed(lambda: decode_compressed_edges(
        *args_dec, row_gap_bases=comp["row_gap_bases"]))
    (nbr_l, own_l), t_legacy = timed(lambda: decode_compressed_edges(
        *args_dec))
    with torch.inference_mode():
        logits, t_fwd = timed(lambda: gnn.forward(params, batch, cfg))
        (loss, metrics), t_loss = timed(lambda: gnn.loss_fn(params, batch,
                                                            cfg))
    launches = _read(torch, counters)
    peak = torch.cuda.max_memory_allocated()
    by = launches["fused_decode_by"]
    emit("gin_path", decode_fused_ms=round(t_fused * 1e3, 3),
         decode_legacy_ms=round(t_legacy * 1e3, 3),
         forward_ms=round(t_fwd * 1e3, 3),
         loss_fn_ms=round(t_loss * 1e3, 3), loss=float(loss),
         accuracy=float(metrics["accuracy"]), peak_device_bytes=peak,
         launches=launches)
    if not (by.get("vbyte/adjacency_rebase") and launches[
            "vbyte_decode_blocked"] and launches["owner_sum"]):
        die(f"gin did not launch kernel 2's adjacency_rebase, kernel 1 and "
            f"owner_sum: {launches}")

    # checks: both decodes equal the raw CSR bit for bit; the plain torch
    # plan decodes the same edges; a second forward gives the same bits;
    # logits over the compressed and the raw adjacency are equal. The raw
    # batch holds the edges out of CSR order, owners interleaved at random
    # and each owner's edges in their CSR order, so the forward's stable
    # sort by owner must give the compressed path's (src, owner) order back
    t0 = time.perf_counter()
    for label, (nb_, ow_) in (("fused", (nbr_f, own_f)),
                              ("legacy", (nbr_l, own_l))):
        if not (torch.equal(nb_, raw_nbr) and torch.equal(ow_, own)):
            die(f"gin: {label} decode differs from the raw adjacency")
    del nbr_l, own_l
    for rgb in (comp["row_gap_bases"], None):
        nb_, ow_ = decode_compressed_edges(*args_dec, row_gap_bases=rgb,
                                           plan="torch")
        if not (torch.equal(nb_, nbr_f) and torch.equal(ow_, own_f)):
            die("gin: the kernel plan and the torch plan decode different "
                "edges")
        del nb_, ow_
    with torch.inference_mode():
        again = gnn.forward(params, batch, cfg)
    if not torch.equal(again, logits):
        die("gin: two forwards over the same batch differ")
    del again
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    key = torch.rand(E, generator=gen, dtype=torch.float64, device="cuda")
    # the same random keys, ascending within each owner (own is CSR order)
    key = torch.sort(own.double() + key).values - own.double()
    perm = torch.sort(key, stable=True).indices
    del key
    raw = {"feats": feats, "labels": labels, "edge_src": raw_nbr[perm],
           "edge_dst": own[perm]}
    del perm
    dst = raw["edge_dst"]
    interleaved = bool((dst[1:] < dst[:-1]).any())
    if not interleaved:
        die("gin: the raw batch's edges are still in CSR order")
    raw_cfg = dataclasses.replace(cfg, compressed_adjacency=False)
    with torch.inference_mode():
        logits_raw = gnn.forward(params, raw, raw_cfg)
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(loss))
    row_max = logits_raw.abs().amax(dim=1).clamp(min=1e-6)
    rel = float(((logits - logits_raw).abs().amax(dim=1) / row_max).max())
    if not finite or logits.shape != (N, cfg.n_classes) or rel != 0.0:
        die(f"gin: logits finite={finite} shape={tuple(logits.shape)}, "
            f"compressed vs raw adjacency rel err {rel} (0 required; "
            f"bound {GIN_RTOL})")
    emit("gin_parity", edges_equal=True, plans_equal=True,
         forwards_equal=True, raw_edges_interleaved=interleaved,
         logits_rel_err=rel, logits_rtol=GIN_RTOL,
         logits_max_abs=float(logits_raw.abs().max()),
         seconds=round(time.perf_counter() - t0, 3))
    del logits_raw, raw
    with torch.inference_mode():
        share = _profile(torch, "gin",
                         lambda: gnn.forward(params, batch, cfg), 1,
                         unit="forwards")
    kernels = gin_kernels(np, torch, comp, nbr_f, feats, cfg, args)
    seconds = time.perf_counter() - t_path
    emit("path_done", path="gin", seconds=round(seconds, 3))
    del params, batch, comp, gaps, feats, labels, logits, nbr_f, own_f
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": seconds, "peak": peak,
            "busy_share": share, **kernels}


def _owner_sample(np, torch, ro, n_top: int, n_others: int, seed: int):
    """Owners: the ``n_top`` with the most edges and ``n_others`` drawn
    from the rest; their edges' indices into the CSR arrays, and the
    sample's own row offsets (host tensors)."""
    deg = (ro[1:] - ro[:-1]).to(torch.int64)
    n = deg.numel()
    top = torch.sort(deg, descending=True, stable=True).indices[:n_top]
    rest = np.setdiff1d(np.arange(n), top.numpy())
    pick = np.random.default_rng(seed).choice(
        rest, min(n_others, rest.size), replace=False)
    owners = torch.as_tensor(np.sort(np.concatenate([top.numpy(), pick])))
    lens = deg[owners]
    sub_ro = torch.zeros(owners.numel() + 1, dtype=torch.int64)
    sub_ro[1:] = lens.cumsum(0)
    starts = ro[owners].to(torch.int64)
    e_idx = (torch.repeat_interleave(starts - sub_ro[:-1], lens)
             + torch.arange(int(sub_ro[-1])))
    return owners, e_idx, sub_ro


def gin_kernels(np, torch, comp, src, feats, cfg, args) -> dict:
    """owner_sum at the graph's two layer shapes (layer 1: bf16 features
    of d_feat; later layers: bf16 of d_hidden; f32 sums): equal bit for
    bit to its plain version on the CPU over a sample of owners (the top
    GIN_SAMPLE_TOP by in-degree and GIN_SAMPLE_OTHERS more), and timed
    beside its bound, the plain version's ops on the card and cuSPARSE
    SpMM (``torch.sparse_csr_tensor(row_offsets, src, edge_valid) @ h`` in
    f32: a yardstick, never called by the port); also timed on the top
    owner's edges alone and on the same edges spread evenly over the
    owners. Then kernel 1 over the graph's gap stream (the legacy
    decode's launch)."""
    from repro_torch.kernels.segment_sum import (owner_sum, owner_sum_plain,
                                                 segments)

    timer = ColdTimer(torch)
    ro = comp["row_offsets"]
    valid = comp["edge_valid"]
    seg = segments(ro)
    N, E = feats.shape[0], src.numel()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    shapes = {"layer1": feats.to(torch.bfloat16),
              "layer2_5": torch.randn(N, cfg.d_hidden, device="cuda",
                                      generator=gen).to(torch.bfloat16)}
    owners, e_idx, sub_ro = _owner_sample(np, torch, ro.cpu(), GIN_SAMPLE_TOP,
                                          GIN_SAMPLE_OTHERS, args.seed)
    src_m = torch.where(valid, src, -1)  # masked: -1, as the forward has it
    sub_src = src_m.cpu()[e_idx]
    # where the time goes: the top owner's edges alone (its CTAs split by
    # features), and the same edges spread evenly over the owners
    deg = ro[1:] - ro[:-1]
    top = int(torch.argmax(deg))
    top_edges = int(deg[top])
    ro_top = torch.zeros_like(ro)
    ro_top[top + 1:] = top_edges
    seg_top = segments(ro_top)
    src_top = src_m[int(ro[top]):int(ro[top + 1])].contiguous()
    even = torch.full((N,), E // N, dtype=torch.int64, device="cuda")
    even[:E - int(even.sum())] += 1
    ro_even = torch.zeros_like(ro)
    ro_even[1:] = even.cumsum(0).to(ro.dtype)
    seg_even = segments(ro_even)
    del even
    recs = {}
    for label, h in shapes.items():
        out = owner_sum(h, src_m, seg)
        want = owner_sum_plain(h.cpu(), sub_src, sub_ro)
        got = out[owners.to("cuda")].cpu()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            die(f"owner_sum {label} differs from its plain version on the "
                f"sampled owners")
        d = h.shape[1]
        n_valid = int(valid.sum())
        bound, by = _bound(bytes_moved=n_valid * d * h.element_size()
                           + 4 * E + 4 * (N + 1) + 4 * N * d,
                           ops=n_valid * d, ops_per_s=F32_FLOPS_PER_S)
        hf = h.float()
        spm = torch.sparse_csr_tensor(ro, src, valid.float(), size=(N, N))
        lib = spm @ hf
        lib_err = float((lib - out).abs().max())
        del lib
        recs[label] = {
            "n_owners": N, "n_edges": E, "d": d, "h_dtype": "bfloat16",
            "accumulate": "float32", "max_abs_err": 0,
            "sampled_owners": int(owners.numel()),
            "sampled_edges": int(e_idx.numel()),
            "ms": timer.ms(lambda: owner_sum(h, src_m, seg), reps=5),
            # the plain version sizes its outputs from device data (a
            # host synchronisation) and so may cuSPARSE: timed with ms_sync
            "plain_ms": timer.ms_sync(
                lambda: owner_sum_plain(h, src_m, ro), reps=2),
            "library_ms": timer.ms_sync(lambda: spm @ hf, reps=5),
            "library": "cuSPARSE SpMM, f32 values and h",
            "library_max_abs_err": lib_err,
            "bound_ms": bound, "bound_by": by,
            "top_owner_edges": top_edges,
            "top_owner_ms": timer.ms(lambda: owner_sum(h, src_top, seg_top),
                                     reps=5),
            "even_degrees_ms": timer.ms(lambda: owner_sum(h, src_m, seg_even),
                                        reps=5)}
        emit("parity_owner_sum", shape=label, **recs[label])
        del out, hf, spm
    gaps = comp["gaps"]
    ops = gaps.device_operands()
    st = decode_stats("vbyte", ops, gaps.payload_bytes, gaps.n)
    gin_gaps = time_decode(torch, timer, "vbyte", ops, st, reps=5,
                           plain_reps=1)
    emit("parity_decode_gin_gaps", kernel="vbyte_decode_blocked", **gin_gaps)
    rebase = time_gin_rebase(torch, timer, *gin_rebase_case(torch, comp, E))
    rebase["kernel1_ms"] = gin_gaps["ms"]
    emit("parity_decode_gin_gaps", kernel="fused_decode", **rebase)
    del shapes, timer
    gc.collect()
    torch.cuda.empty_cache()
    return {"owner_sum": recs, "gin_gaps": gin_gaps, "gin_rebase": rebase}


def gin_rebase_case(torch, comp, n_edges: int):
    """Kernel 2's adjacency_rebase at the gin path's shape: the graph's gap
    stream (vbyte, differential, block 128) and the ``edge_base`` that
    ``decode_compressed_edges`` builds for it. Returns ``(ops, extras,
    stats)``, the stats as :func:`gather_bound` reads them."""
    from repro_torch.nn.gnn import edge_bases, edge_owners

    gaps = comp["gaps"]
    owner = edge_owners(comp["row_offsets"].to(gaps.device), n_edges)
    extras = {"edge_base": edge_bases(gaps, comp["row_gap_bases"], owner)}
    del owner
    nb = gaps.n_blocks
    st = {"fmt": "vbyte", "B": gaps.block_size, "differential": True,
          "nb": nb, "stride": gaps.stride, "n_valid": gaps.n,
          "need": gaps.payload_bytes + 8 * nb}
    return gaps.device_operands(), extras, st


def time_gin_rebase(torch, timer, ops, extras, st) -> dict:
    """adjacency_rebase at the gin path's shape (:func:`gin_rebase_case`)
    held bit for bit against its plain version, then timed (L2 cold)
    beside the bound, the plain version and the unfused chain (kernel 1,
    then the torch subtraction)."""
    from repro_torch.kernels.vbyte_decode import epilogues

    kw = dict(format="vbyte", epilogue="adjacency_rebase", block_size=st["B"],
              differential=True)
    fused = lambda: epilogues.fused_decode(ops, extras, **kw)  # noqa: E731
    plain = lambda: epilogues.fused_decode_plain(ops, extras, **kw)  # noqa: E731
    out, ref = fused(), plain()
    torch.cuda.synchronize()
    err = _max_err(out, ref)
    if err or not torch.equal(out, ref):
        die(f"kernel 2 [vbyte/adjacency_rebase] differs from its plain "
            f"version at the gin path's shape: max_abs_err={err}")
    del out, ref
    chain = gather_chain(torch, "adjacency_rebase", extras, ops, st)
    bound, by = gather_bound("adjacency_rebase", extras, None, st)
    return {"format": "vbyte", "epilogue": "adjacency_rebase",
            "block_size": st["B"], "n_blocks": st["nb"],
            "stride": st["stride"], "n_ints": st["n_valid"],
            "max_abs_err": err, "ms": timer.ms(fused, reps=5),
            "plain_ms": timer.ms(plain, reps=1),
            "unfused_chain_ms": timer.ms(chain, reps=5),
            "bound_ms": bound, "bound_by": by}


# ---------------------------------------------------------------------------
# phase 5: the kernels line
# ---------------------------------------------------------------------------
def kernels_line(records, max_err, paths):
    src = "src/repro_torch/kernels/vbyte_decode/csrc/"
    ref = "src/repro/kernels/vbyte_decode/"
    by = Counter()
    by_path = {}
    for name, p in paths.items():
        by.update(p["launches"]["fused_decode_by"])
        for k, v in p["launches"]["fused_decode_by"].items():
            by_path.setdefault(k, {})[name] = v
    timed = records["fused_decode"]
    head = max(timed, key=lambda k: (by.get(k, 0), k))

    def entry(name, source, replaces, rec, *, src=src, ref=ref):
        launches = {p: v["launches"][name] for p, v in paths.items()}
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": ref + replaces,
                "launches": sum(launches.values()),
                "launches_by_path": launches, "max_abs_err": max_err[name],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": None}

    def variant(r):
        return {f: r[f] for f in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "max_abs_err", "unfused_chain_ms",
                                  "kernel1_ms",
                                  "index_select_ms", "max_bf16_ulps",
                                  "decode_kernel_ms", "checked_over_decode",
                                  "n_blocks", "stride", "n_ints",
                                  "gints_per_s", "plain_gints_per_s",
                                  "library_ms", "d")
                if f in r}

    def decode_entry(name, source, replaces):
        # the parity shape's times, and the whole search index in one
        # launch (phase parity_decode_scale)
        return dict(entry(name, source, replaces,
                          records[name]["S128/diff=1"]),
                    scale=variant(records[name]["scale"]))

    gin = paths["gin"]
    owner = gin["owner_sum"]["layer1"]
    max_err = {**max_err, "owner_sum": max(
        r["max_abs_err"] for r in gin["owner_sum"].values()),
        "fused_decode": max(max_err["fused_decode"],
                            gin["gin_rebase"]["max_abs_err"])}
    line = {"kernels": [
        dict(decode_entry("vbyte_decode_blocked", "vbyte_decode.cu",
                          "kernel.py:167"),
             gin_gaps=variant(gin["gin_gaps"])),
        dict(entry("fused_decode", "fused_decode.cu", "epilogues.py:383",
                   timed[head]),
             max_abs_err=max(max_err["fused_decode"],
                             max_err["fused_decode_float"]),
             max_abs_err_integer_epilogues=max_err["fused_decode"],
             max_abs_err_float_epilogues=max_err["fused_decode_float"],
             float_tolerance="bf16 tables: 1 bf16 ulp; f32: rtol=atol=1e-5",
             timed_epilogue=head,
             # times per timed variant (format/epilogue[/table/query rows]);
             # launches per format/epilogue, which is what the count keys on
             epilogues={k: variant(r) for k, r in timed.items()},
             # dot_score at the two_tower path's corpus and buckets
             dot_score_path={k: variant(r)
                             for k, r in records["dot_score_path"].items()},
             # the probe epilogues at the search path's block counts
             probe_path={k: variant(r)
                         for k, r in records["probe_path"].items()},
             # adjacency_rebase over the gin path's whole gap stream
             gin_adjacency_rebase=variant(gin["gin_rebase"]),
             # checksum over whole posting lists, as the hardened search
             # path's startup gate launches it (K=12, 16, 20, each format)
             checksum_path={k: variant(r) for k, r in
                            paths["hardened_search"]["checksum_path"]
                            .items()},
             launches_by_epilogue={k: {"total": v, "by_path": by_path[k]}
                                   for k, v in sorted(by.items())}),
        decode_entry("stream_decode_blocked", "stream_decode.cu",
                     "stream_kernel.py:234"),
        decode_entry("binpack_decode_blocked", "binpack_decode.cu",
                     "binpack_kernel.py:119"),
        dict(entry("owner_sum", "owner_sum.cu", "nn/gnn.py:45", owner,
                   src="src/repro_torch/kernels/segment_sum/csrc/",
                   ref="src/repro/"),
             replaces_note="jax.ops.segment_sum (an XLA scatter-add; the "
                           "reference has no pallas_call there)",
             library_ms=owner["library_ms"], library=owner["library"],
             shapes={k: variant(r) for k, r in gin["owner_sum"].items()}),
    ], "library_ms_note": "no single PyTorch call computes any of the "
                          "decodes; the gather epilogues' unfused_chain_ms "
                          "is decode kernel + one PyTorch call; owner_sum's "
                          "library_ms is cuSPARSE SpMM in f32",
        "shapes": "B=128, stride 128, 4096 blocks, differential, cold L2; "
                  "gather tables [8389120, 256] bf16 and [8389120, 128] f32; "
                  "decode scale: every search-index posting in one launch; "
                  "owner_sum: the gin graph's layer 1 (bf16 [N, 100], f32 "
                  "sums)"}
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=50,
                    help="queries of the format='auto' path")
    ap.add_argument("--svb-queries", type=int, default=25,
                    help="queries of the format='streamvbyte' path")
    ap.add_argument("--vbyte-queries", type=int, default=25,
                    help="queries of the format='vbyte' path")
    ap.add_argument("--k20-lists", type=int, default=16,
                    help="K=20 lists of every path")
    ap.add_argument("--profile-queries", type=int, default=5,
                    help="queries per search path traced by torch.profiler")
    ap.add_argument("--tt-requests", type=int, default=256,
                    help="requests of the two_tower path")
    ap.add_argument("--tt-bags", type=int, default=64,
                    help="embedding bags of the two_tower path")
    ap.add_argument("--gin-scale", type=float, default=1.0,
                    help="fraction of ogbn-products' nodes and edges in the "
                         "gin path's graph")
    ap.add_argument("--live-ops", type=int, default=20_000,
                    help="acknowledged ops of the live_index phase")
    ap.add_argument("--metrics-out", default=None, metavar="DIR",
                    help="keep the telemetry capture's exports in DIR")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not (SRC / "repro_torch" / "__init__.py").is_file():
        die(f"no src/repro_torch next to {Path(__file__).name}: run it from "
            "a checkout of the repository", 2)
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    t_start = time.perf_counter()
    card = phase_device(torch)
    phase_build()
    timer = ColdTimer(torch)
    records, max_err = phase_parity(np, torch, timer)
    phase_decode_scale(np, torch, timer, records, max_err, args)
    del timer
    gc.collect()
    torch.cuda.empty_cache()
    emit("parity_done", seconds=round(time.perf_counter() - t_start, 3))
    paths = phase_main_paths(np, torch, args)
    paths["two_tower"] = run_two_tower(np, torch, args)
    paths["gin"] = run_gin(np, torch, args)
    emit("done", seconds=round(time.perf_counter() - t_start, 3),
         path_seconds={k: round(v["seconds"], 3) for k, v in paths.items()})
    print(card, flush=True)
    kernels_line(records, max_err, paths)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
