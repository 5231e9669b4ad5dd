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
   first 10 queries), ``format="auto"`` (the first 10; its per-list
   partition DPs run in worker processes, one ``build_index`` call per
   term, merged on the card) and ``format="streamvbyte"`` (the first 10),
   2 queries of each of the 5 modes.
   The first 5 queries' results and ``QueryStats`` (one of each mode) are
   then held equal to the plain
   ``plan="torch"`` engine's on the card (the replay runs in spawned
   worker processes, each placing the index on the card from its numpy
   leaves without the checksum columns the indexes are built with: the
   same answers, accounting and bits/int, so the column is off the request
   path), and each replayed AND/OR answer against numpy set operations
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
   process per path, the shard-loss drill over the path's first 10
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
   first 10 queries with ``Telemetry(torch_annotations=True)`` and
   ``torch.profiler`` on: the three exports, the per-stage table and the
   report CLI's; every answer bit for bit the main path's, the summed
   ``decode_calls_total`` equal to the ``dispatch.decode`` calls (and the
   kernel launches at least that), every kernel of the port in the
   profiler's trace under a ``decode`` range whose span names its format
   and epilogue (after the profiler's warm-up window over the first
   query: without one, the first kernel records of a session can be
   lost), ``serve_*_total`` mirroring ``serve_stats``.
   Then phase ``live_index``: a ``LiveIndex`` on local disk
   (``fsync=True``) on the card whose main segment is the ``auto`` path's
   index (48 terms, epoch 1 committed with ``ingest.write_epoch``, the
   commit ``merge`` makes); 20,000 acknowledged ops through ``LiveSearchEngine`` (adds of
   new docs with 1–4 of the 48 terms at tf 1–4, deletes with p 0.2 over
   the main segment's and the delta's docs); the ``auto`` path's first 10
   queries as and / or / topk, each answer equal to the materialize()
   oracle and to ``plan="torch"`` on the card; a restart replaying the
   whole WAL (a query during replay flagged ``replaying``; load, CRC,
   upload and replay seconds). The ``plan="torch"`` answers and the
   oracle come from a spawned worker on a copy of the directory, and the
   crash-point sweep runs over the K=12 ∪ K=16 terms (2,000 more ops) in
   another, both while this process serves: a merge crashed at a seeded
   point with 50 writes racing it, recovery, the retried merge checked at
   all 8 crash points and after commit (the merge runs at that scale
   only: the full-size merge is a depth cut).
5. path ``two_tower`` — two-tower-retrieval at full width (2^23 users and
   items) served by ``ServingEngine`` over 2^20 compressed candidates:
   256 requests drained at most 8, 4, 2 and 1 at a time, then 64 bags
   through ``embed_bags``; every top-k and bag held against the plain
   engine's, 5 requests against scores computed on the host.
   Path ``recsys`` — SASRec, BERT4Rec, BST and two-tower at full width
   (their configs, parameters from ``--seed``), every launch count set
   to 0 just before the path and read just after; per architecture:
   serve_p99 (512 rows) through ``serve_scores``, p50 / p99 of 20 calls,
   held against the plain attention's scores (within 2^-5 of the largest
   |score|; two-tower equal); retrieval_cand (2^20 distinct sorted ids
   of the table's rows, vbyte, differential, block 128, stride 256)
   through ``retrieval_scores_compressed``: kernel 2's ``dot_score``
   (SASRec, BERT4Rec) or kernel 1 then the towers (BST, two-tower), ids
   bit for bit against ``plan="torch"``, scores within one bf16 ulp or
   the f32 sums' rounding bound (the towers: equal), the top 100 equal
   but for near-ties, launches per request; train_batch (65,536 rows,
   kept whole) through ``make_train_step`` under deterministic
   algorithms: one step's gradients within 2^-4 (relative L2 a leaf) of
   the plain attention's (two-tower: its chunked loss against the whole
   one at 8,192 rows), 4 AdamW steps (peak_lr 5e-3, BST 1e-4; losses
   finite and falling, ms by forward / backward / AdamW, peak bytes), a
   replay from a fresh init of the seed and (not two-tower, whose state
   is ~34 GB) a restart from a checkpoint after step 1, bit for bit; the
   SDPA backend PyTorch picked for serving and for training. Phase
   ``parity_recsys_dot_score`` times ``dot_score`` at that retrieval
   shape (bf16 d = 50 and 64).
   Path ``lm`` — the LM family at full width (configs unchanged,
   parameters from ``--seed``), every launch count set to 0 just before
   the path and read just after: ``lm_pipeline`` (a Zipf token stream at
   vocab 32,000 through ``CompressedTokenPipeline(plan="auto")`` at 8 ×
   4,097 tokens a step: every batch bit for bit against ``plan="torch"``
   and the raw stream, one kernel 1 launch a step); ``lm_serve`` for
   h2o-danube-1.8b (4 prompts of 8,192 tokens, twice its window:
   ``prefill``, ``prefill_chunked(chunk=4096)``, 32 greedy
   ``decode_step``s) and olmoe-1b-7b (4 × 2,048, 32 steps) under
   ``torch.inference_mode``, each freed before the next: seconds, ms a
   token, tokens a second, peak bytes, the SDPA backend, ``moe_drop_frac``
   at prefill and decode; chunked against whole prefill (logits and
   cache), decode logits at S..S+3 against a forward over the longer
   sequence, and the plain attention against the default, within 2^-5
   of the largest |logit| (olmoe's checks at float32, its decode check
   with capacity E / K on the prompts' first 256 tokens: at bf16 its
   router sends some tokens to other experts on last-bit differences;
   the bf16 readings are reported); ``lm_train``: h2o-danube-1.8b at
   train_4k's 4,096 tokens, 8 rows (cut from 256), microbatch 4, under
   deterministic algorithms, batches from the pipeline: one microbatch's
   gradients within 2^-4 of the plain attention's, 4 AdamW steps (peak_lr
   3e-4, warm-up 1; losses finite, the last below the first; ms by
   forward / backward / AdamW, peak bytes), a replay from a fresh
   ``init_params`` of the seed and a restart from a checkpoint after step
   2 at 2 of the 24 layers (full widths), bit for bit. Then
   ``parity_lm_pipeline``: kernel 1 on the pipeline's shard, held and
   timed.
   Path ``sharded_train`` — h2o-danube-1.8b at full width (24 layers,
   float32 parameters from ``--seed``) trained data-parallel with ZeRO-1
   over ``make_mesh((4, 1), ("data", "model"))`` (4 logical shards of
   ``cuda:0`` on one card), every launch count set to 0 just before the
   path and read just after, under deterministic algorithms: the
   ``build_cell("h2o-danube-1.8b", "train_4k", zero1)`` specs place the
   state (master, ``m``, ``v`` split over ``data`` wherever
   ``zero1_extend`` applies) and its hooks gather one bf16 compute copy a
   step; 2 steps of ``jit_train_step`` at 8 × 4,096 tokens (one
   microbatch a shard, batches from ``CompressedTokenPipeline``: kernel
   1), then the same 2 steps of the single-device
   ``make_train_step(microbatch=4)`` with the same hooks from a fresh
   state (one state on the card at a time): losses, grad norms and every
   leaf's digest of params, ``m`` and ``v`` bit for bit; ms a step by
   gather / forward_backward / reduce / update, peak bytes, state bytes a
   shard, beside path ``lm``'s single-device step; ``compressed_psum``
   over the 4 shards bit for bit against its CPU result.
   Path ``model_parallel`` — tensor and expert parallelism over a
   ``model`` axis (logical shards of ``cuda:0`` on one card), every
   launch count set to 0 just before the path and read just after:
   ``mp_train``: h2o-danube-1.8b at full width (24 layers, float32 from
   ``--seed``), ``build_cell``'s ZeRO-1 specs and hooks over
   ``make_mesh((2, 2), ("data", "model"))``, 8 × 4,096 tokens a step from
   ``CompressedTokenPipeline`` (kernel 1), microbatch 4 (two parts a data
   position), under deterministic algorithms: 2 steps of
   ``jit_train_step`` against the single-device hooked step at
   microbatch 4 (losses and grad norms within 1e-3 relative, the first
   step's every gradient leaf within relative L2 2^-4), and a replay of
   the 2 mesh steps bit for bit; ms a step by phase, peak bytes.
   ``mp_serve`` over ``make_mesh((1, 4))`` through
   ``registry.run_cell``, bf16 parameters from ``--seed``, against the
   single-device functions fed the same tokens: olmoe-1b-7b (16 experts
   and 4 K/V heads a position, the cache split by heads) prefill of 4 ×
   2,048 and 16 decode steps; h2o-danube-1.8b (the cache split by head
   dimension) prefill of 1 × 4,096 and 16 decode steps; mixtral-8x7b at
   2 of its 32 layers (each expert's hidden units split) one prefill of 1
   × 4,096. Logits within 2^-5 of the largest |logit|, ``moe_drop_frac``
   equal; prefill seconds and decode ms a token beside the single
   device's.
   Path ``mesh_cells`` — the recsys cells over a ``(data, model)`` mesh
   of logical shards of ``cuda:0``, each against the single device from
   the same seed and inputs: ``dp_train`` (SASRec and two-tower
   ``train_batch`` at full width, 65,536 rows, microbatch 1, over ``(4,
   1)``: each step's rows split over the positions and its loss reduced
   across them), ``mp_recsys_train`` (BST and two-tower over ``(2, 2)``:
   the tables split by rows and the MLPs by columns and rows over
   ``model``, and a replay bit for bit); 2 steps each, each step's loss
   and grad norm within 1e-3 and its gradients within 2^-4 (relative L2
   over every small leaf and a sample of each table's rows, those the
   batch hits among them) of the single device's from the same state:
   the seed's for the first step, the state the mesh's previous step
   left for a later one. ``mp_recsys_serve`` (SASRec and BST over
   ``(1, 4)`` through ``registry.run_cell``: ``serve_p99`` at 512 rows
   and ``retrieval_cand`` over 2^20 vbyte candidates, one decode launch a
   shard, counted exactly; SASRec bit for bit, BST within 2^-5).
   Path ``sharded`` — ``make_mesh((8,), ("data",))``: over the cards when
   there are several, else 8 logical shards of ``cuda:0`` (a single
   controller, no collective, as the reference's ``shard_map`` decode).
   ``sharded_parity``: each format at the parity layout, 4,096 and 4,093
   blocks (padded to 4,096), through ``decode(plan="sharded")`` for
   ``stream`` and every kernel 2 epilogue, bit for bit against the
   unsharded launch, padding rows zero, 8 launches a call. Then, every
   launch count set to 0 and no worker process alive:
   ``sharded_search`` (``SearchEngine(mesh=...)`` over the three search
   indexes, still on the card: each path's first ``SHARDED_QUERIES``
   queries (and, or, topk), a ``topk_maxscore`` query over the two
   shortest lists, and a ``topk_driver`` query over the
   shortest list with the two longest, so kernel 2's ``bm25_weighted``
   scores over the mesh; answers equal to the single-device engine's,
   QPS, p50, p99, launches a query), ``sharded_two_tower``
   (``ServingEngine(mesh=...)`` at full width, 64 requests at bucket 8
   and 16 bags, bit for bit against the single-device engine run after
   the counts are read; one item table on the card), and
   ``device_encode`` (``encode_blocked_device`` over every search
   posting, padded to a multiple of 128, stride 640, both differential
   settings: bytes and bases against the host encoder, both through
   kernel 1 bit for bit; ms beside the host encoder's seconds). Then, in
   spawned workers side by side, ``sharded_search_parity`` (answers and
   ``QueryStats`` against ``plan="torch"`` on the same mesh) and
   ``sharded_degraded`` (``shard_loss_drill`` over a mesh engine,
   ``validate=True, n_shards=8``, on the ``vbyte`` index).
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
   Phase ``gin_train``, between ``gin_parity`` and those checks: gin-tu
   trained on the same graph (bf16 compute, float32 aggregation; each
   step decodes the adjacency with kernel 2's adjacency_rebase and sums
   by owner and, backward, by source with owner_sum): one step's
   gradients within GIN_GRAD_RTOL of the plain plan's on the card; 10
   steps of ``make_train_step`` (AdamW, peak_lr 1e-2, warm-up 1): each
   loss finite and the last below the first, ms per step by part, peak
   bytes, launches per step; a replay of the 10 steps from the same
   initial state and a restart from a checkpoint saved after step 4 into
   a fresh state, both giving the same losses and state bit for bit;
   then the backward kernel bit for bit against its plain version on the
   CPU over sampled rows (the step's grouping by source, and the
   in-degree grouping with rows past LONG_ROW) and timed beside its
   bound, its plain version and cuSPARSE SpMM over the transposed CSR.
   Phase ``gin_mesh``, after ``gin_train``: its first two steps over
   ``(4, 1)`` and ``(2, 2)`` through ``jit_train_step`` with the
   ``ogb_products`` cell's specs (node rows, labels, gap blocks and
   ``edge_valid`` split over every position; one ``adjacency_rebase``
   launch a position a forward, counted exactly), each step's loss, grad
   norm and gradients (within GIN_GRAD_RTOL) held as ``mesh_cells`` holds
   them, against one device from the same state.
   Path ``analysis`` — every launch count set to 0 just before it and
   read just after: ``autotune`` (``dispatch.autotune`` at its defaults,
   3 formats × 11 epilogues at the reference's workload, into a
   temporary file: each key's ``candidates_ms`` and fastest candidate,
   every key this card's and its plan the kernels, no other file
   written), ``auto_cache`` (that file rewritten so every entry names the
   torch decoder: on every key ``plan="auto"`` on the card still resolves
   to the kernels, launches one and gives the explicit kernel plan's
   output bit for bit; no ``plan_cache_total`` counted, since card
   operands read no cache) and ``dryrun`` (``launch/dryrun.py`` over every
   built cell at ``(1, 1)`` and ``(4, 1)`` on ``meta``, a line a cell with
   its bytes a card, whether they fit in 80 GB and the dominant roofline
   term; then h2o-danube-1.8b's ``train_4k`` params and optimizer state
   with ZeRO-1 over ``(4, 1)`` equal, to the byte, to the largest shard of
   path ``sharded_train``'s placed state).
7. the ``kernels`` line (the ``analysis`` path's launches a column of
   ``launches_by_path``), the card line, and the result line.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import multiprocessing as mp
import os
import subprocess
import sys
import tempfile
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
REPLAY_QUERIES = 5  # a path's first queries replayed, one of each mode (a
#                     depth cut: all 10 took 33-50 s a path on a slow host)
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
# phase gin_train: steps of make_train_step (AdamW as the reference's GIN
# test: peak_lr 1e-2, warm-up 1), the step after which a checkpoint is
# saved and restored, and the bound on one step's gradients by the kernel
# plan against the plain plan's on the card, relative L2 per leaf: the
# plain plan sums by owner and by source with index_add_ in another order,
# which moves some bf16 roundings of the activations by one ulp (2^-8) in
# each of the 5 layers and in the backward's bf16 products
GIN_TRAIN_STEPS = 10
GIN_CKPT_STEP = 4
GIN_GRAD_RTOL = 2.0**-4
# the search index's length groups (K -> lists; K=20's count is a flag)
SEARCH_GROUPS = {12: 16, 16: 16}
# phase hardened_search: the shard-loss drill serves each search path's
# first HARDENED_QUERIES queries over HARDENED_SHARDS logical shards and
# loses shard VICTIM_SHARD; the retry checks allow RETRIES retries
HARDENED_QUERIES = 10
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
    the sleep, the sleep is doubled and the launch measured again. Each
    :meth:`ms` starts from a short sleep (~0.5 ms), so a kernel that the
    host queues in microseconds does not wait out the sleep a plain
    version needed: the smoke times thousands of launches.
    """

    SLEEP_CYCLES = 1 << 20

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                                 device="cuda")
        self.sleep_cycles = self.SLEEP_CYCLES

    def ms(self, fn, reps: int, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        self.sleep_cycles = self.SLEEP_CYCLES
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
        for _ in range(12):
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


def _gather_sum_bound(*, rows: int, n_owners: int, n_edges: int,
                      n_valid: int, d: int, in_bytes: int):
    """owner_sum's bound: ``(ms, "bytes" | "operations", gathered_ms)``.
    Bytes: each input read once (``rows × d`` of ``h``, ``src``, the row
    offsets) and the f32 output written once; operations: one add per
    valid edge and feature at the f32 rate. ``gathered_ms`` counts every
    gathered row as read from memory instead (the bound PRs 16–19 stated):
    above the least time where ``h`` stays in the 50 MB L2."""
    fixed = 4 * n_edges + 4 * (n_owners + 1) + 4 * n_owners * d
    ms, by = _bound(bytes_moved=rows * d * in_bytes + fixed,
                    ops=n_valid * d, ops_per_s=F32_FLOPS_PER_S)
    return ms, by, _bound(bytes_moved=n_valid * d * in_bytes + fixed,
                          ops=n_valid * d, ops_per_s=F32_FLOPS_PER_S)[0]


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
    phase_recsys_dot_score(np, torch, timer, records, max_err)
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


RECSYS_DOT_WIDTHS = {"sasrec": 50, "bert4rec": 64}  # bf16 item tables


def phase_recsys_dot_score(np, torch, timer, records, max_err):
    """``dot_score`` at the recsys path's retrieval_cand shape for SASRec
    (bf16 d = 50: 100-byte rows, 4-byte copies, a padded mma k-step) and
    BERT4Rec (bf16 d = 64): the whole item table ``[2^20 + 512, d]``,
    2^20 distinct sorted candidate ids of its rows (vbyte, differential,
    block 128, stride 256), one bf16 query row; held against the plain
    version and timed beside the bound, the plain version and the unfused
    chain (decode kernel, then index + einsum)."""
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.core import CompressedIntArray
    from repro_torch.models import registry

    dims = RECSYS_SHAPES["retrieval_cand"].dims
    records["recsys_dot_score"] = {}
    for arch, d in RECSYS_DOT_WIDTHS.items():
        V = registry.resolve_config(arch, "retrieval_cand").vocab_rows
        rng = np.random.default_rng(d)
        ids = np.sort(rng.choice(np.arange(1, V, dtype=np.int64),
                                 dims["n_candidates"], replace=False))
        arr = CompressedIntArray.encode(
            ids.astype(np.uint64), differential=True,
            stride_multiple=dims["payload_stride"], device="cuda")
        ops = arr.device_operands()
        st = gather_stats(np, torch, "vbyte", ops, arr.payload_bytes, BLOCK,
                          True)
        g = torch.Generator(device="cuda").manual_seed(d)
        table = (torch.randn(V, d, generator=g, device="cuda")
                 * 0.02).to(torch.bfloat16)
        query = torch.randn(1, d, generator=g, device="cuda").to(
            torch.bfloat16)
        rec = time_gather(torch, timer, f"dot_score/bf16/d{d}/q1",
                          "dot_score", {"table": table, "query": query},
                          "bf16", ops, st, max_err)
        rec.update(arch=arch, d=d, table_rows=V)
        records["recsys_dot_score"][arch] = rec
        emit("parity_recsys_dot_score", **rec)
        del table, ops, arr


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
            "owner_sum": segment_sum.launches,
            "owner_sum_backward": segment_sum.backward_launches}


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
    the launch counts read around the workload, replay its first
    REPLAY_QUERIES queries through the plain torch plan in ``pool``'s
    worker processes, and profile a few queries."""
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
    rq = qs[:REPLAY_QUERIES]
    parts = [p for p in (list(range(i, len(rq), workers))
                         for i in range(workers)) if p]
    state = _index_state(index, checksums=False)
    replayed = {}
    for part, rep in zip(parts, pool.map(
            _replay, [state] * len(parts),
            [[rq[i] for i in p] for p in parts])):
        if rep["bits_per_int"] != index.bits_per_int:
            die(f"{name}: bits/int {index.bits_per_int} with the checksum "
                f"columns, {rep['bits_per_int']} without")
        replayed.update(zip(part, rep["answers"]))
    del state
    oracle = 0
    by_mode = {}  # mode -> [n, kernel-plan seconds, torch-plan seconds]
    for i, ((mode, terms), (a, sa, secs)) in enumerate(zip(rq, record)):
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
    emit("main_path_parity", path=name, queries=len(rq),
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


def phase_main_paths(np, torch, args) -> tuple[dict, dict]:
    """The three main paths over the same lists and query stream. Returns
    the paths and what path ``sharded`` serves again later: the host
    lists, the query stream, the indexes (left on the card) and the main
    paths' answer digests."""
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
    search = {"lists": lists, "qs": qs, "n_queries": path_queries,
              "indexes": {n: paths[n].pop("index") for n in path_queries},
              "digests": {n: paths[n].pop("digests") for n in path_queries}}
    paths["hardened_search"] = hardened
    paths["telemetry"] = telemetry
    paths["live_index"] = live_index
    gc.collect()
    torch.cuda.empty_cache()
    return paths, search


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
TELEMETRY_QUERIES = 10  # the vbyte path's first queries, captured
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


def capture(torch, engine, qs, tele, counters, *, warmup: bool = True):
    """``qs`` served by ``engine`` under ``tele`` and ``torch.profiler``,
    the launch counts set to 0 just before and read just after: ``(answers,
    profiler, seconds, dispatch.decode calls, launches)``. With
    ``warmup`` the profiler first runs a warm-up window over the first
    query (untraced, uncounted): CUPTI is enabled there, and the capture's
    window starts with it running; without it, the first kernel records
    of a session can be lost (``tools/capture_check.py``)."""
    from torch.profiler import ProfilerActivity, profile, schedule

    from repro_torch import obs
    from repro_torch.kernels.vbyte_decode import dispatch

    calls = [0]
    real_decode = dispatch.decode

    def counted(*a, **kw):
        calls[0] += 1
        return real_decode(*a, **kw)

    outs = []
    sched = schedule(wait=0, warmup=1, active=1) if warmup else None
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=sched) as prof:
        if warmup:
            engine.search(qs[0][1], qs[0][0])
            torch.cuda.synchronize()
            prof.step()
        _reset(torch, counters)
        dispatch.decode = counted
        try:
            with obs.install(tele):
                t0 = time.perf_counter()
                for mode, terms in qs:
                    outs.append(engine.search(terms, mode))
                seconds = time.perf_counter() - t0
            torch.cuda.synchronize()
        finally:
            dispatch.decode = real_decode
    return outs, prof, seconds, calls[0], _read(torch, counters)


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
    whose span names its format and epilogue (:func:`capture`), and
    ``serve_*_total`` mirroring ``serve_stats``."""
    import shutil
    import tempfile

    from repro_torch import obs
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
    tele = obs.Telemetry(torch_annotations=True)
    counters = _launch_counters()
    outs, prof, capture_s, calls, launches = capture(
        torch, engine, cap_qs, tele, counters)
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
    if not (decode_calls == decode_spans == calls):
        die(f"telemetry: decode_calls_total {decode_calls}, decode spans "
            f"{decode_spans}, dispatch.decode calls {calls}")
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
LIVE_QUERIES = 10  # the auto path's first queries, as and / or / topk
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
    the directory while this process serves). The crash-point sweep — a
    merge crashed at a seeded point with writes racing it, recovery, then
    the retried merge checked at all 8 points and after commit — runs over
    the K=12 ∪ K=16 terms in another spawned worker, at the same time: the
    merge runs at that scale only (the full-size merge, 60-107 s, is a
    depth cut)."""
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

            # 5. the crash-point sweep's results
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
    train = run_gin_train(np, torch, args, cfg, batch, comp, nbr_f, own_f)
    mesh = gin_mesh(np, torch, args, cfg, batch, train)
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
            "busy_share": share, "train": train, "mesh": mesh, **kernels}


class _StepClock:
    """CUDA events at the edges of a train step's parts, by wrapping the
    functions the step calls for the clock's lifetime: ``decode``
    (``decode_compressed_edges`` inside the loss), ``forward`` (the rest of
    the loss: :meth:`loss` wraps it), ``backward`` (from the loss to the
    optimizer) and ``optimizer`` (AdamW)."""

    def __init__(self, torch):
        from repro_torch.models import gnn
        from repro_torch.train import train_state

        self.torch, self.gnn, self.ts = torch, gnn, train_state
        self.real = (gnn.decode_compressed_edges, train_state.adamw_update)
        self.marks = {}

    def mark(self, name):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks[name] = ev

    def loss(self, fn):
        def timed(*a, **kw):
            out = fn(*a, **kw)
            self.mark("loss_end")
            return out
        return timed

    def __enter__(self):
        decode, adamw = self.real

        def timed_decode(*a, **kw):
            self.mark("decode_start")
            out = decode(*a, **kw)
            self.mark("decode_end")
            return out

        def timed_adamw(*a, **kw):
            self.mark("opt_start")
            out = adamw(*a, **kw)
            self.mark("end")
            return out

        self.gnn.decode_compressed_edges = timed_decode
        self.ts.adamw_update = timed_adamw
        return self

    def __exit__(self, *exc):
        self.gnn.decode_compressed_edges, self.ts.adamw_update = self.real
        return False

    def step_ms(self) -> dict:
        """The last step's parts in ms (``mark("start")`` before it); a
        step that decodes nothing (the recsys models) has no ``decode``."""
        self.torch.cuda.synchronize()
        m = self.marks
        out = {"forward": m["start"].elapsed_time(m["loss_end"]),
               "backward": m["loss_end"].elapsed_time(m["opt_start"]),
               "optimizer": m["opt_start"].elapsed_time(m["end"]),
               "step": m["start"].elapsed_time(m["end"])}
        if "decode_start" in m:
            out["decode"] = m["decode_start"].elapsed_time(m["decode_end"])
            out["forward"] = (m["start"].elapsed_time(m["decode_start"])
                              + m["decode_end"].elapsed_time(m["loss_end"]))
        m.clear()
        return out


def _train_steps(torch, step_fn, state, batch, steps, clock=None,
                 on_step=None):
    """``steps`` train steps from ``state``: (state, losses, step ms)."""
    losses, times = [], []
    for i in range(steps):
        if clock is not None:
            clock.mark("start")
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
        if clock is not None:
            times.append(clock.step_ms())
        if on_step is not None:
            on_step(i, state)
    return state, losses, times


def _state_equal(torch, a: dict, b: dict) -> bool:
    from repro_torch.convert import train_state_tree
    from repro_torch.tree import flatten

    fa, fb = (flatten(train_state_tree(x)) for x in (a, b))
    return [k for k, _ in fa] == [k for k, _ in fb] and all(
        x.dtype == y.dtype and torch.equal(x, y)
        for (_, x), (_, y) in zip(fa, fb))


def _plain_grads(torch, params, batch, cfg):
    """One step's gradients by the plain plan on the card: the decode's
    torch plan and owner_sum's plain version (gather + ``index_add_``) in
    ``gin_layer``, through autograd. Each layer's plain sum is recomputed
    in the backward (``torch.utils.checkpoint``): autograd would otherwise
    keep every layer's float32 ``[E, d]`` messages, 15.8 GB each at the
    ogbn-products shape."""
    import dataclasses

    from torch.utils.checkpoint import checkpoint

    from repro_torch.kernels.segment_sum import owner_sum_plain
    from repro_torch.models import gnn
    from repro_torch.nn import gnn as nn_gnn
    from repro_torch.train import param_leaves

    def plain(h, src, seg, edge_valid=None, *, accumulate, by_source=None):
        return checkpoint(
            lambda x: owner_sum_plain(x, src, seg.row_offsets, edge_valid,
                                      accumulate=accumulate),
            h, use_reentrant=False)

    real = nn_gnn.owner_sum
    nn_gnn.owner_sum = plain
    try:
        loss, _ = gnn.loss_fn(params, batch,
                              dataclasses.replace(cfg, decode_plan="torch"))
        leaves = param_leaves(params)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    finally:
        nn_gnn.owner_sum = real
    return float(loss.detach()), dict(zip(leaves, grads))


def run_gin_train(np, torch, args, cfg, batch, comp, nbr, own) -> dict:
    """Phase ``gin_train``: gin-tu at full width trained on the gin path's
    graph (its compressed adjacency decoded by kernel 2's adjacency_rebase
    every step; owner_sum forward and backward): GIN_TRAIN_STEPS steps of
    ``make_train_step`` (loss, ms per step by part, peak bytes, launches
    per step), a replay from the same initial state and a restart from a
    checkpoint saved at GIN_CKPT_STEP, both bit for bit; one step's
    gradients against the plain plan's; then the backward kernel held bit
    for bit against its plain version on the CPU over sampled rows and
    timed (bound, plain, cuSPARSE) at the step's shape."""
    import copy
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import (gnn_train_state_from_tree,
                                     train_state_tree)
    from repro_torch.models import gnn
    from repro_torch.train import (OptimizerConfig, init_train_state,
                                   make_train_step, param_leaves)

    t_path = time.perf_counter()
    opt = OptimizerConfig(peak_lr=1e-2, warmup_steps=1,
                          total_steps=GIN_TRAIN_STEPS)
    loss_fn = lambda p, b: gnn.loss_fn(p, b, cfg)  # noqa: E731
    state0 = init_train_state(gnn.init_params(cfg, seed=args.seed + 1,
                                              device="cuda"))
    leaves0 = param_leaves(state0["params"])

    # one step's gradients: kernel plan against the plain plan
    loss_k, _ = loss_fn(state0["params"], batch)
    g_kernel = dict(zip(leaves0, torch.autograd.grad(
        loss_k, list(leaves0.values()))))
    loss_p, g_plain = _plain_grads(torch, state0["params"], batch, cfg)
    grad_err = {k: float((g_kernel[k] - g_plain[k]).norm()
                         / g_plain[k].norm().clamp(min=1e-30))
                for k in g_kernel}
    worst = max(grad_err, key=grad_err.get)
    emit("gin_train_grads", loss_kernel_plan=float(loss_k.detach()),
         loss_plain_plan=loss_p, leaves=len(grad_err),
         max_rel_l2_err=grad_err[worst], worst_leaf=worst,
         rel_l2_rtol=GIN_GRAD_RTOL)
    if not grad_err[worst] <= GIN_GRAD_RTOL:
        die(f"gin_train: kernel-plan gradients differ from the plain "
            f"plan's: {worst} rel L2 {grad_err[worst]} > {GIN_GRAD_RTOL}")
    del loss_k, g_kernel, g_plain
    gc.collect()
    torch.cuda.empty_cache()

    # the run: GIN_TRAIN_STEPS steps, a checkpoint after GIN_CKPT_STEP
    ckpt_dir = tempfile.mkdtemp(prefix="gin_ckpt_")
    mgr = CheckpointManager(ckpt_dir, keep=1)

    counters = _launch_counters()
    state = copy.deepcopy(state0)
    norms, first = [], {}

    def save(i, st):
        if i == GIN_CKPT_STEP:
            mgr.save(i, train_state_tree(st))

    _reset(torch, counters)
    with _StepClock(torch) as clock:
        step = _grads_at_finish(make_train_step(clock.loss(loss_fn), opt),
                                lambda g: first.update(
                                    {k: v.float().clone()
                                     for k, v in g.items()}))
        real_finish = step.finish

        def finish(*a, **kw):  # the grad norms the steps take
            m = real_finish(*a, **kw)
            norms.append(float(m["grad_norm"]))
            return m

        step.finish = finish
        state, losses, times = _train_steps(
            torch, step, state, batch, GIN_TRAIN_STEPS, clock, save)
    launches = _read(torch, counters)
    peak = torch.cuda.max_memory_allocated()
    per_step = {k: launches[k] / GIN_TRAIN_STEPS for k in (
        "owner_sum", "owner_sum_backward", "vbyte_decode_blocked")}
    per_step["fused_decode/vbyte/adjacency_rebase"] = launches[
        "fused_decode_by"].get("vbyte/adjacency_rebase", 0) / GIN_TRAIN_STEPS
    ms = {k: [round(t[k], 3) for t in times] for k in times[0]}
    emit("gin_train", steps=GIN_TRAIN_STEPS, peak_lr=opt.peak_lr,
         warmup_steps=opt.warmup_steps, losses=losses, ms_per_step=ms,
         median_ms={k: float(np.median(v)) for k, v in ms.items()},
         peak_device_bytes=peak, launches=launches,
         launches_per_step=per_step)
    finite = bool(np.isfinite(losses).all())
    if not (finite and losses[-1] < losses[0]):
        die(f"gin_train: losses finite={finite}, first {losses[0]}, last "
            f"{losses[-1]}")
    if not (per_step["fused_decode/vbyte/adjacency_rebase"] >= 1
            and per_step["owner_sum"] >= cfg.n_layers
            and per_step["owner_sum_backward"] >= cfg.n_layers - 1):
        die(f"gin_train: a step did not launch kernel 2's adjacency_rebase "
            f"and owner_sum both ways: {per_step}")

    # a replay from the same initial state, and a restart from the
    # checkpoint into a fresh state: the same losses and state, bit for bit
    t0 = time.perf_counter()
    replay, r_losses, _ = _train_steps(
        torch, make_train_step(loss_fn, opt), copy.deepcopy(state0), batch,
        GIN_TRAIN_STEPS)
    replay_equal = r_losses == losses and _state_equal(torch, replay, state)
    del replay
    fresh = init_train_state(gnn.init_params(cfg, seed=args.seed + 2,
                                             device="cuda"))
    tree, at = mgr.restore_latest(train_state_tree(fresh))
    del fresh
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    resumed = gnn_train_state_from_tree(tree, cfg, device="cuda")
    resumed, c_losses, _ = _train_steps(
        torch, make_train_step(loss_fn, opt), resumed, batch,
        GIN_TRAIN_STEPS - at - 1)
    restart_equal = (at == GIN_CKPT_STEP and c_losses == losses[at + 1:]
                     and _state_equal(torch, resumed, state))
    emit("gin_train_replay", replay_equal=replay_equal,
         restart_from_step=at, restart_equal=restart_equal,
         restart_losses=c_losses, seconds=round(time.perf_counter() - t0, 3))
    if not (replay_equal and restart_equal):
        die(f"gin_train: replay equal {replay_equal} (losses {r_losses}), "
            f"restart from step {at} equal {restart_equal} (losses "
            f"{c_losses}; uninterrupted {losses})")
    del resumed, state, state0, leaves0
    gc.collect()
    torch.cuda.empty_cache()
    backward = gin_backward_kernel(np, torch, comp, nbr, own, cfg, args)
    seconds = time.perf_counter() - t_path
    emit("path_done", path="gin_train", seconds=round(seconds, 3))
    return {"launches": launches, "seconds": seconds, "peak": peak,
            "losses": losses, "ms": ms, "owner_sum_backward": backward,
            "grad_norms": norms, "first_grads": first, "opt": opt}


GIN_MESHES = ((4, 1), (2, 2))  # gin_mesh: every position a row position
GIN_MESH_STEPS = 2


def gin_mesh(np, torch, args, cfg, batch, train) -> dict:
    """Phase ``gin_mesh``: gin_train's first GIN_MESH_STEPS steps over each
    mesh of GIN_MESHES through ``jit_train_step`` with the ``ogb_products``
    cell's specs: the node rows and labels, the gap blocks and
    ``edge_valid`` split over every position (``("pod", "data",
    "model")``), each position's blocks decoded by one kernel 2
    ``adjacency_rebase`` launch a forward, ``h`` shared once a layer,
    ``owner_sum`` over each position's edges (an owner straddling two
    positions adds their partials in position order), both ways. The node
    count is padded to a multiple of the positions (rows with no edges,
    masked out of the loss: the same mean). Each step's loss, grad norm
    and gradients held as ``mesh_train`` holds them (``_train_held``,
    GIN_GRAD_RTOL) against one device from the same state: the first
    step's against gin_train's, a later one's against the single-device
    step on the state the mesh's previous step left (``_single_at``); the
    launches counted exactly (the single device's outside the count)."""
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.sharding import whole
    from repro_torch.models import gnn, registry
    from repro_torch.train import (init_train_state, jit_train_step,
                                   make_train_step)

    t_path = time.perf_counter()
    N = batch["feats"].shape[0]
    pad = -N % max(a * b for a, b in GIN_MESHES)
    padded = dict(batch)
    padded["feats"] = torch.cat([batch["feats"], batch["feats"].new_zeros(
        (pad, batch["feats"].shape[1]))])
    padded["labels"] = torch.cat([batch["labels"],
                                  batch["labels"].new_zeros(pad)])
    padded["label_mask"] = torch.arange(N + pad, device="cuda") < N
    ro = batch["row_offsets"]
    padded["row_offsets"] = torch.cat([ro, ro[-1:].expand(pad)])
    padded["row_gap_bases"] = torch.cat([
        batch["row_gap_bases"], batch["row_gap_bases"].new_zeros(pad)])
    opt = train["opt"]
    out = {"nodes_padded": N + pad, "steps": GIN_MESH_STEPS}
    counters = _launch_counters()
    launches_all = None
    for shape in GIN_MESHES:
        mesh = make_mesh(shape, ("data", "model"))
        cell = registry.build_cell("gin-tu", "ogb_products",
                                   mesh_dp=shape[0], opt_cfg=opt)
        seen = []

        def sample(g):
            return {k: whole(v).float() for k, v in g.items()}

        step = _grads_at_finish(jit_train_step(
            make_train_step(lambda p, b: gnn.loss_fn(p, b, cfg), opt),
            in_shardings=cell.in_shardings(mesh)),
            lambda g: seen.append(sample(g)), every=True)
        single = make_train_step(lambda p, b: gnn.loss_fn(p, b, cfg), opt)
        state = init_train_state(gnn.init_params(cfg, seed=args.seed + 1,
                                                 device="cuda"))
        losses, norms, ms, at, peak = [], [], [], [], 0
        _reset(torch, counters)
        off = _read(torch, counters)  # the single device's launches
        for i in range(GIN_MESH_STEPS):
            if i:  # the single device from this state, outside the count
                before = _read(torch, counters)
                at.append(_single_at(torch, single, state, batch, sample))
                off = _merge_launches(off, _delta(before, _read(torch,
                                                               counters)))
                torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step(state, padded)
            end.record()
            torch.cuda.synchronize()
            ms.append(round(start.elapsed_time(end), 3))
            peak = max(peak, torch.cuda.max_memory_allocated())
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        launches = _delta(off, _read(torch, counters))
        del state
        n = len(step.devices)
        want = {"adjacency_rebase": n * GIN_MESH_STEPS,
                "owner_sum": n * cfg.n_layers * GIN_MESH_STEPS,
                "owner_sum_backward": n * (cfg.n_layers - 1) * GIN_MESH_STEPS}
        got = {"adjacency_rebase": launches["fused_decode_by"].get(
                   "vbyte/adjacency_rebase", 0),
               "owner_sum": launches["owner_sum"],
               "owner_sum_backward": launches["owner_sum_backward"]}
        if got != want or launches["fused_decode"] != got[
                "adjacency_rebase"] or launches["vbyte_decode_blocked"]:
            die(f"gin_mesh over {shape}: launches {launches}, expected "
                f"{want}")
        want_losses = train["losses"][:1] + [a[0] for a in at]
        want_norms = train["grad_norms"][:1] + [a[1] for a in at]
        rel = _train_rel(losses, norms, want_losses, want_norms)
        g_rel = [_rel_l2(g, w) for g, w in zip(seen, [train["first_grads"]]
                                               + [a[2] for a in at])]
        worst = max(((t, k) for t, r in enumerate(g_rel) for k in r),
                    key=lambda tk: g_rel[tk[0]][tk[1]])
        g_worst = g_rel[worst[0]][worst[1]]
        rec = {"mesh": mesh.shape, "positions": n, "split": step.split,
               "losses": losses, "grad_norms": norms,
               "single_device_from_same_state": {"losses": want_losses,
                                                 "grad_norms": want_norms},
               "rel_to_single": rel,
               "grad_rel_l2_max": {"step": worst[0] + 1, "leaf": worst[1],
                                   "value": g_worst},
               "ms_per_step": ms,
               "single_device_ms_per_step": train["ms"].get("step", [])[
                   :GIN_MESH_STEPS],
               "peak_device_bytes": peak, "launches": launches}
        emit("gin_mesh", **rec)
        if not all(np.isfinite(losses + norms)) or not _train_held(rel) \
                or g_worst > GIN_GRAD_RTOL:
            die(f"gin_mesh over {shape}: losses {losses}, norms {norms}: "
                f"{rel}; step {worst[0] + 1}'s gradient {worst[1]} "
                f"{g_worst}")
        out[str(shape)] = rec
        launches_all = launches if launches_all is None else \
            _merge_launches(launches_all, launches)
        gc.collect()
        torch.cuda.empty_cache()
    del padded
    seconds = time.perf_counter() - t_path
    emit("path_done", path="gin_mesh", seconds=round(seconds, 3))
    return {"launches": launches_all, "seconds": seconds, **out}


def gin_backward_kernel(np, torch, comp, nbr, own, cfg, args) -> dict:
    """The backward owner_sum at the gin_train step's shape: float32
    gradients ``[N, d_hidden]`` summed over the edges grouped by source
    (``segments_by_source`` of the decoded edges), equal bit for bit to
    its plain version on the CPU over sampled rows (the top GIN_SAMPLE_TOP
    and GIN_SAMPLE_OTHERS more); and, with the roles of the groupings
    swapped (a sum over the source grouping whose backward runs over the
    in-degree grouping, rows past LONG_ROW), the same check; then the
    launch timed beside its bound, its plain version and cuSPARSE SpMM
    over the transposed CSR (f32)."""
    from repro_torch.kernels.segment_sum import (LONG_ROW, backward_launches,
                                                 owner_sum, owner_sum_plain,
                                                 segments, segments_by_source)

    timer = ColdTimer(torch)
    ro, valid = comp["row_offsets"], comp["edge_valid"]
    seg = segments(ro)
    N, E, d = comp["row_gap_bases"].numel(), nbr.numel(), cfg.d_hidden
    src_m = torch.where(valid, nbr, -1)
    tsrc, tseg = segments_by_source(nbr, own, N, valid)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    g = torch.randn(N, d, device="cuda", generator=gen)
    checks = {}
    for label, fwd, back in (
            ("by_source", (src_m, seg), (tsrc, tseg)),
            ("by_owner", (tsrc, tseg), (src_m, seg))):
        x = torch.zeros(N, d, device="cuda", requires_grad=True)
        before = backward_launches.count
        owner_sum(x, *fwd, by_source=back).backward(g)
        if backward_launches.count == before:
            die(f"gin_train: the {label} backward launched no kernel")
        b_src, b_seg = back
        b_ro = b_seg.row_offsets.cpu()
        rows, e_idx, sub_ro = _owner_sample(np, torch, b_ro, GIN_SAMPLE_TOP,
                                            GIN_SAMPLE_OTHERS, args.seed)
        want = owner_sum_plain(g.cpu(), b_src.cpu()[e_idx], sub_ro)
        got = x.grad[rows.to("cuda")].cpu()
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            die(f"gin_train: the backward kernel ({label}) differs from "
                f"its plain version on the sampled rows")
        deg = b_ro[1:] - b_ro[:-1]
        checks[label] = {"sampled_rows": int(rows.numel()),
                         "sampled_edges": int(e_idx.numel()),
                         "max_row_edges": int(deg.max()),
                         "rows_past_long_row": int((deg >= LONG_ROW).sum()),
                         "max_abs_err": 0}
        del x
    emit("parity_owner_sum_backward", **checks)
    n_valid = int(tseg.row_offsets[-1])
    bound, by, gathered = _gather_sum_bound(rows=N, n_owners=N, n_edges=E,
                                            n_valid=n_valid, d=d,
                                            in_bytes=4)
    spm = torch.sparse_csr_tensor(tseg.row_offsets, tsrc[:n_valid],
                                  torch.ones(n_valid, device="cuda"),
                                  size=(N, N))
    out = owner_sum(g, tsrc, tseg)
    lib_err = float((spm @ g - out).abs().max())
    rec = {"n_rows": N, "n_edges": E, "n_valid_edges": n_valid, "d": d,
           "grad_dtype": "float32", "accumulate": "float32",
           "max_abs_err": 0, "checks": checks,
           "ms": timer.ms(lambda: owner_sum(g, tsrc, tseg), reps=5),
           "plain_ms": timer.ms_sync(
               lambda: owner_sum_plain(g, tsrc, tseg.row_offsets), reps=2),
           "library_ms": timer.ms_sync(lambda: spm @ g, reps=5),
           "library": "cuSPARSE SpMM over the transposed CSR, f32",
           "library_max_abs_err": lib_err, "bound_ms": bound,
           "bound_by": by, "gathered_rows_bound_ms": gathered}
    emit("parity_owner_sum_backward", shape="layers2_5_grad",
         **{k: v for k, v in rec.items() if k != "checks"})
    del spm, out, g, tsrc, tseg, timer
    gc.collect()
    torch.cuda.empty_cache()
    return rec


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
        bound, by, gathered = _gather_sum_bound(
            rows=h.shape[0], n_owners=N, n_edges=E, n_valid=n_valid, d=d,
            in_bytes=h.element_size())
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
            "gathered_rows_bound_ms": gathered,
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
# path: recsys (SASRec, BERT4Rec, BST and two-tower at full width)
# ---------------------------------------------------------------------------
RECSYS_ARCHS = ("sasrec", "bert4rec", "bst", "two-tower-retrieval")
RECSYS_SERVE_CALLS = 20  # serve_p99 batches timed per architecture
RECSYS_RETRIEVAL_CALLS = 5  # retrieval_cand requests timed per architecture
RECSYS_TOP_K = 100
RECSYS_TRAIN_STEPS = 4
RECSYS_CKPT_STEP = 1  # a checkpoint after step 1: the restart runs 2 and 3
# AdamW's peak rate (warm-up 1), by kind: the reference's recsys test
# takes 5e-3, and so does the smoke, but for BST. At BST's full widths
# (its 672-1024-512-256 MLP) Adam's first step at 5e-3 makes the loss jump
# before it falls, in the reference as in the port
# (tests/test_torch_recsys_train.py::test_bst_full_width_rate, on the CPU
# at 8,192 rows), and on the H100 at 65,536 rows the loss after 4 steps
# stood above the first (5e-3: 0.701 -> 15.754 -> 2.031 -> 0.736; 1e-3:
# 0.701 -> 1.332 -> 0.815 -> 0.707), so BST trains at 1e-4
RECSYS_PEAK_LR = {"sasrec": 5e-3, "bert4rec": 5e-3, "bst": 1e-4,
                  "two_tower": 5e-3}
RECSYS_GRAD_RTOL = 2.0**-4  # relative L2 a leaf: the GIN train bound
RECSYS_SERVE_RTOL = 2.0**-5  # SDPA vs plain attention, of max |score|
RECSYS_PLAIN_ROWS = 4096  # batch rows the plain attention takes at once
TT_GRAD_ROWS = 8192  # two-tower: rows of its chunked-vs-whole gradients


def _fingerprint(torch, state) -> str:
    """A digest of every bit of a train state, taken on the card: per leaf
    (the reference's paths and order), its dtype, shape, and the int64 sums
    of its words and of its words times a position weight (wrapping)."""
    from repro_torch.convert import train_state_tree
    from repro_torch.tree import flatten

    h = hashlib.sha256()
    for k, x in flatten(train_state_tree(state)):
        w = x.detach().reshape(-1)
        w = w.view(torch.int32 if w.element_size() == 4 else torch.int16)
        s1 = s2 = 0
        for a in range(0, w.numel(), 1 << 26):
            c = w[a:a + (1 << 26)].to(torch.int64)
            pos = torch.arange(a, a + c.numel(), device=c.device) % 1000003 + 1
            s1 += int(c.sum())
            s2 += int((c * pos).sum())
        h.update(f"{k}:{x.dtype}:{tuple(x.shape)}:{s1}:{s2};".encode())
    return h.hexdigest()


@contextlib.contextmanager
def _plain_attention(torch):
    """The models' attention through its plain chunked version on the card,
    RECSYS_PLAIN_ROWS batch rows at a time, each part recomputed in the
    backward pass (``torch.utils.checkpoint``): its float32 scores of
    BERT4Rec's 65,536 rows would take 21 GB a block at once."""
    from torch.utils.checkpoint import checkpoint

    from repro_torch.models import recsys
    from repro_torch.nn import attention

    real = attention.flash_attention

    def plain(q, k, v, **kw):
        n = RECSYS_PLAIN_ROWS
        if not torch.is_grad_enabled():
            return real(q, k, v, **kw)
        return torch.cat([checkpoint(lambda a, b, c: real(a, b, c, **kw),
                                     q[s:s + n], k[s:s + n], v[s:s + n],
                                     use_reentrant=False)
                          for s in range(0, q.shape[0], n)])

    recsys.attn.flash_attention = plain
    try:
        with attention.plan("plain"):
            yield
    finally:
        recsys.attn.flash_attention = real


@contextlib.contextmanager
def _deterministic(torch):
    """Deterministic algorithms (the embedding gradients' ``index_put_``
    sorts its rows instead of adding by atomics; the SDPA backward takes
    its deterministic path), without filling fresh memory."""
    import torch.utils.deterministic as td

    fill = td.fill_uninitialized_memory
    torch.use_deterministic_algorithms(True)
    td.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)
        td.fill_uninitialized_memory = fill


def _grads(torch, params, batch, loss_fn) -> tuple[float, dict]:
    from repro_torch.train import param_leaves

    leaves = param_leaves(params)
    loss, _ = loss_fn(params, batch)
    return float(loss.detach()), dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


def _rel_l2(a: dict, b: dict) -> dict:
    return {k: float((a[k].float() - b[k].float()).norm()
                     / b[k].float().norm().clamp(min=1e-30)) for k in a}


def _backends(torch, cfg) -> dict:
    """The SDPA backend PyTorch picks for the model's attention: at
    serve_p99 (inference) and for a train step (with grad, under
    deterministic algorithms)."""
    from repro_torch.nn import attention

    if cfg.kind == "two_tower":
        return {"serve": None, "train": None}
    L = cfg.seq_len + (1 if cfg.kind == "bst" else 0)
    H, dh = cfg.n_heads, cfg.embed_dim // cfg.n_heads
    out = {}
    for part, grad in (("serve", False), ("train", True)):
        q, k, v = (torch.randn(512, L, H, dh, device="cuda",
                               dtype=torch.bfloat16).requires_grad_(grad)
                   for _ in range(3))
        with _deterministic(torch) if grad else contextlib.nullcontext():
            out[part] = attention.sdpa_backend(q, k, v,
                                               causal=cfg.kind == "sasrec")
    return out


def recsys_serve(np, torch, cfg, params, rng) -> dict:
    """serve_p99 (512 rows) through ``serve_scores``: RECSYS_SERVE_CALLS
    timed calls, then the plain attention's scores on the same batch."""
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.models import recsys, registry

    batch = registry.recsys_batch_for(cfg, RECSYS_SHAPES["serve_p99"], rng,
                                      device="cuda")
    ms = []
    with torch.inference_mode():
        out = recsys.serve_scores(params, batch, cfg)
        torch.cuda.synchronize()
        for _ in range(RECSYS_SERVE_CALLS):
            t0 = time.perf_counter()
            out = recsys.serve_scores(params, batch, cfg)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        with _plain_attention(torch):
            plain = recsys.serve_scores(params, batch, cfg)
    finite = bool(torch.isfinite(out).all())
    rel = float((out - plain).abs().max() / plain.abs().max())
    ok = finite and (torch.equal(out, plain) if cfg.kind == "two_tower"
                     else rel <= RECSYS_SERVE_RTOL)
    rec = {"batch": int(batch["hist"].shape[0]),
           "scores_shape": list(out.shape), "calls": len(ms),
           "p50_ms": float(np.percentile(ms, 50)),
           "p99_ms": float(np.percentile(ms, 99)),
           "max_err_of_max_score": rel, "rtol": RECSYS_SERVE_RTOL,
           "finite": finite}
    if not ok:
        die(f"recsys {cfg.name} serve: scores against the plain attention's "
            f"{rec}")
    return rec


def recsys_retrieval(np, torch, cfg, params, rng, counters) -> dict:
    """retrieval_cand: 2^20 distinct sorted ids of the table's rows (vbyte,
    differential, block 128, stride 256) scored for one history through
    ``retrieval_scores_compressed``, against ``plan="torch"``."""
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.kernels.vbyte_decode import dispatch
    from repro_torch.models import recsys, registry

    shape = RECSYS_SHAPES["retrieval_cand"]
    batch = registry.recsys_batch_for(cfg, shape, rng, device="cuda")
    arr = batch["cands"]
    if arr.n != shape.dims["n_candidates"] or arr.stride != \
            shape.dims["payload_stride"]:
        die(f"recsys {cfg.name} retrieval data: {arr.n} ids, stride "
            f"{arr.stride}")
    dot = cfg.kind in ("sasrec", "bert4rec")

    def run(plan="auto"):
        return recsys.retrieval_scores_compressed(
            params, batch, cfg, top_k=RECSYS_TOP_K, plan=plan)

    real, seen = dispatch.decode, []

    def decode(*a, **kw):  # keeps what the request decoded: no launch more
        out = real(*a, **kw)
        seen.append(out)
        return out

    with torch.inference_mode():
        run()
        before = _read(torch, counters)
        dispatch.decode = decode
        try:
            scores, (top_s, top_i) = run()
        finally:
            dispatch.decode = real
        after = _read(torch, counters)
        ms = []
        for _ in range(RECSYS_RETRIEVAL_CALLS):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        share = _profile(torch, f"recsys_retrieval/{cfg.name}", run, 1,
                         unit="requests")
        p_scores, (p_top_s, p_top_i) = run("torch")
        h = recsys._seq_repr(params, batch["hist"], cfg,
                             causal=cfg.kind == "sasrec",
                             dtype=torch.bfloat16)[:, -1] if dot else None
        table = params.item_emb.to(torch.bfloat16) if dot else None
        ids = seen[0][0] if dot else seen[0]
        p_ids = (dispatch.decode(arr, epilogue="dot_score", plan="torch",
                                 epilogue_operands={"table": table,
                                                    "query": h})[0]
                 if dot else dispatch.decode(arr, plan="torch"))
    per_request = {k: after[k] - before[k] for k in counters}
    per_request["fused_decode_by"] = {
        k: v - before["fused_decode_by"].get(k, 0)
        for k, v in after["fused_decode_by"].items()
        if v - before["fused_decode_by"].get(k, 0)}
    want = ({"vbyte/dot_score": 1} if dot else {})
    if per_request["fused_decode_by"] != want or per_request[
            "vbyte_decode_blocked"] != (0 if dot else 1):
        die(f"recsys {cfg.name} retrieval: launches per request "
            f"{per_request}")
    # ids bit for bit; scores within one bf16 ulp or the f32 sums'
    # rounding bound (dot_score), equal bit for bit (the towers: the same
    # ops on the same decoded ids)
    if len(seen) != 1 or not torch.equal(ids, p_ids) or \
            scores.shape != p_scores.shape:
        die(f"recsys {cfg.name} retrieval: ids differ from the torch plan's "
            f"({len(seen)} decodes; shapes {scores.shape} {p_scores.shape})")
    if dot:
        s_abs = dispatch.decode(
            arr, epilogue="dot_score", plan="torch",
            epilogue_operands={"table": table.abs(),
                               "query": h.abs()})[1].reshape(-1)
        ok, err, ulps, _ = _float_close(torch, scores, p_scores, bf16=True,
                                        terms=cfg.embed_dim, s_abs=s_abs)
        scores_equal = bool(torch.equal(scores, p_scores))
    else:
        scores_equal = ok = bool(torch.equal(scores, p_scores))
        err, ulps = float((scores - p_scores).abs().max()), 0
    if not ok:
        die(f"recsys {cfg.name} retrieval: scores beyond the stated "
            f"tolerance of the torch plan (max abs err {err}, {ulps} ulps)")
    swapped = _topk_agree(torch, top_s[None], top_i[None], p_top_s[None],
                          p_top_i[None], f"recsys {cfg.name} top-100")
    top_equal = bool(torch.equal(top_i, p_top_i)
                     and torch.equal(top_s, p_top_s))
    if not set(top_i.tolist()) <= set(ids.reshape(-1).tolist()):
        die(f"recsys {cfg.name} retrieval: a top id is not a candidate")
    return {"n_candidates": arr.n, "n_blocks": arr.n_blocks,
            "stride": arr.stride, "bits_per_int": round(arr.bits_per_int, 4),
            "ms_per_request": float(np.median(ms)), "ms": ms,
            "launches_per_request": per_request, "max_abs_err": err,
            "max_bf16_ulps": ulps, "scores_equal": scores_equal,
            "top100_equal": top_equal, "top100_near_tie_swaps": swapped,
            "finite": bool(torch.isfinite(scores).all()),
            "busy_share": share}


def recsys_train(np, torch, cfg, args) -> dict:
    """train_batch (65,536 rows, the batch kept whole: no microbatches):
    one step's gradients against the plain attention's (two-tower: its
    chunked loss against the whole one at TT_GRAD_ROWS rows); then
    RECSYS_TRAIN_STEPS steps of ``make_train_step`` on one batch (AdamW,
    warm-up 1), ms per step by forward / backward / AdamW and peak bytes; a
    replay from a fresh init of the same seed, and (not two-tower: its
    state is ~34 GB) a restart from the checkpoint after RECSYS_CKPT_STEP
    into a fresh state of another seed: losses and state bit for bit."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.convert import (recsys_train_state_from_tree,
                                     train_state_tree)
    from repro_torch.models import recsys, registry
    from repro_torch.train import (OptimizerConfig, init_train_state,
                                   make_train_step)

    shape = RECSYS_SHAPES["train_batch"]
    B = shape.dims["batch"]
    t0 = time.perf_counter()
    batch = registry.recsys_batch_for(cfg, shape, np.random.default_rng(
        args.seed + 3), device="cuda")
    t_batch = time.perf_counter() - t0
    opts = recsys.train_options(cfg, B)  # what loss_fn picks at B rows
    loss_fn = lambda p, b: recsys.loss_fn(p, b, cfg)  # noqa: E731
    opt = OptimizerConfig(peak_lr=RECSYS_PEAK_LR[cfg.kind],
                          warmup_steps=1, total_steps=RECSYS_TRAIN_STEPS)

    def fresh(seed):
        return init_train_state(recsys.init_params(cfg, seed=seed,
                                                   device="cuda"))

    with _deterministic(torch):
        state = fresh(args.seed)
        # one step's gradients against the plain version's
        if cfg.kind == "two_tower":
            sub = {k: v[:TT_GRAD_ROWS] for k, v in batch.items()}
            chunk = opts["loss_chunk"]  # the train step's: 2 chunks here

            def tt_loss(c):
                return lambda p, b: recsys._two_tower_loss(
                    p, b, cfg, torch.bfloat16, c)

            loss_k, g_k = _grads(torch, state["params"], sub, tt_loss(chunk))
            loss_p, g_p = _grads(torch, state["params"], sub, tt_loss(None))
            against = (f"the whole in-batch loss at {TT_GRAD_ROWS} rows "
                       f"(chunk {chunk})")
        else:
            loss_k, g_k = _grads(torch, state["params"], batch, loss_fn)
            with _plain_attention(torch):
                loss_p, g_p = _grads(torch, state["params"], batch, loss_fn)
            against = "the plain chunked attention"
        err = _rel_l2(g_k, g_p)
        worst = max(err, key=err.get)
        grads = {"loss": loss_k, "loss_plain": loss_p, "against": against,
                 "leaves": len(err), "max_rel_l2_err": err[worst],
                 "worst_leaf": worst, "rel_l2_rtol": RECSYS_GRAD_RTOL}
        del g_k, g_p
        if not err[worst] <= RECSYS_GRAD_RTOL:
            die(f"recsys {cfg.name} train: gradients against {against}: "
                f"{worst} rel L2 {err[worst]} > {RECSYS_GRAD_RTOL}")
        gc.collect()
        torch.cuda.empty_cache()

        ckpt = cfg.kind != "two_tower"
        ckpt_dir = tempfile.mkdtemp(prefix="recsys_ckpt_")
        mgr = CheckpointManager(ckpt_dir, keep=1)

        def save(i, st):
            if ckpt and i == RECSYS_CKPT_STEP:
                mgr.save(i, train_state_tree(st))

        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _StepClock(torch) as clock:
            state, losses, times = _train_steps(
                torch, make_train_step(clock.loss(loss_fn), opt), state,
                batch, RECSYS_TRAIN_STEPS, clock, save)
        peak = torch.cuda.max_memory_allocated()
        finite = bool(np.isfinite(losses).all())
        if not (finite and losses[-1] < losses[0]):
            die(f"recsys {cfg.name} train: losses finite={finite}, "
                f"{losses}")
        fp = _fingerprint(torch, state)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        step_fn = make_train_step(loss_fn, opt)
        replay, r_losses, _ = _train_steps(torch, step_fn, fresh(args.seed),
                                           batch, RECSYS_TRAIN_STEPS)
        replay_equal = r_losses == losses and _fingerprint(torch, replay) == fp
        t_replay = time.perf_counter() - t0
        # one more step of the replayed run, traced: where a step's time goes
        share = _profile(torch, f"recsys_train/{cfg.name}",
                         lambda: step_fn(replay, batch), 1, unit="steps")
        del replay
        gc.collect()
        torch.cuda.empty_cache()
        restart = None
        if ckpt:
            tree, at = mgr.restore_latest(train_state_tree(
                fresh(args.seed + 1)))
            resumed = recsys_train_state_from_tree(tree, cfg, device="cuda")
            del tree
            resumed, c_losses, _ = _train_steps(
                torch, make_train_step(loss_fn, opt), resumed, batch,
                RECSYS_TRAIN_STEPS - at - 1)
            restart = {"from_step": at, "losses": c_losses,
                       "equal": (at == RECSYS_CKPT_STEP
                                 and c_losses == losses[at + 1:]
                                 and _fingerprint(torch, resumed) == fp)}
            del resumed
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    if not replay_equal or (restart is not None and not restart["equal"]):
        die(f"recsys {cfg.name} train: replay equal {replay_equal} "
            f"(losses {r_losses}; uninterrupted {losses}), restart "
            f"{restart}")
    ms = {k: [round(t[k], 3) for t in times] for k in times[0]}
    return {"batch": B, "options": opts, "batch_seconds": round(t_batch, 3),
            "grads": grads, "steps": RECSYS_TRAIN_STEPS,
            "peak_lr": opt.peak_lr, "losses": losses, "ms_per_step": ms,
            "median_ms": {k: float(np.median(v)) for k, v in ms.items()},
            "peak_device_bytes": peak, "replay_equal": replay_equal,
            "restart": restart, "replay_seconds": round(t_replay, 3),
            "busy_share": share}


def run_recsys(np, torch, args) -> dict:
    """Path ``recsys``: SASRec, BERT4Rec, BST and two-tower at full width
    (their configs, parameters from ``--seed``): serve_p99 through
    ``serve_scores``, retrieval_cand through
    ``retrieval_scores_compressed`` (kernel 2's ``dot_score``, or kernel 1
    then the towers), train_batch through ``make_train_step``. Every
    launch count is set to 0 just before the path and read just after."""
    from repro_torch.models import recsys, registry

    t_path = time.perf_counter()
    counters = _launch_counters()
    _reset(torch, counters)
    out = {}
    for arch in RECSYS_ARCHS:
        t_arch = time.perf_counter()
        cfg = registry.resolve_config(arch, "train_batch")
        rng = np.random.default_rng(args.seed)
        params = recsys.init_params(cfg, seed=args.seed, device="cuda")
        backends = _backends(torch, cfg)
        serve = recsys_serve(np, torch, cfg, params, rng)
        emit("recsys_serve", arch=arch, sdpa_backend=backends["serve"],
             **serve)
        retrieval = recsys_retrieval(np, torch, cfg, params, rng, counters)
        emit("recsys_retrieval", arch=arch, **retrieval)
        del params
        gc.collect()
        torch.cuda.empty_cache()
        train = recsys_train(np, torch, cfg, args)
        emit("recsys_train", arch=arch, sdpa_backend=backends["train"],
             **train)
        out[arch] = {"sdpa_backend": backends, "serve": serve,
                     "retrieval": retrieval, "train": train,
                     "seconds": round(time.perf_counter() - t_arch, 3)}
        emit("recsys_arch_done", arch=arch, seconds=out[arch]["seconds"])
    launches = _read(torch, counters)
    seconds = time.perf_counter() - t_path
    emit("path_done", path="recsys", seconds=round(seconds, 3),
         launches=launches)
    return {"launches": launches, "seconds": seconds, "archs": out}


# ---------------------------------------------------------------------------
# path lm: the token pipeline, LM serving and LM training at full width
# ---------------------------------------------------------------------------
LM_VOCAB = 32_000  # the pipeline's token ids (h2o-danube's vocabulary)
LM_PIPE_ROWS, LM_PIPE_SEQ = 8, 4096  # tokens a step: 8 × 4,097
LM_PIPE_STEPS = 4
# prompts of each served config: h2o-danube at twice its window (the ring
# wraps; prefill_chunked takes its swa_local path), olmoe at 2,048
LM_SERVE = {"h2o-danube-1.8b": {"batch": 4, "prompt": 8192, "chunk": 4096},
            "olmoe-1b-7b": {"batch": 4, "prompt": 2048, "chunk": None}}
LM_DECODE_STEPS = 32  # greedy decode steps timed
LM_COPY_STEPS = 8  # decode steps timed with the cache copied each step
LM_CHECK_STEPS = 4  # decode positions S..S+3 held against a forward
LM_FORWARD_EXTRA = 16  # ... over S+16 tokens (a multiple of 16 wide)
LM_MOE_CHECK_PROMPT = 256  # an MoE config's check prompt (no drops)
LM_SERVE_RTOL = 2.0**-5  # of the largest |logit| (the recsys serve bound)
LM_TRAIN_ARCH = "h2o-danube-1.8b"
LM_TRAIN_STEPS = 4
LM_CKPT_STEP = 1  # a checkpoint after the 2nd step: the restart runs 3, 4
LM_RESTART_LAYERS = 2  # the restart's depth (full widths)
LM_PEAK_LR = 3e-4  # the train launcher's default
LM_GRAD_RTOL = 2.0**-4  # relative L2 a leaf: the GIN and recsys train bound


def _on_card(what: str, *tensors) -> None:
    """No fallback that hides the card: every tensor of the path is on it."""
    for t in tensors:
        if t.device.type != "cuda":
            die(f"lm {what}: a tensor of the path is on {t.device}")


def _max_rel(torch, a, b) -> float:
    """max |a − b| over max |b|."""
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


@contextlib.contextmanager
def _drop_recorder():
    """Every ``moe_apply``'s ``moe_drop_frac`` while the block runs, in
    call order (one a layer a call)."""
    from repro_torch.models import lm

    real, seen = lm.moe_lib.moe_apply, []

    def recorded(*a, **kw):
        out, aux = real(*a, **kw)
        seen.append(aux["moe_drop_frac"])
        return out, aux

    lm.moe_lib.moe_apply = recorded
    try:
        yield seen
    finally:
        lm.moe_lib.moe_apply = real


def _mean_drop(seen) -> float | None:
    return float(sum(float(x) for x in seen) / len(seen)) if seen else None


def lm_pipeline(np, torch, args):
    """A ``token_stream`` at vocab 32,000 through
    ``CompressedTokenPipeline(plan="auto")`` at 8 × 4,097 tokens a step:
    every step's batch bit for bit against ``plan="torch"`` and the raw
    stream, one kernel 1 launch a step. Returns (record, pipeline)."""
    from repro_torch.data.pipeline import CompressedTokenPipeline
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels.vbyte_decode import kernel

    B, S = LM_PIPE_ROWS, LM_PIPE_SEQ
    n = B * (S + 1)
    toks = token_stream(np.random.default_rng(args.seed + 5),
                        n * LM_PIPE_STEPS, LM_VOCAB)
    pipe = CompressedTokenPipeline(toks, B, S, device="cuda")
    plain = CompressedTokenPipeline(toks, B, S, plan="torch", device="cuda")
    raw = torch.as_tensor(toks.astype(np.int32), device="cuda")
    ms, launches = [], []
    for step in range(LM_PIPE_STEPS):
        before = kernel.launches.count
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = pipe.get_batch(step)["tokens"]
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(kernel.launches.count - before)
        _on_card("pipeline", got)
        want = plain.get_batch(step)["tokens"]
        if not (torch.equal(got, want) and torch.equal(
                got.reshape(-1), raw[step * n:(step + 1) * n])):
            die(f"lm pipeline step {step}: batch differs from plan='torch' "
                "or the raw stream")
    if launches != [1] * LM_PIPE_STEPS:
        die(f"lm pipeline: kernel 1 launches per step {launches}, not 1")
    return {"batch": [B, S + 1], "steps": LM_PIPE_STEPS, "vocab": LM_VOCAB,
            "compression_ratio": pipe.compression_ratio(),
            "bits_per_int": pipe.shard(0).bits_per_int,
            "get_batch_ms": ms, "kernel1_launches_per_step": launches,
            "batches_equal": True}, pipe


def parity_lm_pipeline(np, torch, pipe) -> dict:
    """Kernel 1 alone on the pipeline's first shard (257 blocks, not
    differential), held bit for bit against its plain version and timed
    (L2 cold) beside it and its bound; the kernels line's
    ``lm_pipeline``. Outside the path's counted window."""
    from repro_torch.kernels.vbyte_decode import epilogues, kernel

    arr = pipe.shard(0)
    ops = arr.device_operands()
    kw = dict(block_size=arr.block_size, differential=False)
    leaves = (ops["payload"], ops["counts"], ops["bases"])
    plain = epilogues.PLAIN_DECODERS["vbyte"]
    out = kernel.vbyte_decode_blocked_cuda(*leaves, **kw)
    ref = plain(*leaves, **kw)
    err = _max_err(out, ref)
    if err or not torch.equal(out, ref):
        die(f"lm pipeline: kernel 1 differs from its plain version ({err})")
    st = decode_stats("vbyte", ops, arr.payload_bytes, arr.n)
    timer = ColdTimer(torch)
    k_ms = timer.ms(lambda: kernel.vbyte_decode_blocked_cuda(*leaves, **kw),
                    reps=20)
    p_ms = timer.ms(lambda: plain(*leaves, **kw), reps=5)
    del timer
    return {**st, "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "gints_per_s": st["n_ints"] / k_ms / 1e6,
            "plain_gints_per_s": st["n_ints"] / p_ms / 1e6}


def _serve_logits(torch, lm, params, cfg, tokens, positions, dtype):
    """A forward over ``tokens`` and the head at ``positions`` in
    ``dtype``: float32 logits ``[B, len(positions), V]``."""
    from repro_torch.nn import layers as nnl

    hidden, _, _ = lm.forward(params, tokens, cfg, dtype=dtype)
    return nnl.dense(params.lm_head, hidden[:, positions],
                     dtype=dtype).float()


def lm_serve(np, torch, arch: str, args) -> dict:
    """One LM config unchanged, parameters from ``--seed``, under
    ``torch.inference_mode()``: ``prefill`` of the prompts,
    ``prefill_chunked`` (where a chunk is set), decode logits at S..S+3
    against a forward over the longer sequence, LM_DECODE_STEPS greedy
    ``decode_step``s (and LM_COPY_STEPS with the cache copied before each,
    the functional update's cost), and the plain attention's prefill and
    decode against the default's."""
    import copy

    from repro_torch.models import lm, registry
    from repro_torch.nn import attention

    spec = LM_SERVE[arch]
    B, S, chunk = spec["batch"], spec["prompt"], spec["chunk"]
    cfg = registry.resolve_config(arch, "prefill_32k")
    rng = np.random.default_rng(args.seed + 7)
    prompt = torch.as_tensor(rng.integers(
        0, cfg.vocab, (B, S + LM_FORWARD_EXTRA)).astype(np.int32),
        device="cuda")
    t0 = time.perf_counter()
    params = lm.init_params(cfg, seed=args.seed, device="cuda")
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    _on_card(f"{arch} params", *params.parameters())
    rec = {"arch": arch, "batch": B, "prompt": S,
           "params": cfg.param_count(), "init_seconds": round(t_init, 3)}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    def fresh(cache):
        return {"k": cache["k"].clone(), "v": cache["v"].clone(),
                "index": cache["index"]}

    def hold(what, err):
        rec.setdefault("held", {})[what] = err
        if not err <= LM_SERVE_RTOL:
            die(f"lm {arch} serve: {what} {err} > {LM_SERVE_RTOL} of the "
                "largest value")

    # room for every decoded token (a full cache clamps the write to its
    # last slot); a window's ring holds `window` slots whatever the room
    cap = S + max(LM_DECODE_STEPS, LM_COPY_STEPS, LM_CHECK_STEPS)
    with torch.inference_mode():
        head = prompt[:, :S]
        # warm-up: one call at the prompt's shape (cuBLAS and SDPA plans:
        # cuDNN builds a graph per shape on its first call)
        (_, _), t_first = timed(lambda: lm.prefill(params, head, cfg,
                                                   cache_capacity=cap))
        rec["prefill_first_call_seconds"] = t_first
        torch.cuda.reset_peak_memory_stats()
        with _drop_recorder() as drops:
            (logits, cache), t_pre = timed(lambda: lm.prefill(
                params, head, cfg, cache_capacity=cap))
        _on_card(f"{arch} prefill", logits, cache["k"], cache["v"])
        rec.update(prefill_seconds=t_pre,
                   prefill_tokens_per_s=B * S / t_pre,
                   prefill_peak_bytes=torch.cuda.max_memory_allocated(),
                   cache_shape=list(cache["k"].shape),
                   moe_drop_frac_prefill=_mean_drop(drops))
        if chunk:  # (a window: its cache is the ring either way)
            run_chunked = lambda: lm.prefill_chunked(  # noqa: E731
                params, head, cfg, chunk=chunk)
            rec["prefill_chunked_first_call_seconds"] = timed(run_chunked)[1]
            (logits_c, cache_c), t_c = timed(run_chunked)
            rec["prefill_chunked_seconds"] = t_c
            hold("prefill_chunked logits", _max_rel(torch, logits_c, logits))
            for part in ("k", "v"):
                hold(f"prefill_chunked cache {part}",
                     _max_rel(torch, cache_c[part], cache[part]))
            if cache_c["index"] != cache["index"]:
                die(f"lm {arch}: chunked index {cache_c['index']}")
            del logits_c, cache_c
        # greedy decode, timed: the cache updated in place
        c = fresh(cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        lm.decode_step(params, fresh(cache), tok, cfg)  # warm-up
        torch.cuda.synchronize()
        out = []
        with _drop_recorder() as drops:
            t0 = time.perf_counter()
            for _ in range(LM_DECODE_STEPS):
                out.append(tok)
                lg, c = lm.decode_step(params, c, tok, cfg)
                tok = torch.argmax(lg, -1).to(torch.int32)
            torch.cuda.synchronize()
            t_dec = time.perf_counter() - t0
        _on_card(f"{arch} decode", lg, c["k"], tok)
        if c["index"] != S + LM_DECODE_STEPS or not bool(
                torch.isfinite(lg).all()):
            die(f"lm {arch} decode: index {c['index']}, finite "
                f"{bool(torch.isfinite(lg).all())}")
        rec.update(decode_steps=LM_DECODE_STEPS,
                   decode_ms_per_token=t_dec / LM_DECODE_STEPS * 1e3,
                   decode_tokens_per_s=B * LM_DECODE_STEPS / t_dec,
                   moe_drop_frac_decode=_mean_drop(drops),
                   sample=torch.stack(out, 1)[0, :8].tolist())
        c2 = fresh(c)
        rec["decode_busy_share"] = _profile(
            torch, f"lm_decode/{arch}",
            lambda: lm.decode_step(params, c2, tok, cfg), 1, unit="tokens")
        del c2
        # the same steps with the whole cache copied before each (what the
        # reference's functional update costs: a copy per layer per token)
        c = fresh(cache)
        tok = out[0]
        t0 = time.perf_counter()
        for _ in range(LM_COPY_STEPS):
            c = fresh(c)
            lg, c = lm.decode_step(params, c, tok, cfg)
            tok = torch.argmax(lg, -1).to(torch.int32)
        torch.cuda.synchronize()
        rec["decode_ms_per_token_copying_cache"] = (
            (time.perf_counter() - t0) / LM_COPY_STEPS * 1e3)
        rec["serve_peak_bytes"] = torch.cuda.max_memory_allocated()
        # the held checks: the plain attention's prefill and decode steps
        # against the default's, and the default's decode logits at
        # Sc..Sc+3 against a forward over Sc+16 tokens. A dense config runs
        # them as served: bf16, the whole prompts. An MoE config's router
        # turns the smallest differences into other experts for a few
        # tokens, and with capacity drops into other dropped rows (at
        # decode's 4 tokens C = 1); it runs them with capacity factor E / K
        # (every token fits: no call drops), at float32, on the prompts'
        # first LM_MOE_CHECK_PROMPT tokens, and the unchanged config's bf16
        # reading over the whole prompts is reported beside them
        if cfg.moe:
            ccfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k))
            Sc, dt = LM_MOE_CHECK_PROMPT, torch.float32
            lg_d, c_d = lm.prefill(params, head[:, :Sc], ccfg,
                                   cache_capacity=cap, dtype=dt)
            rec["checks_at"] = {"capacity_factor": ccfg.moe.capacity_factor,
                                "prompt": Sc, "dtype": "float32"}
        else:
            ccfg, Sc, dt = cfg, S, torch.bfloat16
            lg_d, c_d = logits, fresh(cache)
            rec["checks_at"] = {"prompt": S, "dtype": "bf16"}
        with attention.plan("plain"):
            (lg_p, c_p), t_plain = timed(lambda: lm.prefill(
                params, head[:, :Sc], ccfg, cache_capacity=cap, dtype=dt))
        hold("plain-plan prefill logits", _max_rel(torch, lg_d, lg_p))
        dec = []
        for i in range(LM_CHECK_STEPS):
            tok = prompt[:, Sc + i]
            lg, c_d = lm.decode_step(params, c_d, tok, ccfg, dtype=dt)
            with attention.plan("plain"):
                lg_p, c_p = lm.decode_step(params, c_p, tok, ccfg, dtype=dt)
            hold(f"plain-plan decode {i} logits", _max_rel(torch, lg, lg_p))
            dec.append(lg)
        want = _serve_logits(torch, lm, params, ccfg,
                             prompt[:, :Sc + LM_FORWARD_EXTRA],
                             list(range(Sc, Sc + LM_CHECK_STEPS)), dt)
        hold("decode vs forward logits", _max_rel(torch, torch.stack(dec, 1),
                                                  want))
        del lg_d, c_d, lg_p, c_p, dec, want
        if cfg.moe:
            with attention.plan("plain"):
                (lg_p, _), t_plain = timed(lambda: lm.prefill(
                    params, head, cfg, cache_capacity=cap))
            rec["unheld_bf16_plain_vs_default_prefill"] = _max_rel(
                torch, logits, lg_p)
            del lg_p
        rec["plain_prefill_seconds"] = t_plain
        # the SDPA backend of the prefill's attention
        q = torch.empty(B, S, cfg.n_heads, cfg.dh, device="cuda",
                        dtype=torch.bfloat16)
        kv = torch.empty(B, S, cfg.n_kv_heads, cfg.dh, device="cuda",
                         dtype=torch.bfloat16)
        bites = attention._window_bites(q, kv, causal=True, window=cfg.window)
        mask = (attention.attention_mask(S, S, causal=True, window=cfg.window,
                                         device="cuda") if bites else None)
        rec["sdpa_backend_prefill"] = attention.sdpa_backend(
            q, kv, kv, causal=True, mask=mask)
        rec["prefill_attention_masked"] = bites
    del params, cache, logits, q, kv, mask, out
    gc.collect()
    torch.cuda.empty_cache()
    return rec


class _LMStepClock:
    """CUDA events around each microbatch's loss (forward) and around
    AdamW, for the clock's lifetime: a step's forward is the sum of its
    losses' spans, its backward the rest before AdamW (gradients of each
    microbatch and their sum), AdamW its own span."""

    def __init__(self, torch):
        from repro_torch.train import train_state

        self.torch, self.ts = torch, train_state
        self.real = train_state.adamw_update
        self.ev = []

    def mark(self, name):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        self.ev.append((name, e))

    def loss(self, fn):
        def timed(*a, **kw):
            self.mark("fwd_start")
            out = fn(*a, **kw)
            self.mark("fwd_end")
            return out
        return timed

    def __enter__(self):
        def timed_adamw(*a, **kw):
            self.mark("opt_start")
            out = self.real(*a, **kw)
            self.mark("end")
            return out

        self.ts.adamw_update = timed_adamw
        return self

    def __exit__(self, *exc):
        self.ts.adamw_update = self.real
        return False

    def step_ms(self) -> dict:
        self.torch.cuda.synchronize()
        ev, out = self.ev, {"forward": 0.0, "backward": 0.0}
        for (a, ea), (b, eb) in zip(ev, ev[1:]):
            if a == "fwd_start":
                out["forward"] += ea.elapsed_time(eb)
            elif a == "fwd_end":
                out["backward"] += ea.elapsed_time(eb)
            elif a == "opt_start":
                out["optimizer"] = ea.elapsed_time(eb)
        out["step"] = ev[0][1].elapsed_time(ev[-1][1])
        self.ev = []
        return out


def lm_train(np, torch, args) -> dict:
    """h2o-danube-1.8b at full width at train_4k's 4,096 tokens a row, 8
    rows (cut from 256), microbatch 4 as its config, under deterministic
    algorithms, batches from the pipeline (kernel 1, one launch a step):
    one microbatch's gradients against the plain attention's; LM_TRAIN_STEPS
    AdamW steps (ms by forward / backward / AdamW, peak bytes); a replay
    from a fresh ``init_params`` of the seed; a restart from a checkpoint
    after LM_CKPT_STEP at LM_RESTART_LAYERS layers (full widths). Losses
    and state bit for bit."""
    import shutil
    import tempfile

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.convert import lm_train_state_from_tree, train_state_tree
    from repro_torch.data.pipeline import CompressedTokenPipeline
    from repro_torch.data.synthetic import token_stream
    from repro_torch.kernels.vbyte_decode import kernel
    from repro_torch.launch.train import LM_TRAIN_ROWS
    from repro_torch.models import lm, registry
    from repro_torch.nn import attention
    from repro_torch.train import (OptimizerConfig, init_train_state,
                                   make_train_step, param_leaves)

    cfg = registry.resolve_config(LM_TRAIN_ARCH, "train_4k")
    S = registry.shapes_of(LM_TRAIN_ARCH)["train_4k"].dims["seq_len"]
    B = LM_TRAIN_ROWS
    toks = token_stream(np.random.default_rng(args.seed + 6),
                        B * (S + 1) * LM_TRAIN_STEPS, cfg.vocab)
    pipe = CompressedTokenPipeline(toks, B, S, device="cuda")
    opt = OptimizerConfig(peak_lr=LM_PEAK_LR, warmup_steps=1,
                          total_steps=LM_TRAIN_STEPS)
    rec = {"arch": LM_TRAIN_ARCH, "batch": [B, S + 1],
           "microbatch": cfg.microbatch, "params": cfg.param_count(),
           "steps": LM_TRAIN_STEPS, "peak_lr": LM_PEAK_LR}

    def batch(step):
        before = kernel.launches.count
        b = pipe.get_batch(step)
        torch.cuda.synchronize()
        if kernel.launches.count != before + 1:
            die(f"lm train: step {step}'s batch took "
                f"{kernel.launches.count - before} kernel 1 launches")
        _on_card("train batch", b["tokens"])
        return b

    def run(c, state, steps, clock=None, on_step=None, start=0):
        step_fn = make_train_step(
            clock.loss(lambda p, b: lm.loss_fn(p, b, c)) if clock else
            (lambda p, b: lm.loss_fn(p, b, c)), opt, microbatch=c.microbatch)
        losses, times, pipe_ms = [], [], []
        for i in range(start, start + steps):
            t0 = time.perf_counter()
            b = batch(i)
            pipe_ms.append((time.perf_counter() - t0) * 1e3)
            if clock is not None:
                clock.mark("start")
            state, m = step_fn(state, b)
            losses.append(float(m["loss"]))
            if clock is not None:
                times.append(clock.step_ms())
            if on_step is not None:
                on_step(i, state)
        return state, losses, times, pipe_ms

    with _deterministic(torch):
        params = lm.init_params(cfg, seed=args.seed, device="cuda")
        _on_card("train params", *params.parameters())
        # one microbatch's gradients against the plain attention's
        leaves = param_leaves(params)
        for p in leaves.values():
            p.requires_grad_(True)
        mb = {"tokens": batch(0)["tokens"][:B // cfg.microbatch]}
        loss_fn = lambda p, b: lm.loss_fn(p, b, cfg)  # noqa: E731
        loss_k, g_k = _grads(torch, params, mb, loss_fn)
        with attention.plan("plain"):
            loss_p, g_p = _grads(torch, params, mb, loss_fn)
        err = _rel_l2(g_k, g_p)
        worst = max(err, key=err.get)
        rec["grads"] = {"rows": int(mb["tokens"].shape[0]), "loss": loss_k,
                        "loss_plain": loss_p, "leaves": len(err),
                        "max_rel_l2_err": err[worst], "worst_leaf": worst,
                        "rel_l2_rtol": LM_GRAD_RTOL}
        del g_k, g_p, mb
        if not err[worst] <= LM_GRAD_RTOL:
            die(f"lm train: gradients against the plain attention: {worst} "
                f"rel L2 {err[worst]} > {LM_GRAD_RTOL}")
        q = torch.empty(B // cfg.microbatch, S, cfg.n_heads, cfg.dh,
                        device="cuda", dtype=torch.bfloat16,
                        requires_grad=True)
        kv = torch.empty(B // cfg.microbatch, S, cfg.n_kv_heads, cfg.dh,
                         device="cuda", dtype=torch.bfloat16,
                         requires_grad=True)
        if attention._window_bites(q, kv, causal=True, window=cfg.window):
            die("lm train: the window bites at train_4k")
        rec["sdpa_backend"] = attention.sdpa_backend(q, kv, kv, causal=True)
        del q, kv
        gc.collect()
        torch.cuda.empty_cache()

        state = init_train_state(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with _LMStepClock(torch) as clock:
            state, losses, times, pipe_ms = run(cfg, state, LM_TRAIN_STEPS,
                                                clock)
        peak = torch.cuda.max_memory_allocated()
        finite = bool(np.isfinite(losses).all())
        if not (finite and losses[-1] < losses[0]):
            die(f"lm train: losses finite={finite}, {losses}")
        fp = _fingerprint(torch, state)
        del state, params
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        replay = init_train_state(lm.init_params(cfg, seed=args.seed,
                                                 device="cuda"))
        replay, r_losses, _, _ = run(cfg, replay, LM_TRAIN_STEPS)
        replay_equal = r_losses == losses and _fingerprint(torch, replay) == fp
        t_replay = time.perf_counter() - t0
        # one more step of the replayed run, traced: where a step's time goes
        b = batch(0)
        step_fn = make_train_step(lambda p, x: lm.loss_fn(p, x, cfg), opt,
                                  microbatch=cfg.microbatch)
        rec["busy_share"] = _profile(torch, f"lm_train/{LM_TRAIN_ARCH}",
                                     lambda: step_fn(replay, b), 1,
                                     unit="steps")
        del replay, b
        gc.collect()
        torch.cuda.empty_cache()
        # the restart, at LM_RESTART_LAYERS layers
        cfg2 = dataclasses.replace(cfg, n_layers=LM_RESTART_LAYERS)
        ckpt_dir = tempfile.mkdtemp(prefix="lm_ckpt_")
        mgr = CheckpointManager(ckpt_dir, keep=1)

        def save(i, st):
            if i == LM_CKPT_STEP:
                mgr.save(i, train_state_tree(st))

        t0 = time.perf_counter()
        full, u_losses, _, _ = run(cfg2, init_train_state(lm.init_params(
            cfg2, seed=args.seed, device="cuda")), LM_TRAIN_STEPS,
            on_step=save)
        fp2 = _fingerprint(torch, full)
        del full
        tree, at = mgr.restore_latest(train_state_tree(init_train_state(
            lm.init_params(cfg2, seed=args.seed + 1, device="cuda"))))
        resumed = lm_train_state_from_tree(tree, cfg2, device="cuda")
        del tree
        resumed, c_losses, _, _ = run(cfg2, resumed,
                                      LM_TRAIN_STEPS - at - 1, start=at + 1)
        restart = {"layers": LM_RESTART_LAYERS, "from_step": at,
                   "losses": c_losses, "uninterrupted": u_losses,
                   "equal": (at == LM_CKPT_STEP and c_losses == u_losses[at + 1:]
                             and _fingerprint(torch, resumed) == fp2),
                   "seconds": round(time.perf_counter() - t0, 3)}
        del resumed
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    if not replay_equal or not restart["equal"]:
        die(f"lm train: replay equal {replay_equal} (losses {r_losses}; "
            f"uninterrupted {losses}), restart {restart}")
    ms = {k: [round(t[k], 3) for t in times] for k in times[0]}
    rec.update(losses=losses, ms_per_step=ms,
               median_ms={k: float(np.median(v)) for k, v in ms.items()},
               tokens_per_s=B * S / (float(np.median(ms["step"])) / 1e3),
               pipeline_ms=[round(x, 3) for x in pipe_ms],
               peak_device_bytes=peak, replay_equal=replay_equal,
               replay_seconds=round(t_replay, 3), restart=restart)
    return rec


def run_lm(np, torch, args) -> dict:
    """Path ``lm``: the compressed token pipeline (kernel 1), serving of
    h2o-danube-1.8b and olmoe-1b-7b and training of h2o-danube-1.8b at full
    width. Every launch count is set to 0 just before the path and read
    just after."""
    t_path = time.perf_counter()
    counters = _launch_counters()
    _reset(torch, counters)
    pipe, pipeline = lm_pipeline(np, torch, args)
    emit("lm_pipeline", **pipe)
    serve = {}
    for arch in LM_SERVE:
        serve[arch] = lm_serve(np, torch, arch, args)
        emit("lm_serve", **serve[arch])
    train = lm_train(np, torch, args)
    emit("lm_train", **train)
    launches = _read(torch, counters)
    seconds = time.perf_counter() - t_path
    # one kernel 1 launch a batch: the pipeline's steps, the gradient
    # check's batch, the run, its replay, the traced step, the restart's run
    # and its resumed steps; no other kernel
    want = dict.fromkeys(counters, 0)
    want["vbyte_decode_blocked"] = (LM_PIPE_STEPS + 2 + 3 * LM_TRAIN_STEPS
                                    + LM_TRAIN_STEPS - LM_CKPT_STEP - 1)
    if {k: launches[k] for k in counters} != want:
        die(f"lm: launches {launches}, expected {want}")
    emit("path_done", path="lm", seconds=round(seconds, 3),
         launches=launches)
    kernel1 = parity_lm_pipeline(np, torch, pipeline)
    emit("parity_lm_pipeline", **kernel1)
    return {"launches": launches, "seconds": seconds, "pipeline": pipe,
            "serve": serve, "train": train, "kernel1": kernel1}


# ---------------------------------------------------------------------------
# path sharded_train: ZeRO-1 data-parallel training over a mesh
# ---------------------------------------------------------------------------
SHARDED_TRAIN_SHARDS = 4  # logical data shards (of cuda:0 on one card)
SHARDED_TRAIN_STEPS = 2
PSUM_SHAPE = (2560, 2560)  # compressed_psum's per-shard tensor (one wo layer)


def _leaf_digests(torch, state) -> dict:
    """Per leaf of a train state (placed or not; the reference's paths),
    its dtype, shape and the int64 sums of its words and of its words
    times a position weight, each leaf taken whole one at a time."""
    from repro_torch.convert import train_state_tree
    from repro_torch.distributed.sharding import whole
    from repro_torch.tree import flatten

    out = {}
    for k, x in flatten(train_state_tree(state, whole=False)):
        w = whole(x).detach().reshape(-1)
        w = w.view(torch.int32 if w.element_size() == 4 else torch.int16)
        s1 = s2 = 0
        for a in range(0, w.numel(), 1 << 26):
            c = w[a:a + (1 << 26)].to(torch.int64)
            pos = torch.arange(a, a + c.numel(), device=c.device) % 1000003 + 1
            s1 += int(c.sum())
            s2 += int((c * pos).sum())
        out[k] = f"{x.dtype}:{tuple(x.shape)}:{s1}:{s2}"
    return out


class _PhaseClock:
    """CUDA events at the sharded step's phase marks (``on_phase``): ms a
    step by gather, forward_backward, reduce and update (AdamW and the
    global norm), and the step from the first mark to ``end``."""

    def __init__(self, torch):
        self.torch, self.ev = torch, []

    def __call__(self, name):
        e = self.torch.cuda.Event(enable_timing=True)
        e.record()
        self.ev.append((name, e))

    def step_ms(self) -> dict:
        self.torch.cuda.synchronize()
        out = dict.fromkeys(("gather", "forward_backward", "reduce",
                             "update"), 0.0)
        for (a, ea), (_, eb) in zip(self.ev, self.ev[1:]):
            out[a] += ea.elapsed_time(eb)
        out["step"] = self.ev[0][1].elapsed_time(self.ev[-1][1])
        self.ev = []
        return out


def _state_bytes(state, n_shards: int) -> dict:
    """Bytes of a placed train state: each data shard's own (its slices
    of the split leaves, and one copy of every replicated leaf, as one
    card of a mesh over cards holds), the split and replicated shares."""
    from repro_torch.convert import train_state_tree
    from repro_torch.distributed.sharding import BlockSharded, pieces
    from repro_torch.tree import flatten

    split = [0] * n_shards
    repl = 0
    for _, x in flatten(train_state_tree(state, whole=False)):
        if isinstance(x, BlockSharded):
            for i, s in enumerate(x.shards):
                split[i] += s.numel() * s.element_size()
        else:
            t = pieces(x)[0]
            repl += t.numel() * t.element_size()
    return {"per_shard": [b + repl for b in split], "split_per_shard": split,
            "replicated": repl}


def _psum_check(np, torch, mesh, seed: int) -> dict:
    """``compressed_psum`` over the mesh's data shards on the card against
    the same call on a mesh of CPU shards: bit for bit."""
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.sharding import BlockSharded
    from repro_torch.train.grad_compress import compressed_psum

    n = mesh.shape["data"]
    rng = np.random.default_rng(seed)
    host = [torch.as_tensor((rng.standard_normal(PSUM_SHAPE)
                             * 10.0 ** rng.uniform(-4, -2)).astype(np.float32))
            for _ in range(n)]
    cpu_mesh = make_mesh((n, 1), ("data", "model"), devices=["cpu"] * n)
    want = compressed_psum(BlockSharded(cpu_mesh, ("data",), tuple(host)),
                           "data")
    x = BlockSharded(mesh, ("data",), tuple(h.to(d) for h, d in zip(
        host, (mesh.devices[i, 0] for i in range(n)))))
    got = compressed_psum(x, "data")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    compressed_psum(x, "data")
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    _on_card("compressed_psum", *got.shards)
    equal = all(torch.equal(g.cpu(), w) for g, w in zip(got.shards,
                                                          want.shards))
    if not equal:
        die("sharded_train: compressed_psum on the card differs from its "
            "CPU result")
    return {"shape": list(PSUM_SHAPE), "shards": n, "equal": equal,
            "ms": round(ms, 3)}


def run_sharded_train(np, torch, args, lm_path: dict) -> dict:
    """Path ``sharded_train``: h2o-danube-1.8b at full width (float32
    parameters from the seed), ZeRO-1 (``build_cell``'s ``zero1`` specs
    and hooks) over ``make_mesh((4, 1), ("data", "model"))``, 8 × 4,096
    tokens a step from the pipeline (kernel 1), one microbatch a shard,
    under deterministic algorithms: SHARDED_TRAIN_STEPS steps of
    ``jit_train_step``, then the same steps of the single-device
    ``make_train_step(microbatch=4)`` with the same hooks from a fresh
    state of the seed (one state on the card at a time): losses, grad
    norms and every leaf's digest of params, ``m`` and ``v`` bit for bit;
    ``compressed_psum`` over the 4 shards against its CPU result. Every
    launch count is set to 0 just before the path and read just after."""
    from repro_torch.convert import train_state_tree
    from repro_torch.data.pipeline import CompressedTokenPipeline
    from repro_torch.data.synthetic import token_stream
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.sharding import pieces
    from repro_torch.launch.train import LM_TRAIN_ROWS
    from repro_torch.models import lm, registry
    from repro_torch.train import (OptimizerConfig, init_train_state,
                                   jit_train_step)
    from repro_torch.tree import flatten

    t_path = time.perf_counter()
    counters = _launch_counters()
    _reset(torch, counters)
    n = SHARDED_TRAIN_SHARDS
    mesh = make_mesh((n, 1), ("data", "model"))
    opt = OptimizerConfig(peak_lr=LM_PEAK_LR, warmup_steps=1,
                          total_steps=SHARDED_TRAIN_STEPS)
    cell = registry.build_cell(LM_TRAIN_ARCH, "train_4k", mesh_dp=n,
                               overrides={"zero1": True}, opt_cfg=opt)
    cfg = cell.cfg
    S = cell.shape.dims["seq_len"]
    B = LM_TRAIN_ROWS
    if cfg.microbatch % n:
        die(f"sharded_train: microbatch {cfg.microbatch} over {n} shards")
    toks = token_stream(np.random.default_rng(args.seed + 7),
                        B * (S + 1) * SHARDED_TRAIN_STEPS, cfg.vocab)
    pipe = CompressedTokenPipeline(toks, B, S, device="cuda")
    rec = {"arch": LM_TRAIN_ARCH, "mesh": mesh.shape,
           "devices": sorted({str(d) for d in mesh.devices.flat}),
           "batch": [B, S + 1], "microbatch": cfg.microbatch,
           "microbatches_per_shard": cfg.microbatch // n,
           "steps": SHARDED_TRAIN_STEPS, "layers": cfg.n_layers,
           "zero1_split_leaves": sorted(
               k for k, s in cell.arg_specs[0]["params"].items()
               if any(isinstance(a, tuple) and "data" in a for a in s))}

    def batch(step):
        b = pipe.get_batch(step)
        _on_card("sharded train batch", b["tokens"])
        return b

    def run(step_fn, state, clock=None):
        losses, norms, times = [], [], []
        for i in range(SHARDED_TRAIN_STEPS):
            b = batch(i)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step_fn(state, b)
            end.record()
            torch.cuda.synchronize()
            t = clock.step_ms() if clock is not None else {}
            t["call"] = start.elapsed_time(end)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append({k: round(v, 3) for k, v in t.items()})
        return state, losses, norms, times

    with _deterministic(torch):
        sharded = jit_train_step(cell.fn,
                                 in_shardings=cell.in_shardings(mesh))
        state = init_train_state(lm.init_params(cfg, seed=args.seed,
                                                device="cuda"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded.place(state)
        torch.cuda.synchronize()
        rec["place_seconds"] = round(time.perf_counter() - t0, 3)
        gc.collect()
        torch.cuda.empty_cache()
        rec["state_bytes"] = _state_bytes(state, n)
        torch.cuda.reset_peak_memory_stats()
        sharded.on_phase = clock = _PhaseClock(torch)
        state, losses, norms, times = run(sharded, state, clock)
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
        _on_card("sharded train state", *(
            p for _, x in flatten(train_state_tree(state, whole=False))
            for p in pieces(x)))
        digests = _leaf_digests(torch, state)
        del state, sharded
        gc.collect()
        torch.cuda.empty_cache()
        # the single-device step with the same hooks, from a fresh state
        single = init_train_state(lm.init_params(cfg, seed=args.seed,
                                                 device="cuda"))
        torch.cuda.reset_peak_memory_stats()
        single, s_losses, s_norms, s_times = run(cell.fn, single)
        s_peak = torch.cuda.max_memory_allocated()
        s_digests = _leaf_digests(torch, single)
        del single
        gc.collect()
        torch.cuda.empty_cache()
    bad = sorted(k for k in s_digests if digests.get(k) != s_digests[k])
    equal = (losses == s_losses and norms == s_norms and not bad
             and digests.keys() == s_digests.keys())
    if not equal:
        die(f"sharded_train: the {n}-shard step differs from the "
            f"single-device step: losses {losses} vs {s_losses}, grad norms "
            f"{norms} vs {s_norms}, leaves {bad[:6]}")
    if not all(np.isfinite(losses)):
        die(f"sharded_train: losses {losses}")
    psum = _psum_check(np, torch, mesh, args.seed)
    launches = _read(torch, counters)
    want = dict.fromkeys(counters, 0)
    want["vbyte_decode_blocked"] = 2 * SHARDED_TRAIN_STEPS
    if {k: launches[k] for k in counters} != want:
        die(f"sharded_train: launches {launches}, expected {want}")
    seconds = time.perf_counter() - t_path
    lm_train = lm_path["train"]
    # the last step is the steady one (the first pays first-use costs)
    rec.update(
        losses=losses, grad_norms=norms, equal_bit_for_bit=equal,
        leaves_compared=len(digests), ms_per_step=times,
        steady_ms=times[-1], tokens_per_s=B * S / (times[-1]["call"] / 1e3),
        single_device={"ms_per_step": s_times, "peak_device_bytes": s_peak,
                       "losses": s_losses, "grad_norms": s_norms},
        lm_path_single_device={"median_ms": lm_train["median_ms"],
                               "peak_device_bytes":
                                   lm_train["peak_device_bytes"],
                               "note": "path lm's unhooked step (float32 "
                                       "gradients), same shape"},
        compressed_psum=psum)
    emit("sharded_train", **rec)
    emit("path_done", path="sharded_train", seconds=round(seconds, 3),
         launches=launches)
    return {"launches": launches, "seconds": seconds, "train": rec}


# ---------------------------------------------------------------------------
# path model_parallel: tensor and expert parallelism over a model axis
# ---------------------------------------------------------------------------
MP_TRAIN_MESH = (2, 2)  # (data, model) logical shards of cuda:0
MP_TRAIN_STEPS = 2
MP_TRAIN_RTOL = 1e-3  # losses and grad norms against the single device
MP_SERVE_MESH = (1, 4)
MP_DECODE_STEPS = 16
# arch: batch, prompt, decode steps, layers kept (None: all)
MP_SERVE = {"olmoe-1b-7b": (4, 2048, MP_DECODE_STEPS, None),
            "h2o-danube-1.8b": (1, 4096, MP_DECODE_STEPS, None),
            "mixtral-8x7b": (1, 4096, 0, 2)}


@contextlib.contextmanager
def _mp_drop_recorder():
    """Every MoE layer's ``moe_drop_frac`` while the block runs, single
    device (``moe_apply``) and over the positions (``moe_apply_mp``), in
    call order."""
    from repro_torch.nn import moe

    real = {n: getattr(moe, n) for n in ("moe_apply", "moe_apply_mp")}
    seen = []

    def wrap(fn):
        def recorded(*a, **kw):
            out, aux = fn(*a, **kw)
            seen.append(float(aux["moe_drop_frac"]))
            return out, aux
        return recorded

    for n, fn in real.items():
        setattr(moe, n, wrap(fn))
    try:
        yield seen
    finally:
        for n, fn in real.items():
            setattr(moe, n, fn)


def _grads_at_finish(step_fn, fn, every: bool = False):
    """``step_fn`` (a train step) calling ``fn(grads)`` with its first
    step's accumulated gradients (``every``: each step's), before the
    update."""
    st = step_fn.step if hasattr(step_fn, "step") else step_fn
    real, seen = st.finish, []

    def finish(state, loss, aux, grads, update=None):
        if every or not seen:
            seen.append(True)
            fn(grads)
        return real(state, loss, aux, grads, update)

    st.finish = finish
    return step_fn


def _single_at(torch, step, state, batch, sample) -> tuple:
    """``(loss, grad norm, sample(grads))`` of the single-device
    ``step`` (a ``TrainStep``) on ``state``'s parameters, without its
    update: the parameters a mesh step left (its placed leaves, a split
    one gathered whole on ``cuda:0``), so that the mesh's next step and
    the single device start from one state and one step's rounding is
    compared."""
    from repro_torch.train.optimizer import global_norm
    from repro_torch.train.train_state import ShardedParams, param_leaves

    params = state["params"]
    if isinstance(params, ShardedParams):
        params = params.on(torch.device("cuda", 0))
        for p in param_leaves(params).values():
            p.requires_grad_(True)
    seen, real = {}, step.finish

    def finish(st, loss, aux, grads, update=None):
        seen.update(sample(grads))
        return {"loss": loss, "grad_norm": global_norm(grads)}

    step.finish = finish
    try:
        _, m = step({"params": params}, batch)
    finally:
        step.finish = real
    return float(m["loss"]), float(m["grad_norm"]), seen


def mp_train(np, torch, args) -> dict:
    """h2o-danube-1.8b at full width over ``make_mesh((2, 2))`` with ZeRO-1
    (``build_cell``'s specs and hooks): MP_TRAIN_STEPS steps of
    ``jit_train_step``, the single-device hooked step at microbatch 4 from
    a fresh state of the seed, then a replay of the mesh steps; one state
    on the card at a time."""
    from repro_torch.data.pipeline import CompressedTokenPipeline
    from repro_torch.data.synthetic import token_stream
    from repro_torch.distributed import make_mesh
    from repro_torch.launch.train import LM_TRAIN_ROWS
    from repro_torch.models import lm, registry
    from repro_torch.train import (OptimizerConfig, init_train_state,
                                   jit_train_step)

    n, k = MP_TRAIN_MESH
    mesh = make_mesh(MP_TRAIN_MESH, ("data", "model"))
    opt = OptimizerConfig(peak_lr=LM_PEAK_LR, warmup_steps=1,
                          total_steps=MP_TRAIN_STEPS)

    def cell():  # a fresh step (its hooks patched per run)
        return registry.build_cell(LM_TRAIN_ARCH, "train_4k", mesh_dp=n,
                                   overrides={"zero1": True}, opt_cfg=opt)

    c0 = cell()
    cfg = c0.cfg
    S, B = c0.shape.dims["seq_len"], LM_TRAIN_ROWS
    toks = token_stream(np.random.default_rng(args.seed + 7),
                        B * (S + 1) * MP_TRAIN_STEPS, cfg.vocab)
    pipe = CompressedTokenPipeline(toks, B, S, device="cuda")
    rec = {"arch": LM_TRAIN_ARCH, "mesh": mesh.shape, "layers": cfg.n_layers,
           "batch": [B, S + 1], "microbatch": cfg.microbatch,
           "parts_per_data_position": cfg.microbatch // n,
           "steps": MP_TRAIN_STEPS,
           "split_leaves": {
               key: str(s) for key, s in c0.arg_specs[0]["params"].items()
               if any(e is not None for e in s)}}

    def run(step_fn, clock=None):
        state = init_train_state(lm.init_params(cfg, seed=args.seed,
                                                device="cuda"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, times = [], [], []
        for i in range(MP_TRAIN_STEPS):
            b = pipe.get_batch(i)
            _on_card("model_parallel train batch", b["tokens"])
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step_fn(state, b)
            end.record()
            torch.cuda.synchronize()
            t = clock.step_ms() if clock is not None else {}
            t["call"] = start.elapsed_time(end)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append({key: round(v, 3) for key, v in t.items()})
        peak = torch.cuda.max_memory_allocated()
        digests = _leaf_digests(torch, state)
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return losses, norms, times, peak, digests

    from repro_torch.distributed.sharding import whole

    grads_mp, g_rel = {}, {}

    def keep(grads):  # the mesh step's, whole on the card (float32)
        grads_mp.update({key: whole(g).float() for key, g in grads.items()})

    def against(grads):  # the single device's, leaf by leaf
        for key, g in grads.items():
            a, g = grads_mp.pop(key), g.float()
            g_rel[key] = float((a - g).norm() / g.norm().clamp(min=1e-30))

    with _deterministic(torch):
        c = cell()
        sharded = _grads_at_finish(jit_train_step(
            c.fn, in_shardings=c.in_shardings(mesh)), keep)
        sharded.on_phase = clock = _PhaseClock(torch)
        losses, norms, times, peak, digests = run(sharded, clock)
        one = _grads_at_finish(cell().fn, against)
        s_losses, s_norms, s_times, s_peak, _ = run(one)
        c = cell()
        replay = jit_train_step(c.fn, in_shardings=c.in_shardings(mesh))
        r_losses, r_norms, _, _, r_digests = run(replay)
    rel = {what: max(abs(a - b) / abs(b) for a, b in zip(x, y))
           for what, x, y in (("loss", losses, s_losses),
                              ("grad_norm", norms, s_norms))}
    if not all(np.isfinite(losses + norms)) or max(rel.values()) > \
            MP_TRAIN_RTOL:
        die(f"model_parallel train: losses {losses} vs {s_losses}, grad "
            f"norms {norms} vs {s_norms}: {rel} > {MP_TRAIN_RTOL}")
    worst = max(g_rel, key=g_rel.get)
    if g_rel[worst] > LM_GRAD_RTOL:
        die(f"model_parallel train: gradient {worst} {g_rel[worst]} > "
            f"{LM_GRAD_RTOL} of the single device's")
    if (r_losses, r_norms) != (losses, norms) or r_digests != digests:
        bad = sorted(key for key in digests if r_digests.get(key)
                     != digests[key])
        die(f"model_parallel train: the replay differs: losses {r_losses} "
            f"vs {losses}, leaves {bad[:6]}")
    rec.update(losses=losses, grad_norms=norms, rel_to_single=rel,
               grad_rel_l2_max={"leaf": worst, "value": g_rel[worst]},
               replay_equal=True, ms_per_step=times, steady_ms=times[-1],
               tokens_per_s=B * S / (times[-1]["call"] / 1e3),
               peak_device_bytes=peak,
               single_device={"ms_per_step": s_times, "losses": s_losses,
                              "grad_norms": s_norms,
                              "peak_device_bytes": s_peak})
    emit("mp_train", **rec)
    return rec


def _mp_run(torch, registry, lm, cells, mesh, params, prompt, steps: int,
            dtype):
    """The prefill cell over ``mesh`` (a warm-up call, then a timed one),
    ``steps`` greedy decode-cell calls, then the single-device ``prefill``
    and ``decode_step`` fed the same tokens (teacher forcing), at
    ``dtype``: the two runs' logits, caches, ``moe_drop_frac`` a layer
    call and seconds."""
    from repro_torch.distributed.sharding import whole

    pre, dec = cells
    cfg, cap = pre.fn.keywords["cfg"], pre.fn.keywords["cache_capacity"]

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    out = {"mesh": {"logits": []}, "single": {"logits": []}}
    registry.run_cell(pre, mesh, params, prompt)  # warm-up
    with _mp_drop_recorder() as drops:
        ((lg, cache), placed), t_pre = timed(
            lambda: registry.run_cell(pre, mesh, params, prompt))
        out["mesh"]["prefill_seconds"] = t_pre
        out["mesh"]["prefill_cache_layout"] = [
            [d, list(a)] for d, a in cache["k"].splits]
        _on_card("prefill over the mesh", *(
            x for v in (lg, cache["k"]) for x in v.shards))
        out["mesh"]["logits"].append(whole(lg))
        toks = []
        t0 = time.perf_counter()
        for _ in range(steps):
            toks.append(torch.argmax(out["mesh"]["logits"][-1], -1).to(
                torch.int32))
            (lg, cache), placed = registry.run_cell(dec, mesh, placed, cache,
                                                    toks[-1])
            out["mesh"]["logits"].append(whole(lg))
        torch.cuda.synchronize()
        out["mesh"]["decode_seconds"] = time.perf_counter() - t0
    out["mesh"].update(drops=list(drops), cache={
        k: whole(cache[k]) for k in ("k", "v")})
    if steps:
        out["mesh"]["decode_cache_layout"] = [
            [d, list(a)] for d, a in cache["k"].splits]
    del cache, placed
    with _mp_drop_recorder() as drops:
        (lg, cache), t_pre = timed(lambda: lm.prefill(
            params, prompt, cfg, cache_capacity=cap, dtype=dtype))
        out["single"]["prefill_seconds"] = t_pre
        out["single"]["logits"].append(lg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for tok in toks:
            lg, cache = lm.decode_step(params, cache, tok, cfg, dtype=dtype)
            out["single"]["logits"].append(lg)
        torch.cuda.synchronize()
        out["single"]["decode_seconds"] = time.perf_counter() - t0
    out["single"].update(drops=list(drops), cache=cache)
    out["tokens"] = toks
    return out


def mp_serve(np, torch, arch: str, args) -> dict:
    """One config over ``make_mesh((1, 4))`` through ``registry.run_cell``
    (bf16 parameters from the seed; mixtral cut to its first layers): the
    prefill cell, then the decode cell MP_SERVE[arch] times greedily,
    against the single-device ``prefill`` / ``decode_step`` fed the same
    tokens. A dense config's logits and caches are held within
    LM_SERVE_RTOL of their largest |value| as served (bf16). An MoE
    config's router sends a token whose hidden state moved by a last bit
    (the row-parallel sums re-associate) to another expert where its
    top-k is a near tie, and at decode's 4 tokens a capacity of 1 drops
    other rows then: its served readings (logits, caches, drop shares of
    both runs) are reported, and its held checks run at float32 with
    capacity E / K on the prompts' first LM_MOE_CHECK_PROMPT tokens
    (LM_CHECK_STEPS decode steps), as path ``lm`` holds olmoe: logits and
    caches within LM_SERVE_RTOL, ``moe_drop_frac`` equal."""
    from repro_torch.distributed import make_mesh
    from repro_torch.models import lm, registry
    from repro_torch.train import map_params

    B, S, steps, layers = MP_SERVE[arch]
    over = {} if layers is None else {"n_layers": layers}
    mesh = make_mesh(MP_SERVE_MESH, ("data", "model"))
    rng = np.random.default_rng(args.seed + 11)

    def cells(cfg_over, cap, dtype):
        pre = registry.build_cell(arch, "prefill_32k", mesh_dp=1,
                                  overrides=cfg_over)
        dec = registry.build_cell(arch, "decode_32k", mesh_dp=1,
                                  overrides=cfg_over)
        cfg = pre.cfg
        return (dataclasses.replace(pre, fn=functools.partial(
                    lm.prefill, cfg=cfg, cache_capacity=cap, dtype=dtype)),
                dataclasses.replace(dec, fn=functools.partial(
                    lm.decode_step, cfg=cfg, dtype=dtype)))

    served = cells(over, S + steps, torch.bfloat16)
    cfg = served[0].cfg
    prompt = torch.as_tensor(rng.integers(0, cfg.vocab, (B, S)).astype(
        np.int32), device="cuda")
    params = map_params(lambda key, p: p.to(torch.bfloat16),
                        lm.init_params(cfg, seed=args.seed, device="cuda"))
    gc.collect()
    torch.cuda.empty_cache()
    rec = {"arch": arch, "mesh": mesh.shape, "batch": B, "prompt": S,
           "layers": cfg.n_layers, "decode_steps": steps,
           "cache_head_axes": str(lm.cache_head_axes(cfg))}

    def hold(what, got, want):
        err = _max_rel(torch, got, want)
        rec.setdefault("held", {})[what] = err
        if not err <= LM_SERVE_RTOL:
            die(f"model_parallel {arch}: {what} {err} > {LM_SERVE_RTOL} of "
                "the largest value")

    def compare(run, check):
        for i, (a, b) in enumerate(zip(run["mesh"]["logits"],
                                       run["single"]["logits"])):
            check("prefill logits" if i == 0 else f"decode {i - 1} logits",
                  a, b)
        for part in ("k", "v"):
            check(f"cache {part}", run["mesh"]["cache"][part],
                  run["single"]["cache"][part])

    with torch.inference_mode():
        torch.cuda.reset_peak_memory_stats()
        run = _mp_run(torch, registry, lm, served, mesh, params, prompt,
                      steps, torch.bfloat16)
        rec.update(
            prefill_seconds=run["mesh"]["prefill_seconds"],
            single_device_prefill_seconds=run["single"]["prefill_seconds"],
            cache_layout=run["mesh"]["prefill_cache_layout"],
            sample=(torch.stack(run["tokens"], 1)[0, :8].tolist()
                    if steps else []))
        if steps:
            rec.update(
                decode_ms_per_token=run["mesh"]["decode_seconds"] / steps
                * 1e3,
                single_device_decode_ms_per_token=run["single"][
                    "decode_seconds"] / steps * 1e3,
                decode_cache_layout=run["mesh"]["decode_cache_layout"])
        if not cfg.moe:
            compare(run, hold)
        else:
            def report(what, got, want):
                rec.setdefault("reported_bf16", {})[what] = _max_rel(
                    torch, got, want)

            compare(run, report)
            rec["reported_bf16"]["moe_drop_frac_equal"] = (
                run["mesh"]["drops"] == run["single"]["drops"])
            rec["reported_bf16"]["moe_drop_frac_mean"] = [
                sum(r["drops"]) / len(r["drops"])
                for r in (run["mesh"], run["single"])]
            del run
            ccfg = {**over, "moe.capacity_factor":
                    cfg.moe.n_experts / cfg.moe.top_k}
            Sc = LM_MOE_CHECK_PROMPT
            n = LM_CHECK_STEPS if steps else 0
            run = _mp_run(torch, registry, lm, cells(ccfg, Sc + n,
                                                     torch.float32),
                          mesh, params, prompt[:, :Sc], n, torch.float32)
            rec["checks_at"] = {"capacity_factor": ccfg["moe.capacity_factor"],
                                "prompt": Sc, "decode_steps": n,
                                "dtype": "float32"}
            compare(run, hold)
            if run["mesh"]["drops"] != run["single"]["drops"]:
                die(f"model_parallel {arch}: moe_drop_frac "
                    f"{run['mesh']['drops']} vs {run['single']['drops']}")
            rec["held"]["moe_drop_frac_equal"] = True
        rec["peak_device_bytes"] = torch.cuda.max_memory_allocated()
    del params, run
    gc.collect()
    torch.cuda.empty_cache()
    emit("mp_serve", **rec)
    return rec


def run_model_parallel(np, torch, args) -> dict:
    """Path ``model_parallel``: ``mp_train`` then ``mp_serve`` for each
    config of MP_SERVE; every launch count set to 0 just before the path
    and read just after (kernel 1: one launch a train batch)."""
    t_path = time.perf_counter()
    counters = _launch_counters()
    _reset(torch, counters)
    phases = {}
    t0 = time.perf_counter()
    train = mp_train(np, torch, args)
    phases["mp_train"] = time.perf_counter() - t0
    serve = {}
    for arch in MP_SERVE:
        t0 = time.perf_counter()
        serve[arch] = mp_serve(np, torch, arch, args)
        phases[f"mp_serve/{arch}"] = time.perf_counter() - t0
    launches = _read(torch, counters)
    want = dict.fromkeys(counters, 0)
    want["vbyte_decode_blocked"] = 3 * MP_TRAIN_STEPS  # mesh, single, replay
    if {k: launches[k] for k in counters} != want:
        die(f"model_parallel: launches {launches}, expected {want}")
    seconds = time.perf_counter() - t_path
    emit("path_done", path="model_parallel", seconds=round(seconds, 3),
         phase_seconds={k: round(v, 3) for k, v in phases.items()},
         launches=launches)
    return {"launches": launches, "seconds": seconds, "train": train,
            "serve": serve}


# ---------------------------------------------------------------------------
# path mesh_cells: the recsys cells over a (data, model) mesh, a microbatch
# split by rows over the data positions
# ---------------------------------------------------------------------------
MESH_DP = (4, 1)  # dp_train: SASRec and two-tower, rows over 4 positions
MESH_MP = (2, 2)  # mp_recsys_train: BST and two-tower, tables / MLPs split
MESH_SERVE = (1, 4)  # mp_recsys_serve: SASRec and BST
MESH_TRAIN_STEPS = 2
MESH_TRAIN_RTOL = 1e-3  # each step's loss and grad norm against one
# device's from the same state: the first step's from the seed's, a later
# one's from the state the mesh's previous step left (``_single_at``)
MESH_GRAD_RTOL = 2.0**-4  # relative L2 of a sampled gradient leaf
MESH_GRAD_ROWS = 1 << 12  # a table's rows held, drawn, besides the batch's
MESH_HIT_ROWS = 1 << 16  # at most this many of the rows the batch hits
MESH_SERVE_RTOL = 2.0**-5  # BST's scores, of the largest |score|
MESH_SERVE_CALLS = 3  # timed requests a cell, mesh and single device


def _grad_sample(torch, cfg, batch, seed: int):
    """``sample(grads) -> {leaf: float32 tensor}``: every small leaf whole;
    of a table (2^16 rows or more), MESH_HIT_ROWS of the rows the batch's
    ids hit and MESH_GRAD_ROWS more, drawn from ``seed``, gathered one leaf
    at a time."""
    from repro_torch.distributed.sharding import BlockSharded, whole

    ids = torch.cat([v.reshape(-1).to(torch.int64) for v in batch.values()])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = {}

    def pick(k, n):
        if k not in rows:
            hit = torch.unique(ids[ids < n])
            hit = hit[torch.randperm(hit.numel(), generator=gen,
                                     device="cuda")[:MESH_HIT_ROWS]]
            extra = torch.randint(0, n, (MESH_GRAD_ROWS,), generator=gen,
                                  device="cuda")
            rows[k] = torch.unique(torch.cat([hit, extra]))
        return rows[k]

    def sample(grads):
        out = {}
        for k, g in grads.items():
            shape = g.shape
            if len(shape) == 2 and shape[0] >= 1 << 16:
                r = pick(k, shape[0])
                if isinstance(g, BlockSharded) and g.dim == 0 and \
                        g.dim2 is None:
                    per, parts = shape[0] // len(g.shards), []
                    for i, s in enumerate(g.shards):
                        m = (r >= i * per) & (r < (i + 1) * per)
                        parts.append(s[r[m] - i * per].float())
                    out[k] = torch.cat(parts)
                else:
                    out[k] = whole(g)[r].float()
            else:
                out[k] = whole(g).float().clone()
        return out

    return sample


def _train_rel(losses, norms, s_losses, s_norms) -> dict:
    """The worst relative differences of the steps' losses and grad norms
    against one device's from the same state."""
    def worst(x, y):
        return max(abs(a - b) / abs(b) for a, b in zip(x, y))

    return {"loss": worst(losses, s_losses),
            "grad_norm": worst(norms, s_norms)}


def _train_held(rel: dict) -> bool:
    return (rel["loss"] <= MESH_TRAIN_RTOL
            and rel["grad_norm"] <= MESH_TRAIN_RTOL)


def mesh_train(np, torch, arch: str, mesh_shape: tuple, args, *,
               replay: bool) -> dict:
    """The full-width train cell of ``arch`` (65,536 rows, microbatch 1)
    over ``make_mesh(mesh_shape)`` through ``jit_train_step``: each step's
    rows split over the data positions and its loss reduced across them,
    the rule's tables and MLPs split over ``model``. First the
    single-device step from the same seed and batch (ms a step, peak
    bytes, the first step's loss, grad norm and sampled gradients; its
    state then freed: two two-tower states do not fit together), then the
    mesh's MESH_TRAIN_STEPS steps, each later one preceded by the single
    device's loss, grad norm and sampled gradients on the state the
    mesh's previous step left (``_single_at``): every step held against
    one device from the same state by ``_train_held`` and within
    MESH_GRAD_RTOL; with ``replay``, the mesh steps again from a fresh
    state of the seed, bit for bit."""
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.distributed import make_mesh
    from repro_torch.models import recsys, registry
    from repro_torch.train import OptimizerConfig, init_train_state
    from repro_torch.train import jit_train_step

    n = mesh_shape[0]
    mesh = make_mesh(mesh_shape, ("data", "model"))
    cfg = registry.resolve_config(arch, "train_batch")
    shape = RECSYS_SHAPES["train_batch"]
    B = shape.dims["batch"]
    batch = registry.recsys_batch_for(cfg, shape, np.random.default_rng(
        args.seed + 3), device="cuda")
    opt = OptimizerConfig(peak_lr=RECSYS_PEAK_LR[cfg.kind], warmup_steps=1,
                          total_steps=MESH_TRAIN_STEPS)
    sample = _grad_sample(torch, cfg, batch, args.seed + 17)

    def cell():
        return registry.build_cell(arch, "train_batch", mesh_dp=n,
                                   opt_cfg=opt)

    def run(step_fn, clock=None, before=None):
        state = init_train_state(recsys.init_params(cfg, seed=args.seed,
                                                    device="cuda"))
        losses, norms, times, peak = [], [], [], 0
        for i in range(MESH_TRAIN_STEPS):
            if before is not None and i:
                before(state)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            state, m = step_fn(state, batch)
            end.record()
            torch.cuda.synchronize()
            peak = max(peak, torch.cuda.max_memory_allocated())
            t = clock.step_ms() if clock is not None else {}
            t["call"] = start.elapsed_time(end)
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            times.append({k: round(v, 3) for k, v in t.items()})
        digests = _leaf_digests(torch, state) if replay else None
        del state
        gc.collect()
        torch.cuda.empty_cache()
        return losses, norms, times, peak, digests

    g_one, g_mesh, at = {}, [], []
    with _deterministic(torch):
        one = _grads_at_finish(cell().fn, lambda g: g_one.update(sample(g)))
        s_losses, s_norms, s_times, s_peak, _ = run(one)
        single = cell().fn
        c = cell()
        step = jit_train_step(c.fn, in_shardings=c.in_shardings(mesh))
        step.on_phase = clock = _PhaseClock(torch)
        losses, norms, times, peak, digests = run(
            _grads_at_finish(step, lambda g: g_mesh.append(sample(g)),
                             every=True), clock,
            lambda state: at.append(_single_at(torch, single, state, batch,
                                               sample)))
        if replay:
            c = cell()
            r_losses, r_norms, _, _, r_digests = run(jit_train_step(
                c.fn, in_shardings=c.in_shardings(mesh)))
    want_losses = s_losses[:1] + [a[0] for a in at]
    want_norms = s_norms[:1] + [a[1] for a in at]
    rel = _train_rel(losses, norms, want_losses, want_norms)
    if not all(np.isfinite(losses + norms)) or not _train_held(rel):
        die(f"mesh_cells {arch} over {mesh_shape}: losses {losses} vs "
            f"{want_losses}, grad norms {norms} vs {want_norms}: {rel} "
            f"beyond {MESH_TRAIN_RTOL}")
    g_rel = [_rel_l2(g, w) for g, w in zip(g_mesh, [g_one] + [
        a[2] for a in at])]
    worst = max(((t, k) for t, r in enumerate(g_rel) for k in r),
                key=lambda tk: g_rel[tk[0]][tk[1]])
    if g_rel[worst[0]][worst[1]] > MESH_GRAD_RTOL:
        die(f"mesh_cells {arch} over {mesh_shape}: step {worst[0] + 1}'s "
            f"gradient {worst[1]} {g_rel[worst[0]][worst[1]]} > "
            f"{MESH_GRAD_RTOL} of the single device's")
    rec = {"arch": arch, "mesh": mesh.shape, "batch": B, "microbatch": 1,
           "rows_per_position": B // n, "steps": MESH_TRAIN_STEPS,
           "split": step.split, "model_parallel": step.tp,
           "split_leaves": {k: str(s) for k, s in c.arg_specs[0][
               "params"].items() if any(e is not None for e in s)},
           "losses": losses, "grad_norms": norms,
           "single_device_from_same_state": {"losses": want_losses,
                                             "grad_norms": want_norms},
           "rel_to_single": rel,
           "grad_rel_l2_max": {"step": worst[0] + 1, "leaf": worst[1],
                               "value": g_rel[worst[0]][worst[1]]},
           "grad_rows_sampled": {k: int(v.shape[0]) for k, v in
                                 g_one.items() if v.dim() == 2},
           "ms_per_step": times, "peak_device_bytes": peak,
           "single_device": {"ms_per_step": s_times, "losses": s_losses,
                             "grad_norms": s_norms,
                             "peak_device_bytes": s_peak}}
    if replay:
        if (r_losses, r_norms) != (losses, norms) or r_digests != digests:
            bad = sorted(k for k in digests if r_digests.get(k)
                         != digests[k])
            die(f"mesh_cells {arch} over {mesh_shape}: the replay differs: "
                f"losses {r_losses} vs {losses}, leaves {bad[:6]}")
        rec["replay_equal"] = True
    del batch, g_one, g_mesh
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def mesh_serve(np, torch, arch: str, args, counters) -> dict:
    """``serve_p99`` (512 rows) and ``retrieval_cand`` (2^20 vbyte
    candidates) of ``arch`` at full width over ``make_mesh(MESH_SERVE)``
    through ``registry.run_cell`` (the serving rule: the item table split
    by rows, BST's MLP by columns and rows), against the cell's function
    on one device: SASRec's scores and ids bit for bit, BST's scores
    within MESH_SERVE_RTOL of the largest and its ids equal; retrieval
    launches one kernel a shard a request (kernel 2's ``dot_score`` or
    kernel 1), counted exactly; ms beside the single device's."""
    from repro_torch.configs.shapes import RECSYS_SHAPES
    from repro_torch.distributed import make_mesh
    from repro_torch.distributed.sharding import whole
    from repro_torch.models import recsys, registry

    mesh = make_mesh(MESH_SERVE, ("data", "model"))
    shards = mesh.size
    cfg = registry.resolve_config(arch, "serve_p99")
    params = recsys.init_params(cfg, seed=args.seed, device="cuda")
    rng = np.random.default_rng(args.seed + 13)
    dot = cfg.kind in ("sasrec", "bert4rec")
    rec = {"arch": arch, "mesh": mesh.shape}

    def timed(fn):
        out = fn()
        torch.cuda.synchronize()
        ms = []
        for _ in range(MESH_SERVE_CALLS):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return out, float(np.median(ms))

    def hold(what, got, want):
        if dot:
            ok = torch.equal(got, want)
            err = float((got.float() - want.float()).abs().max())
        else:
            err = float((got.float() - want.float()).abs().max()
                        / want.float().abs().max())
            ok = err <= MESH_SERVE_RTOL
        rec.setdefault("held", {})[what] = err
        if not ok:
            die(f"mesh_cells {arch} {what}: {err} from the single device's "
                f"({'bit for bit' if dot else MESH_SERVE_RTOL})")

    with torch.inference_mode():
        cell = registry.build_cell(arch, "serve_p99", mesh_dp=1)
        batch = registry.recsys_batch_for(cfg, RECSYS_SHAPES["serve_p99"],
                                          rng, device="cuda")
        (out, placed), ms = timed(lambda: registry.run_cell(
            cell, mesh, params, batch))
        want, s_ms = timed(lambda: cell.fn(params, batch))
        hold("serve_p99 scores", whole(out), want)
        rec["serve_p99"] = {"batch": int(batch["hist"].shape[0]), "ms": ms,
                            "single_device_ms": s_ms,
                            "split_leaves": sorted(
                                k for k, v in placed.leaves.items()
                                if type(v).__name__ == "BlockSharded")}
        del out, placed, want
        cell = registry.build_cell(arch, "retrieval_cand", mesh_dp=1)
        batch = registry.recsys_batch_for(
            cfg, RECSYS_SHAPES["retrieval_cand"], rng, device="cuda")
        arr = batch["cands"]
        before = _read(torch, counters)
        got, placed = registry.run_cell(cell, mesh, params, batch)
        after = _read(torch, counters)
        per = {"vbyte_decode_blocked": after["vbyte_decode_blocked"]
               - before["vbyte_decode_blocked"],
               "vbyte/dot_score": after["fused_decode_by"].get(
                   "vbyte/dot_score", 0) - before["fused_decode_by"].get(
                   "vbyte/dot_score", 0)}
        want_per = ({"vbyte_decode_blocked": 0, "vbyte/dot_score": shards}
                    if dot else {"vbyte_decode_blocked": shards,
                                 "vbyte/dot_score": 0})
        if per != want_per:
            die(f"mesh_cells {arch} retrieval: launches a request {per}, "
                f"expected {want_per} (one a shard)")
        (got, _), ms = timed(lambda: registry.run_cell(cell, mesh, placed,
                                                       batch))
        want, s_ms = timed(lambda: cell.fn(params, batch))
        scores, (top_s, top_i) = got
        w_scores, (w_top_s, w_top_i) = want
        hold("retrieval scores", scores, w_scores)
        hold("retrieval top scores", top_s, w_top_s)
        ids_equal = bool(torch.equal(top_i, w_top_i))
        if dot and not ids_equal:
            die(f"mesh_cells {arch} retrieval: top ids differ")
        table = (cfg.vocab_rows * cfg.embed_dim * 2) if dot else 0
        rec["retrieval_cand"] = {
            "n_candidates": arr.n, "n_blocks": arr.n_blocks,
            "shards": shards, "launches_per_request": per,
            "ms_per_request": ms, "single_device_ms_per_request": s_ms,
            "top100_ids_equal": ids_equal,
            "top100_overlap": len(set(top_i.tolist())
                                  & set(w_top_i.tolist())),
            # kernel 2 reads one whole bf16 table: a copy on each distinct
            # device of the mesh (one here, 4 logical shards of one card)
            "dot_table_bytes_per_card": table,
            "table_copies": len(set(map(str, mesh.devices.flat)))
            if dot else 0}
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def run_mesh_cells(np, torch, args) -> dict:
    """Path ``mesh_cells``: ``dp_train`` (SASRec and two-tower over
    MESH_DP), ``mp_recsys_train`` (BST and two-tower over MESH_MP, with a
    replay) and ``mp_recsys_serve`` (SASRec and BST over MESH_SERVE);
    every launch count set to 0 just before the path and read just after
    (training launches none; retrieval one a shard a request over the
    mesh, one a request on the single device)."""
    t_path = time.perf_counter()
    counters = _launch_counters()
    _reset(torch, counters)
    phases, out = {}, {"dp_train": {}, "mp_recsys_train": {},
                       "mp_recsys_serve": {}}
    for arch in ("sasrec", "two-tower-retrieval"):
        t0 = time.perf_counter()
        out["dp_train"][arch] = rec = mesh_train(np, torch, arch, MESH_DP,
                                                 args, replay=False)
        emit("dp_train", **rec)
        phases[f"dp_train/{arch}"] = time.perf_counter() - t0
    for arch in ("bst", "two-tower-retrieval"):
        t0 = time.perf_counter()
        out["mp_recsys_train"][arch] = rec = mesh_train(
            np, torch, arch, MESH_MP, args, replay=True)
        emit("mp_recsys_train", **rec)
        phases[f"mp_recsys_train/{arch}"] = time.perf_counter() - t0
    for arch in ("sasrec", "bst"):
        t0 = time.perf_counter()
        out["mp_recsys_serve"][arch] = rec = mesh_serve(np, torch, arch,
                                                        args, counters)
        emit("mp_recsys_serve", **rec)
        phases[f"mp_recsys_serve/{arch}"] = time.perf_counter() - t0
    launches = _read(torch, counters)
    # each retrieval cell: 1 + MESH_SERVE_CALLS + 1 mesh requests (the
    # counted one, the warm-up, the timed ones), then 1 + MESH_SERVE_CALLS
    # single-device ones
    shards = MESH_SERVE[0] * MESH_SERVE[1]
    mesh_req, one_req = 2 + MESH_SERVE_CALLS, 1 + MESH_SERVE_CALLS
    per_cell = shards * mesh_req + one_req
    want = dict.fromkeys(counters, 0)
    want.update(vbyte_decode_blocked=per_cell, fused_decode=per_cell)
    if {k: launches[k] for k in counters} != want or launches[
            "fused_decode_by"] != {"vbyte/dot_score": per_cell}:
        die(f"mesh_cells: launches {launches}, expected {want}")
    seconds = time.perf_counter() - t_path
    emit("path_done", path="mesh_cells", seconds=round(seconds, 3),
         phase_seconds={k: round(v, 3) for k, v in phases.items()},
         launches=launches)
    return {"launches": launches, "seconds": seconds, **out}


# ---------------------------------------------------------------------------
# path sharded: block-sharded decode and the mesh-served engines, and the
# device encoder
# ---------------------------------------------------------------------------
SHARDED_SHARDS = 8
# the search queries of each path served over the mesh: its first three
# (and, or, topk; at 10, a topk_driver query over a K=20 driver makes
# ~4,640 whole-list decode calls: PERF.md), plus _maxscore_query and
# _scored_query (a topk_driver)
SHARDED_QUERIES = 3
SHARDED_TT_REQUESTS = 64  # two-tower requests over the mesh, at bucket 8
SHARDED_TT_BAGS = 16
SHARDED_PARITY_BLOCKS = (N_PARITY_BLOCKS, N_PARITY_BLOCKS - 3)
SHARDED_TABLE_ROWS = (1 << 20) + 512  # bag_sum / dot_score ids < 2^20
SHARDED_D = 64


def _sharded_mesh(torch):
    """``make_mesh((8,), ("data",))``: over the cards when there are
    several, else 8 logical shards of ``cuda:0``."""
    from repro_torch.distributed import make_mesh

    cards = torch.cuda.device_count()
    mesh = make_mesh((SHARDED_SHARDS,), ("data",))
    layout = (f"{SHARDED_SHARDS} logical shards on cuda:0" if cards == 1 else
              f"{SHARDED_SHARDS} shards over {cards} cards")
    return mesh, layout


def _mesh_worker(kind: str, state: dict, queries: list) -> dict:
    """A worker (a spawned process) over the same 8-shard mesh: the index
    placed on the card from its numpy leaves, then ``kind`` ``"replay"``
    (``SearchEngine(mesh=..., plan="torch")``: each query's answer,
    ``QueryStats`` as a dict and seconds) or ``"drill"`` (``validate=True``
    over ``HARDENED_SHARDS`` logical shards, ``serve.shard_loss_drill``
    over ``queries`` and one OR query of the victim shard's first term:
    the drill's counts and seconds, the healthy answers' digests, the
    launches)."""
    sys.path.insert(0, str(SRC))
    import torch

    from repro_torch.convert import index_from_numpy
    from repro_torch.index import QueryStats
    from repro_torch.launch.serve import (SearchEngine, SimClock,
                                          shard_loss_drill)

    index = index_from_numpy(**state, device="cuda")
    mesh, _ = _sharded_mesh(torch)
    if kind == "replay":
        engine = SearchEngine(index, mesh=mesh, top_k=10, plan="torch",
                              probe_width=512)
        out = []
        for mode, terms in queries:
            st = QueryStats()
            t0 = time.perf_counter()
            res = engine.search(terms, mode, stats=st)
            out.append((res, dataclasses.asdict(st),
                        time.perf_counter() - t0))
        return {"answers": out}
    counters = _launch_counters()
    _reset(torch, counters)
    clock = SimClock()
    engine = SearchEngine(index, mesh=mesh, validate=True,
                          n_shards=HARDENED_SHARDS, clock=clock)
    if engine.quarantined or engine.bound_unsafe:
        raise AssertionError(f"clean index gated: {engine.quarantined} "
                             f"{engine.bound_unsafe}")
    lo, _ = engine.shards[VICTIM_SHARD]
    qs = list(queries) + [("or", [engine.term_order[lo]])]
    d = shard_loss_drill(engine, qs, clock, victim=VICTIM_SHARD)
    return {**{k: v for k, v in d.items() if k != "healthy"},
            "validate_seconds": engine.validate_seconds,
            "digests": [_digest(a) for a in d["healthy"]],
            "launches": _read(torch, counters)}


def _delta(a: dict, b: dict) -> dict:
    """Launch counts of ``b`` minus those of ``a`` (both from ``_read``)."""
    out = {k: b[k] - v for k, v in a.items() if isinstance(v, int)}
    out["fused_decode_by"] = dict(Counter(b["fused_decode_by"])
                                  - Counter(a["fused_decode_by"]))
    return out


def sharded_parity(np, torch, mesh, counters) -> dict:
    """Phase ``sharded_parity``: each format at the parity layout (4,096
    blocks, and 4,093 so the padding shows) through ``decode(sh,
    plan="sharded")`` for ``stream`` and every kernel 2 epilogue, bit for
    bit against the unsharded launch, padding rows zero, 8 launches a
    call."""
    from repro_torch.core import CompressedIntArray
    from repro_torch.core.compressed_array import FORMAT_LEAVES
    from repro_torch.distributed import BlockSharded
    from repro_torch.kernels.vbyte_decode import dispatch, epilogues

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    g = torch.Generator(device="cuda")
    g.manual_seed(11)
    table = torch.randn(SHARDED_TABLE_ROWS, SHARDED_D, device="cuda",
                        generator=g).to(torch.bfloat16)
    query = torch.randn(8, SHARDED_D, device="cuda",
                        generator=g).to(torch.bfloat16)
    calls = 0
    for fmt, _, datasets in _parity_plan(rng):
        label, bits = datasets[0]
        for nb in SHARDED_PARITY_BLOCKS:
            enc, w_enc, bases = _dataset(np, rng, fmt, n_blocks=nb, bits=bits)
            leaves = {k: getattr(enc, k) for k in FORMAT_LEAVES[fmt]}
            arr = CompressedIntArray.from_operands(
                {**leaves, "bases": bases}, format=fmt, block_size=BLOCK,
                differential=True)
            w = CompressedIntArray.from_operands(
                {k: getattr(w_enc, k) for k in FORMAT_LEAVES[fmt]},
                format=fmt, block_size=BLOCK)
            sh, wsh = arr.shard(mesh), w.shard(mesh)
            nbp = sh.n_blocks
            grid = dispatch.decode(arr).cpu().numpy()
            ex = _extras(np, torch, rng, grid, enc.counts, {}, dev)
            rows = torch.full((nbp, 1), -1, dtype=torch.int32, device=dev)
            rows[:nb] = ex["probe_r"]
            eb = torch.as_tensor(rng.integers(0, 1 << 20, (nbp, BLOCK))
                                 .astype(np.int32), device=dev)
            w_ops = {f"w_{k}": v for k, v in wsh.device_operands().items()
                     if k not in ("counts", "bases")}
            cases = {"stream": {}, "checksum": {},
                     "membership": {"probe": ex["probe_b"]},
                     "membership_rows": {"probe": rows},
                     "bm25_accum": {"probe": ex["probe_b"],
                                    "impact": ex["impact"]},
                     "bm25_accum_rows": {"probe": rows,
                                         "impact": ex["impact"]},
                     "bm25_weighted": {"probe": ex["probe_b"], **w_ops},
                     "bm25_weighted_rows": {"probe": rows, **w_ops},
                     "bag_sum": {"table": table},
                     "dot_score": {"table": table, "query": query},
                     "adjacency_rebase": {"edge_base": eb}}
            if set(cases) != set(epilogues.EPILOGUES):
                die(f"sharded_parity covers {sorted(cases)}, kernel 2 has "
                    f"{sorted(epilogues.EPILOGUES)}")
            for ep, extras in cases.items():
                single = {k: (v.gather()[:nb] if isinstance(v, BlockSharded)
                              else v[:nb] if v.shape[0] == nbp else v)
                          for k, v in extras.items()}
                before = _read(torch, counters)
                out = dispatch.decode(sh, epilogue=ep,
                                      epilogue_operands=extras,
                                      plan="sharded")
                n = sum(_delta(before, _read(torch, counters))[k]
                        for k in counters)
                if n != SHARDED_SHARDS:
                    die(f"sharded_parity {fmt}/{ep}: {n} launches for "
                        f"{SHARDED_SHARDS} shards")
                ref = dispatch.decode(arr, epilogue=ep,
                                      epilogue_operands=single)
                for o, r in zip(out if isinstance(out, tuple) else (out,),
                                ref if isinstance(ref, tuple) else (ref,)):
                    o = o.gather()
                    if not torch.equal(o[:nb], r):
                        die(f"sharded_parity {fmt}/{ep} at {nb} blocks "
                            "differs from the unsharded launch")
                    if (o[nb:].any() and not (ep == "dot_score"
                                              and o.is_floating_point())):
                        die(f"sharded_parity {fmt}/{ep}: padding rows not 0")
                calls += 1
    return {"formats": 3, "n_blocks": list(SHARDED_PARITY_BLOCKS),
            "epilogues": len(epilogues.EPILOGUES), "calls": calls,
            "launches_per_call": SHARDED_SHARDS, "bit_for_bit": True,
            "seconds": round(time.perf_counter() - t0, 3)}


def sharded_two_tower(np, torch, seed, mesh, counters) -> dict:
    """Phase ``sharded_two_tower``: ``ServingEngine(mesh=mesh)`` at the
    two_tower path's full width (2^23 items, 2^20 candidates), 64 requests
    at bucket 8 and 16 bags; then the single-device engine on the same
    requests and bags (after the path's launch counts are read): top-k
    ids, scores and bags bit for bit. The mesh engine's peak bytes show
    one copy of the item table on the card."""
    from repro_torch.core import CompressedIntArray
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import recsys, registry
    from repro_torch.configs.shapes import RECSYS_SHAPES

    cfg = registry.resolve_config("two-tower-retrieval", "retrieval_cand")
    rng = np.random.default_rng(seed)
    params = recsys.init_params(cfg, seed=seed, device="cuda")
    n_cand = RECSYS_SHAPES["retrieval_cand"].dims["n_candidates"]
    cands = np.sort(rng.choice(np.arange(1, cfg.n_items, dtype=np.int64),
                               n_cand, replace=False)).astype(np.uint64)
    corpus = CompressedIntArray.encode(cands, differential=True,
                                       device="cuda")
    reqs = [(int(rng.integers(1, cfg.n_users)),
             rng.integers(1, cfg.n_items, cfg.seq_len).astype(np.int32))
            for _ in range(SHARDED_TT_REQUESTS)]
    bags = [np.sort(rng.choice(np.arange(1, cfg.n_items, dtype=np.int64),
                               int(n), replace=False))
            for n in rng.integers(0, cfg.seq_len + 1, SHARDED_TT_BAGS)]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def serve(engine):
        engine.warmup()
        rec = []
        stats = engine.run_workload(reqs, max_batch=8, record=rec)
        emb = [engine.embed_bags(bags[i:i + 8]).cpu()
               for i in range(0, len(bags), 8)]
        return stats, rec, emb

    engine = ServingEngine(params, cfg, corpus, mesh=mesh, top_k=10)
    table_bytes = engine.item_table.numel() * engine.item_table.element_size()
    copies = len(engine._table.copies)
    stats, rec, emb = serve(engine)
    launches = _read(torch, counters)  # the path's count window ends here
    peak = torch.cuda.max_memory_allocated()
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    single = ServingEngine(params, cfg, corpus, top_k=10)
    _, rec1, emb1 = serve(single)
    for (s, i), (s1, i1) in zip(rec, rec1):
        if not (torch.equal(s, s1) and torch.equal(i, i1)):
            die("sharded_two_tower: top-k differs from the single-device "
                "engine's")
    if not all(torch.equal(a, b) for a, b in zip(emb, emb1)):
        die("sharded_two_tower: bags differ from the single-device engine's")
    n_blocks = corpus.n_blocks
    del single, params, corpus
    gc.collect()
    torch.cuda.empty_cache()
    return {"requests": len(reqs), "bags": len(bags), "max_batch": 8,
            "qps": stats["qps"], "p50_ms": stats["p50_ms"],
            "p99_ms": stats["p99_ms"], "n_devices": stats["n_devices"],
            "corpus_blocks": n_blocks, "table_bytes": table_bytes,
            "table_copies": copies,
            # the engine's peak over what was allocated before it (the
            # params, the corpus, the search indexes): its one item table,
            # its bf16 bag table and the item tower's transients
            "peak_device_bytes_over_base": peak - base,
            "allocated_before_engine_bytes": base, "equal": True,
            "launches": launches}


def device_encode(np, torch, lists: dict) -> dict:
    """Phase ``device_encode``: ``encode_blocked_device`` on the card over
    every search posting (padded to a multiple of 128, stride 640), both
    differential settings: the non-differential bytes and bases bit for
    bit against the host encoder, both outputs through kernel 1 bit for
    bit; ms and G ints/s beside the host encoder's seconds."""
    from repro_torch.core.vbyte import encode as venc
    from repro_torch.core.vbyte.device_encode import encode_blocked_device
    from repro_torch.kernels.vbyte_decode.kernel import (
        vbyte_decode_blocked_cuda)

    vals = np.concatenate([lists[t] for t in sorted(lists)]).astype(np.uint32)
    n = vals.size
    padded = np.zeros(-(-n // BLOCK) * BLOCK, np.uint32)
    padded[:n] = vals
    t0 = time.perf_counter()
    host = venc.encode_blocked(vals, block_size=BLOCK, differential=False,
                               stride_multiple=640, min_stride=640)
    host_s = time.perf_counter() - t0
    x = torch.as_tensor(padded.view(np.int32), device="cuda")
    out = {"n_ints": n, "n_blocks": padded.size // BLOCK, "stride": 640,
           "host_encoder_seconds": round(host_s, 3)}
    for differential in (False, True):
        kw = dict(block_size=BLOCK, stride=640, differential=differential)
        torch.cuda.reset_peak_memory_stats()
        enc = encode_blocked_device(x, **kw)  # warm-up
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        enc = encode_blocked_device(x, **kw)
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end)
        if not differential and not (
                torch.equal(enc["payload"].cpu(),
                            torch.as_tensor(host.payload))
                and np.array_equal(enc["bases"].cpu().numpy()
                                   .view(np.uint32), host.bases)):
            die("device_encode: bytes or bases differ from the host "
                "encoder's")
        dec = vbyte_decode_blocked_cuda(enc["payload"], enc["counts"],
                                        enc["bases"], block_size=BLOCK,
                                        differential=differential)
        if not torch.equal(dec.reshape(-1), x):
            die(f"device_encode differential={differential}: kernel 1 "
                "does not give the values back")
        out[f"diff={int(differential)}"] = {
            "ms": round(ms, 6), "gints_per_s": round(n / ms / 1e6, 3),
            "payload_bytes": enc["payload"].numel(),
            "peak_device_bytes": torch.cuda.max_memory_allocated(),
            "roundtrip_kernel1": True}
        del enc, dec
    out["bytes_equal_host"] = True
    del x
    torch.cuda.empty_cache()
    return out


def _maxscore_query(lists: dict) -> tuple:
    """A ``topk_maxscore`` query over the two shortest lists: the mode
    over the mesh at the cost of two short whole-list passes (the
    stream's first one, over long lists, took ~7 s a path there)."""
    by_size = sorted(lists, key=lambda t: (lists[t].size, t))
    return ("topk_maxscore", [int(by_size[0]), int(by_size[1])])


def _scored_query(lists: dict) -> tuple:
    """A ``topk_driver`` query over the shortest list, scored by the two
    longest: each of its decode calls runs kernel 2's ``bm25_weighted``
    over a whole long list, one call per 512 candidates of the driver."""
    by_size = sorted(lists, key=lambda t: (lists[t].size, t))
    return ("topk_driver", [int(by_size[0]), int(by_size[-1]),
                            int(by_size[-2])])


def run_sharded(np, torch, args, search: dict) -> dict:
    """Path ``sharded``: block-sharded decode on an 8-shard mesh and the
    mesh-served engines over the search paths' indexes (still on the card)
    and two-tower at full width, then the device encoder. Every launch
    count is set to 0 just before ``sharded_search`` and read after the
    mesh two-tower engine served; the degraded drill's worker adds its
    own. The timed phases run with no worker process alive; then the
    drill and the plain-plan replays run in spawned workers, side by
    side."""
    t_path = time.perf_counter()
    mesh, layout = _sharded_mesh(torch)
    names = tuple(search["indexes"])
    extra = [_maxscore_query(search["lists"]), _scored_query(search["lists"])]
    qs = {n: search["qs"][:min(SHARDED_QUERIES, search["n_queries"][n])]
          + extra for n in names}
    counters = _launch_counters()
    from repro_torch.launch.serve import SearchEngine

    emit("sharded_parity", layout=layout,
         device_count=torch.cuda.device_count(),
         **sharded_parity(np, torch, mesh, counters))
    # the single-device answers: the main path's, and the two extra
    # queries' from the single-device engine over the same index
    expect = {}
    for n in names:
        single = SearchEngine(search["indexes"][n], top_k=10, plan="auto",
                              probe_width=512)
        expect[n] = (search["digests"][n][:len(qs[n]) - len(extra)]
                     + [_digest(single.search(t, m)) for m, t in extra])
        del single
    _reset(torch, counters)
    searched = {}
    for n in names:
        engine = SearchEngine(search["indexes"][n], mesh=mesh, top_k=10,
                              plan="auto", probe_width=512)
        before = _read(torch, counters)
        record = []
        stats = engine.run_workload(qs[n], record=record)
        used = _delta(before, _read(torch, counters))
        k = len(qs[n])
        if [_digest(a) for a, _, _ in record] != expect[n]:
            die(f"sharded_search {n}: answers differ from the single-device "
                "engine's")
        core = PATH_KERNELS[n][1]
        if not used["fused_decode_by"].get(core + "/bm25_weighted"):
            die(f"sharded_search {n}: kernel 2's {core}/bm25_weighted was "
                f"never launched: {used}")
        searched[n] = record
        emit("sharded_search", path=n, layout=layout,
             device_count=torch.cuda.device_count(), queries=k,
             modes=[m for m, _ in qs[n]], maxscore_query=extra[0][1],
             scored_query=extra[1][1],
             qps=stats["qps"], p50_ms=stats["p50_ms"],
             p99_ms=stats["p99_ms"], mean_ms=stats["mean_ms"],
             n_devices=stats["n_devices"],
             blocks_decoded=stats["blocks_decoded"],
             decode_calls=stats["decode_calls"],
             resident_bytes=sum(
                 tp.arr.resident_bytes + tp.impacts.resident_bytes
                 for tp in engine.index.terms.values()),
             launches_per_query={
                 **{kk: round(v / k, 2) for kk, v in used.items()
                    if isinstance(v, int) and v},
                 **{kk: round(v / k, 2) for kk, v in
                    used["fused_decode_by"].items()}},
             single_device_answers_equal=True,
             note="one card: the shards run one after another on one "
                  "device, so this QPS is not a multi-card figure; no "
                  "worker process runs beside it")
        del engine
    two_tower = sharded_two_tower(np, torch, args.seed, mesh, counters)
    launches = two_tower.pop("launches")
    emit("sharded_two_tower", layout=layout, **two_tower)
    enc = device_encode(np, torch, search["lists"])
    emit("device_encode", **enc)
    t_workers = time.perf_counter()
    with ProcessPoolExecutor(max_workers=len(names) + 1,
                             mp_context=mp.get_context("spawn")) as pool:
        drill = pool.submit(_mesh_worker, "drill",
                            _index_state(search["indexes"]["vbyte"]),
                            qs["vbyte"])
        replays = {n: pool.submit(
            _mesh_worker, "replay",
            _index_state(search["indexes"][n], checksums=False), qs[n])
            for n in names}
        replay_s = {}
        for n in names:
            got = replays[n].result()["answers"]
            replay_s[n] = round(sum(s for _, _, s in got), 3)
            for (mode, terms), (a, sa, _), (b, sb, _) in zip(
                    qs[n], searched[n], got):
                if not _results_equal(np, a, b):
                    die(f"sharded_search {n}: the kernels and the torch plan "
                        f"disagree on {mode} {terms}")
                if dataclasses.asdict(sa) != sb:
                    die(f"sharded_search {n}: QueryStats differ from the "
                        f"torch plan's on {mode} {terms}")
        emit("sharded_search_parity", paths=list(names),
             queries={n: len(qs[n]) for n in names}, torch_plan_equal=True,
             query_stats_equal=True, torch_plan_query_seconds=replay_s,
             waited_seconds=round(time.perf_counter() - t_workers, 3),
             note="the replays and the drill run side by side")
        try:
            d = drill.result()
        except Exception as e:  # the worker's violation, with its message
            die(f"sharded_degraded: shard-loss drill failed: {e!r}")
    k = len(qs["vbyte"])
    if d.pop("digests")[:k] != expect["vbyte"]:
        die("sharded_degraded: the drill's healthy answers differ from the "
            "single-device engine's")
    launches = _merge_launches(launches, d.pop("launches"))
    emit("sharded_degraded", path="vbyte", layout=layout, **d,
         single_device_answers_equal=True,
         note="the three replay workers run beside the drill")
    by = launches["fused_decode_by"]
    for n in names:
        decode_kernel, core = PATH_KERNELS[n]
        if not launches[decode_kernel] or not any(
                k.startswith(core + "/") for k in by):
            die(f"sharded {n}: {decode_kernel} or kernel 2's {core} core "
                f"was never launched: {launches}")
    for key in ("vbyte/dot_score", "vbyte/checksum"):
        if not by.get(key):
            die(f"sharded: kernel 2's {key} was never launched: {launches}")
    seconds = time.perf_counter() - t_path
    emit("path_done", path="sharded", seconds=round(seconds, 3),
         layout=layout, launches=launches)
    return {"launches": launches, "seconds": seconds, "device_encode": enc}


# ---------------------------------------------------------------------------
# path analysis: the measured autotune cache, plan="auto" over it, and the
# dry run of every cell
# ---------------------------------------------------------------------------
ANALYSIS_KEYS = 33  # 3 formats × 11 epilogues, autotune's defaults
ANALYSIS_MESHES = ((1, 1), (4, 1))  # the dry run's (cards, 1) meshes


def _autotune_phase(torch, dispatch, cache_file: str, seed: int) -> dict:
    """``dispatch.autotune`` with its defaults on the card into
    ``cache_file`` (a temporary file): every key this card's, every
    entry's plan the kernels (the card's entries record times, they pick
    nothing), the file the only one written, the default cache
    untouched."""
    default = Path(dispatch.DEFAULT_CACHE_PATH)
    before = default.read_bytes() if default.exists() else None
    t0 = time.perf_counter()
    cache = dispatch.autotune(cache_file=cache_file, seed=seed)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    name = torch.cuda.get_device_name(0)
    kernels = dispatch.default_plan(torch.device("cuda"))
    bad = [k for k, v in cache.items()
           if not k.startswith(name + "/") or v["device"] != name
           or dispatch._entry_plan(v) != kernels
           or kernels.label not in v["candidates_ms"]]
    if len(cache) != ANALYSIS_KEYS or bad:
        die(f"autotune: {len(cache)} keys (expected {ANALYSIS_KEYS}), "
            f"not this card's or not the kernels': {bad[:4]}")
    written = os.listdir(os.path.dirname(cache_file))
    if written != [os.path.basename(cache_file)]:
        die(f"autotune wrote {written}")
    if (default.read_bytes() if default.exists() else None) != before:
        die(f"autotune changed the default cache {default}")
    table = {k[len(name) + 1:]: {
        "plan": dispatch._entry_plan(v).label,
        "fastest": min(v["candidates_ms"], key=v["candidates_ms"].get),
        "candidates_ms": v["candidates_ms"]}
        for k, v in sorted(cache.items())}
    emit("autotune", seconds=round(seconds, 3), keys=len(cache),
         workload=next(iter(cache.values()))["workload"],
         fastest=dict(Counter(r["fastest"] for r in table.values())),
         table=table)
    return cache


def _auto_cache_phase(torch, dispatch, cache: dict, cache_file: str,
                      seed: int, counters) -> dict:
    """The autotune's entries rewritten to name the torch decoder, written
    to ``cache_file`` and named as the cache: on every key ``plan="auto"``
    on the card still resolves to the kernels, launches a kernel and gives
    the explicit kernel plan's output bit for bit; no
    ``plan_cache_total`` is counted (card operands read no cache)."""
    from dataclasses import asdict

    from repro_torch import obs

    t0 = time.perf_counter()
    kernels = dispatch.default_plan(torch.device("cuda"))
    other = dispatch.DecodePlan("torch", fused=True)
    with open(cache_file, "w") as f:
        json.dump({k: {**v, "plan": asdict(other)} for k, v in cache.items()},
                  f)
    dispatch.load_cache(reload=True)
    tele = obs.Telemetry()
    held = 0
    for fmt in ("vbyte", "streamvbyte", "binpack"):
        ops, extras, _ = dispatch._synthetic_workload(
            fmt, n_blocks=64, block_size=BLOCK, vocab=4096, d=64, seed=seed,
            device="cuda")
        kw = dict(format=fmt, block_size=BLOCK, differential=True)
        for ep, ex in extras.items():
            if dispatch.cache_key(fmt, ep, BLOCK) not in cache:
                die(f"auto_cache: no autotune key for {fmt}/{ep}")
            resolved = dispatch.resolve_plan("auto", format=fmt, epilogue=ep,
                                             block_size=BLOCK,
                                             device=torch.device("cuda"))
            if resolved != kernels:
                die(f"auto_cache {fmt}/{ep}: auto resolves to "
                    f"{resolved.label} on the card, not {kernels.label}")
            before = sum(c.count for c in counters.values())
            with obs.install(tele):
                got = dispatch.decode(ops, epilogue=ep, epilogue_operands=ex,
                                      plan="auto", **kw)
            torch.cuda.synchronize()
            if sum(c.count for c in counters.values()) == before:
                die(f"auto_cache {fmt}/{ep}: auto launched no kernel")
            want = dispatch.decode(ops, epilogue=ep, epilogue_operands=ex,
                                   plan=kernels, **kw)
            for g, w in zip(got if isinstance(got, tuple) else (got,),
                            want if isinstance(want, tuple) else (want,)):
                if not torch.equal(g, w):
                    die(f"auto_cache {fmt}/{ep}: auto's output differs from "
                        f"the explicit {kernels.label} plan's")
            held += 1
    m = tele.registry.snapshot()["metrics"]
    calls = _counter_sum(m, "decode_calls_total")
    plans = {s["attrs"]["plan"] for s in tele.tracer.spans}
    if (calls != held or plans != {kernels.label}
            or _counter_sum(m, "plan_cache_total")):
        die(f"auto_cache: {calls} decode calls for {held} auto calls, "
            f"plans {plans}: {sorted(m)}")
    rec = {"keys_held": held, "cache_plan": other.label,
           "auto_plan": kernels.label, "decode_calls": calls,
           "plan_cache_total": 0, "max_abs_err": 0.0,
           "seconds": round(time.perf_counter() - t0, 3)}
    emit("auto_cache", **rec)
    return rec


def _dryrun_phase(sharded_state_bytes: dict) -> dict:
    """``dryrun.run_cell`` over every cell at ``(1, 1)`` and ``(4, 1)``
    (``meta``: no card): a line a cell. Then the state check: h2o-danube's
    ``train_4k`` params and optimizer state with ZeRO-1 over ``(4, 1)`` at
    its largest position equal, to the byte, the largest shard of path
    ``sharded_train``'s placed state on the card."""
    from repro_torch.launch import dryrun
    from repro_torch.models import registry

    t0 = time.perf_counter()
    rows = {}
    for arch, shape, _ in registry.all_cells():
        row = {}
        for mesh_shape in ANALYSIS_MESHES:
            r = dryrun.run_cell(arch, shape, mesh_shape=mesh_shape)
            row["x".join(map(str, mesh_shape))] = {
                "bytes_per_card": r["argument_bytes_per_device"],
                "fits_80GB": r["fits_80GB"],
                "dominant": r["roofline"]["dominant"],
                "bound_s": r["roofline"]["step_time_bound_s"]}
        rows[f"{arch}/{shape}"] = row
        emit("dryrun", cell=f"{arch}/{shape}", **row)
    r = dryrun.run_cell(LM_TRAIN_ARCH, "train_4k",
                        mesh_shape=(SHARDED_TRAIN_SHARDS, 1),
                        overrides={"zero1": True})
    parts = r["argument_bytes_by_part"]
    state = parts["params"] + parts["optimizer"]
    measured = max(sharded_state_bytes["per_shard"])
    if state != measured:
        die(f"dryrun state check: {state} bytes of state a card against "
            f"the sharded_train path's {measured}")
    rec = {"cells": len(rows), "meshes": ["x".join(map(str, m))
                                          for m in ANALYSIS_MESHES],
           "state_check": {"arch": LM_TRAIN_ARCH, "mesh": r["mesh"],
                           "zero1": True, "dryrun_state_bytes": state,
                           "sharded_train_per_shard_max": measured,
                           "equal": True},
           "seconds": round(time.perf_counter() - t0, 3)}
    emit("dryrun_done", **rec)
    return rec


def run_analysis(np, torch, args, sharded_train: dict) -> dict:
    """Path ``analysis``: ``autotune`` (all 33 keys on the card into a
    temporary file), ``auto_cache`` (``plan="auto"`` over a cache naming
    the torch decoder) and ``dryrun`` (every cell on ``meta``, and the
    state check against path ``sharded_train``); every launch count set to
    0 just before the path and read just after (the autotune's and
    auto_cache's kernel launches). The cache setting is restored after
    ``auto_cache``."""
    import shutil

    from repro_torch.kernels.vbyte_decode import dispatch

    t_path = time.perf_counter()
    counters = _launch_counters()
    _reset(torch, counters)
    tmp = tempfile.mkdtemp(prefix="autotune_")
    cache_file = os.path.join(tmp, "autotune_torch.json")
    prev = os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE")
    try:
        cache = _autotune_phase(torch, dispatch, cache_file, args.seed)
        tune = _read(torch, counters)
        os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = cache_file
        auto = _auto_cache_phase(torch, dispatch, cache, cache_file,
                                 args.seed, counters)
    finally:
        if prev is None:
            os.environ.pop("REPRO_TORCH_AUTOTUNE_CACHE", None)
        else:
            os.environ["REPRO_TORCH_AUTOTUNE_CACHE"] = prev
        dispatch.load_cache(reload=True)
        shutil.rmtree(tmp, ignore_errors=True)
    launches = _read(torch, counters)
    if not (launches["fused_decode"] and launches["vbyte_decode_blocked"]
            and launches["stream_decode_blocked"]
            and launches["binpack_decode_blocked"]):
        die(f"analysis: a decode kernel was never launched: {launches}")
    dry = _dryrun_phase(sharded_train["train"]["state_bytes"])
    seconds = time.perf_counter() - t_path
    emit("path_done", path="analysis", seconds=round(seconds, 3),
         autotune_launches=tune, launches=launches)
    return {"launches": launches, "seconds": seconds,
            "autotune_launches": tune, "auto_cache": auto, "dryrun": dry}


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
                                  "library_ms", "d", "gathered_rows_bound_ms")
                if f in r}

    def decode_entry(name, source, replaces):
        # the parity shape's times, and the whole search index in one
        # launch (phase parity_decode_scale)
        return dict(entry(name, source, replaces,
                          records[name]["S128/diff=1"]),
                    scale=variant(records[name]["scale"]))

    gin = paths["gin"]
    owner = gin["owner_sum"]["layer1"]
    back = paths["gin_train"]["owner_sum_backward"]
    max_err = {**max_err, "owner_sum": max(
        r["max_abs_err"] for r in gin["owner_sum"].values()),
        "owner_sum_backward": back["max_abs_err"],
        "fused_decode": max(max_err["fused_decode"],
                            gin["gin_rebase"]["max_abs_err"])}
    line = {"kernels": [
        dict(decode_entry("vbyte_decode_blocked", "vbyte_decode.cu",
                          "kernel.py:167"),
             gin_gaps=variant(gin["gin_gaps"]),
             # the LM token pipeline's shard: 8 × 4,097 tokens, 257 blocks
             lm_pipeline=variant(paths["lm"]["kernel1"])),
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
             # dot_score at the recsys path's retrieval_cand shape: SASRec
             # (bf16 d 50) and BERT4Rec (bf16 d 64), one query row
             recsys_dot_score={k: variant(r) for k, r in
                               records["recsys_dot_score"].items()},
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
             gathered_rows_bound_ms=owner["gathered_rows_bound_ms"],
             shapes={k: variant(r) for k, r in gin["owner_sum"].items()}),
        dict(entry("owner_sum_backward", "owner_sum.cu", "nn/gnn.py:43",
                   back, src="src/repro_torch/kernels/segment_sum/csrc/",
                   ref="src/repro/"),
             replaces_note="the transpose of jnp.take in gin_layer (XLA's "
                           "scatter-add of the gradient, from jax.grad; "
                           "the reference has no pallas_call there): the "
                           "same kernel over the edges grouped by source",
             library_ms=back["library_ms"], library=back["library"],
             gathered_rows_bound_ms=back["gathered_rows_bound_ms"],
             launches_per_step=paths["gin_train"]["launches"][
                 "owner_sum_backward"] / GIN_TRAIN_STEPS,
             shape={k: back[k] for k in ("n_rows", "n_valid_edges", "d",
                                         "grad_dtype", "accumulate")},
             checks=back["checks"]),
    ], "library_ms_note": "no single PyTorch call computes any of the "
                          "decodes; the gather epilogues' unfused_chain_ms "
                          "is decode kernel + one PyTorch call; owner_sum's "
                          "library_ms is cuSPARSE SpMM in f32 (the "
                          "backward's over the transposed CSR)",
        "shapes": "B=128, stride 128, 4096 blocks, differential, cold L2; "
                  "gather tables [8389120, 256] bf16 and [8389120, 128] f32; "
                  "decode scale: every search-index posting in one launch; "
                  "owner_sum: the gin graph's layer 1 (bf16 [N, 100], f32 "
                  "sums); owner_sum_backward: f32 gradients [N, 64] over "
                  "the gin graph's edges grouped by source"}
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=10,
                    help="queries of the format='auto' path")
    ap.add_argument("--svb-queries", type=int, default=10,
                    help="queries of the format='streamvbyte' path")
    ap.add_argument("--vbyte-queries", type=int, default=10,
                    help="queries of the format='vbyte' path")
    ap.add_argument("--k20-lists", type=int, default=16,
                    help="K=20 lists of every path")
    ap.add_argument("--profile-queries", type=int, default=3,
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
    # cuBLAS picks the same algorithms and reduction order on every call
    # (phase gin_train's replay and restart are held bit for bit)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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
    paths, search = phase_main_paths(np, torch, args)
    paths["two_tower"] = run_two_tower(np, torch, args)
    paths["recsys"] = run_recsys(np, torch, args)
    paths["lm"] = run_lm(np, torch, args)
    paths["sharded_train"] = run_sharded_train(np, torch, args, paths["lm"])
    paths["model_parallel"] = run_model_parallel(np, torch, args)
    paths["mesh_cells"] = run_mesh_cells(np, torch, args)
    paths["sharded"] = run_sharded(np, torch, args, search)
    del search  # the search indexes leave the card
    gc.collect()
    torch.cuda.empty_cache()
    paths["gin"] = run_gin(np, torch, args)
    paths["gin_train"] = paths["gin"].pop("train")
    paths["gin_mesh"] = paths["gin"].pop("mesh")
    paths["analysis"] = run_analysis(np, torch, args,
                                     paths["sharded_train"])
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
