#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                       # the full run
    python3 chip_smoke.py --queries 4 --svb-queries 3 --vbyte-queries 3 \
        --k20-lists 2 --profile-queries 2 --tt-requests 32 --tt-bags 16 \
        --gin-scale 0.05                        # a short one, every path

Drives the port (``src/repro_torch``) through the entry points a user
calls, on the card, and fails (exit code ≠ 0, no result line) on any
fault. One JSON line per phase:

1. device — the card's name, count and power limit; no card: exit 2.
2. build — the four CUDA libraries compiled from ``csrc/`` in parallel
   (one nvcc per source), with the compiler's register / shared-memory
   report.
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
   then one PyTorch call); ``bag_sum`` also at B=50. Times from CUDA
   events with the L2 flushed before every launch.
4. search paths — a ClueWeb09-sized posting index (50M-doc universe, 16
   lists from each of the paper's length groups K=12, 16, 20, Zipf tfs,
   block_size 128) built onto the card three ways, each served by
   ``SearchEngine(plan="auto")`` with every launch count set to 0 just
   before its workload and read just after: ``format="vbyte"`` (the
   first 25 queries), ``format="auto"`` (100 queries; its per-list
   partition DPs run in worker processes, one ``build_index`` call per
   term, merged on the card) and ``format="streamvbyte"`` (the first 25).
   Every query's result and ``QueryStats`` is then held equal to the plain
   ``plan="torch"`` engine's on the card (the replay runs in 6 spawned
   worker processes, each placing the index on the card from its numpy
   leaves), and 10 AND/OR answers per path against numpy set operations
   on the host lists. A profiler window gives each path's device busy
   share.
5. path ``two_tower`` — two-tower-retrieval at full width (2^23 users and
   items) served by ``ServingEngine`` over 2^20 compressed candidates:
   256 requests drained at most 8, 4, 2 and 1 at a time, then 64 bags
   through ``embed_bags``; every top-k and bag held against the plain
   engine's, 5 requests against scores computed on the host.
6. path ``gin`` — gin-tu at full width over an ogbn-products-sized graph
   made from ``--seed``, adjacency compressed: both decodes of
   ``decode_compressed_edges``, ``forward`` and ``loss_fn``; edges held
   bit for bit against the raw CSR and the plain plan, logits against a
   forward over the raw adjacency.
7. the ``kernels`` line, the card line, and the result line.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
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
BAG_BLOCK = 50  # embed_bags: one bag of seq_len = 50 slots per block
GATHER_EPILOGUES = ("bag_sum", "dot_score", "adjacency_rebase")
# GIN logits over compressed vs raw adjacency, per node, relative to the
# node's largest |logit|: the two forwards sum the same messages in
# another order (index_add_ atomics on the card), and a changed f32 sum
# can move a bf16 rounding by one ulp (2^-8 relative) in each of 5 layers
GIN_RTOL = 2.0**-4


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
    from repro_torch.kernels.vbyte_decode import _build

    t0 = time.perf_counter()
    built = _build.build()
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
                    if differential and label == datasets[0][0]:
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
                        records["fused_decode"][f"{fmt}/{name}"] = rec
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


def phase_gather(np, torch, timer, tables, queries, records, max_err):
    """bag_sum, dot_score (1- and 8-row queries) and adjacency_rebase on
    each core over realistic ids (the retrieval corpus's layout: sorted item
    ids, per-bag differential, 4096 blocks of B = 128, count-0 blocks and
    ragged tails), plus bag_sum over the embedding-bag endpoint's B = 50
    bags: held against their plain versions and timed (L2 cold) beside
    the bound, the plain version and the unfused chain — the format's
    decode kernel, then one PyTorch call (``F.embedding_bag``; index +
    ``einsum``; the torch body of adjacency_rebase)."""
    import torch.nn.functional as F

    from repro_torch.kernels.vbyte_decode import epilogues
    from repro_torch.kernels.vbyte_decode.dispatch import (CUDA_DECODERS,
                                                           DecodePlan, decode)

    dev = torch.device("cuda")
    rng = np.random.default_rng(2)
    cases = [(fmt, BLOCK, True) for fmt in ("vbyte", "streamvbyte",
                                            "binpack")]
    cases.append(("vbyte", BAG_BLOCK, False))  # embed_bags' layout
    for fmt, B, differential in cases:
        lists = _id_lists(np, rng, N_PARITY_BLOCKS, B)
        enc = _encoders()[fmt](lists, block_size=B, differential=differential)
        names = epilogues.FORMAT_OPERANDS[fmt]
        leaves = [torch.as_tensor(np.ascontiguousarray(getattr(enc, k)),
                                  device=dev) for k in names]
        c = torch.as_tensor(enc.counts, device=dev)
        b = torch.as_tensor(enc.bases.view(np.int32), device=dev)
        ops = dict(zip(names, leaves), counts=c, bases=b)
        nb = c.shape[0]
        kw = dict(block_size=B, differential=differential)
        grid = CUDA_DECODERS[fmt](*leaves, c, b, **kw)
        valid = torch.arange(B, device=dev)[None, :] < c[:, None]
        n_valid = int(valid.sum())
        distinct_valid = int(torch.unique(grid[valid]).numel())
        distinct_all = distinct_valid + int(n_valid < nb * B)  # + pad row 0
        need = enc.payload_bytes + 8 * nb
        eb = torch.as_tensor(rng.integers(0, 2**31, (nb, B)).astype(np.int32),
                             device=dev)
        variants = _gather_variants(tables, queries,
                                    eb if differential else None)
        if B == BAG_BLOCK:
            variants = [v for v in variants if v[1] == "bag_sum"]
        for key, name, extras, tl in variants:
            kw1 = dict(format=fmt, **kw)
            kw2 = dict(epilogue=name, **kw1)
            fused = lambda: epilogues.fused_decode(ops, extras, **kw2)  # noqa: E731
            plain = lambda: epilogues.fused_decode_plain(ops, extras, **kw2)  # noqa: E731
            err, ulps = _hold(torch, fused(), plain(), tl,
                              f"kernel 2 [{fmt}/{key}] B={B}",
                              terms=_terms(name, extras, B),
                              s_abs=(_abs_sums(epilogues, ops, name, extras,
                                               kw1) if tl else None))
            max_err["fused_decode_float"] = max(
                max_err["fused_decode_float"], err)
            t = extras.get("table")
            es = t.element_size() if t is not None else 0
            d = t.shape[1] if t is not None else 0
            if name == "bag_sum":
                w = valid.to(t.dtype)
                chain = lambda: F.embedding_bag(  # noqa: E731
                    CUDA_DECODERS[fmt](*leaves, c, b, **kw), t, mode="sum",
                    per_sample_weights=w)
                bytes_moved = need + (distinct_valid + nb) * d * es
                n_ops, rate = n_valid * d, F32_FLOPS_PER_S
            elif name == "dot_score":
                q = extras["query"]
                nq = q.shape[0]
                eq = "tbd,d->tb" if nq == 1 else "tbd,qd->tbq"
                qq = q[0] if nq == 1 else q
                chain = lambda: torch.einsum(  # noqa: E731
                    eq, t[CUDA_DECODERS[fmt](*leaves, c, b, **kw)], qq)
                bytes_moved = (need + distinct_all * d * es + nq * d * es
                               + nb * B * 4 * (1 + nq))
                n_ops = 2 * nb * B * nq * d
                rate = BF16_FLOPS_PER_S if tl == "bf16" else F32_FLOPS_PER_S
            else:
                chain = lambda: decode(  # noqa: E731
                    ops, format=fmt, epilogue=name, epilogue_operands=extras,
                    plan=DecodePlan("cuda", fused=False), **kw)
                bytes_moved = need + 2 * nb * B * 4
                n_ops, rate = n_valid, INT_OPS_PER_S
            # the yardstick computes the same function (recorded, not held:
            # it is not the port's)
            want = plain()
            want = want[1] if name == "dot_score" else want
            got = chain()
            chain_err = (float((got.float() - want.float()).abs().max())
                         if got.is_floating_point() else
                         float((got != want).sum()))
            bound, by = _bound(bytes_moved=bytes_moved, ops=n_ops,
                               ops_per_s=rate)
            rec = {"format": fmt, "epilogue": key, "block_size": B,
                   "n_blocks": nb, "stride": leaves[-1].shape[1],
                   "differential": differential, "n_ids": n_valid,
                   "distinct_ids": distinct_valid, "max_abs_err": err,
                   "max_bf16_ulps": ulps,
                   "ms": timer.ms(fused, reps=30),
                   "plain_ms": timer.ms(plain, reps=5),
                   "unfused_chain_ms": timer.ms(chain, reps=10),
                   "unfused_chain_max_abs_err": chain_err,
                   "bound_ms": bound, "bound_by": by}
            suffix = "" if B == BLOCK else f"/B{B}"
            records["fused_decode"][f"{fmt}/{key}{suffix}"] = rec
            emit("parity_fused_decode_gather", **rec)


# ---------------------------------------------------------------------------
# phase 4: the main paths at full width
# ---------------------------------------------------------------------------
def _results_equal(np, a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def _index_state(index) -> dict:
    """The index as host numpy leaves: the arguments of
    ``repro_torch.convert.index_from_numpy``, sent to the replay workers."""
    def stream(a):
        return {**a.leaves_numpy(), "n": a.n, "format": a.format,
                "payload_bytes": a.payload_bytes, "checksums": a.checksums}

    return {"terms": {t: {"df": tp.df, "first_doc": tp.first_doc,
                          "last_doc": tp.last_doc,
                          "max_impact": tp.max_impact,
                          "arr": stream(tp.arr),
                          "impacts": stream(tp.impacts)}
                      for t, tp in index.terms.items()},
            "n_docs": index.n_docs, "block_size": index.block_size,
            "format": index.format, "impact_bits": index.impact_bits,
            "has_tf": index.has_tf}


def _replay(state: dict, queries: list) -> list:
    """A replay worker (a spawned process): place the index on the card
    from its numpy leaves and answer ``queries`` through the plain torch
    plan. Returns ``(result, QueryStats as a dict, seconds)`` per query."""
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
    return out


def _launch_counters():
    from repro_torch.kernels.vbyte_decode import (binpack_kernel, epilogues,
                                                  kernel, stream_kernel)

    return {"vbyte_decode_blocked": kernel.launches,
            "stream_decode_blocked": stream_kernel.launches,
            "binpack_decode_blocked": binpack_kernel.launches,
            "fused_decode": epilogues.launches}


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
                                    format="auto", device="cpu"))


def _build(name: str, lists: dict, tfs: dict, pool):
    """The path's index on the card. ``format="auto"`` spends seconds of
    host DP per long list, and a term's partition depends only on its own
    list and ``n_docs``: each term is built by its own ``build_index``
    call in ``pool`` (longest lists first) and the terms are merged."""
    from repro_torch.convert import index_from_numpy
    from repro_torch.data.synthetic import CLUEWEB_DOCS
    from repro_torch.index import build_index

    if name != "auto":
        return build_index(lists, tfs=tfs, n_docs=CLUEWEB_DOCS, format=name)
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
    # long as the workload several times over): identical results and
    # accounting; AND/OR also against numpy set operations
    t0 = time.perf_counter()
    parts = [list(range(i, len(qs), workers)) for i in range(workers)]
    state = _index_state(index)
    replayed = {}
    for part, outs in zip(parts, pool.map(
            _replay, [state] * workers, [[qs[i] for i in p] for p in parts])):
        replayed.update(zip(part, outs))
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
    del engine, index, record, replayed
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": seconds}


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
    groups = {12: 16, 16: 16, 20: args.k20_lists}
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
    with ProcessPoolExecutor(max_workers=workers,
                             mp_context=mp.get_context("spawn")) as pool:
        for name, n_queries in (("vbyte", args.vbyte_queries),
                                ("auto", args.queries),
                                ("streamvbyte", args.svb_queries)):
            paths[name] = run_path(
                np, torch, name, lists, tfs, qs[:n_queries], groups=groups,
                profile_queries=args.profile_queries, pool=pool,
                workers=workers)
    return paths


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
    forward pass and the loss."""
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
    if not by.get("vbyte/adjacency_rebase") or not launches[
            "vbyte_decode_blocked"]:
        die(f"gin did not launch kernel 2's adjacency_rebase and kernel 1: "
            f"{launches}")

    # checks: both decodes equal the raw CSR bit for bit; the plain torch
    # plan decodes the same edges; logits over the compressed and the raw
    # adjacency agree within the stated tolerance
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
    raw = {"feats": feats, "labels": labels, "edge_src": raw_nbr,
           "edge_dst": own}
    raw_cfg = dataclasses.replace(cfg, compressed_adjacency=False)
    with torch.inference_mode():
        logits_raw = gnn.forward(params, raw, raw_cfg)
    finite = bool(torch.isfinite(logits).all() and torch.isfinite(loss))
    row_max = logits_raw.abs().amax(dim=1).clamp(min=1e-6)
    rel = float(((logits - logits_raw).abs().amax(dim=1) / row_max).max())
    if not finite or logits.shape != (N, cfg.n_classes) or rel > GIN_RTOL:
        die(f"gin: logits finite={finite} shape={tuple(logits.shape)}, "
            f"compressed vs raw adjacency rel err {rel} > {GIN_RTOL}")
    emit("gin_parity", edges_equal=True, plans_equal=True,
         logits_rel_err=rel, logits_rtol=GIN_RTOL,
         logits_max_abs=float(logits_raw.abs().max()),
         seconds=round(time.perf_counter() - t0, 3))
    del logits_raw, raw
    with torch.inference_mode():
        share = _profile(torch, "gin",
                         lambda: gnn.forward(params, batch, cfg), 1,
                         unit="forwards")
    seconds = time.perf_counter() - t_path
    emit("path_done", path="gin", seconds=round(seconds, 3))
    del params, batch, comp, gaps, feats, labels, logits, nbr_f, own_f
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": seconds, "peak": peak,
            "busy_share": share}


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

    def entry(name, source, replaces, rec):
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
                                  "max_bf16_ulps") if f in r}

    line = {"kernels": [
        entry("vbyte_decode_blocked", "vbyte_decode.cu", "kernel.py:167",
              records["vbyte_decode_blocked"]["S128/diff=1"]),
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
             launches_by_epilogue={k: {"total": v, "by_path": by_path[k]}
                                   for k, v in sorted(by.items())}),
        entry("stream_decode_blocked", "stream_decode.cu",
              "stream_kernel.py:234",
              records["stream_decode_blocked"]["S128/diff=1"]),
        entry("binpack_decode_blocked", "binpack_decode.cu",
              "binpack_kernel.py:119",
              records["binpack_decode_blocked"]["S128/diff=1"]),
    ], "library_ms_note": "no single PyTorch call computes any of these "
                          "decodes; the gather epilogues' unfused_chain_ms "
                          "is decode kernel + one PyTorch call",
        "shapes": "B=128, stride 128, 4096 blocks, differential, cold L2; "
                  "gather tables [8389120, 256] bf16 and [8389120, 128] f32"}
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=100,
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
