#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                       # the full run
    python3 chip_smoke.py --queries 20 --svb-queries 10 --vbyte-queries 5 \\
        --k20-lists 2                           # a short one

Drives the port (``src/repro_torch``) through the entry points a user
calls, on the card, and fails (exit code ≠ 0, no result line) on any
fault. One JSON line per phase:

1. device — the card's name, count and power limit; no card: exit 2.
2. build — the four CUDA libraries compiled from ``csrc/`` in parallel
   (one nvcc per source), with the compiler's register / shared-memory
   report.
3. kernel parity — each kernel against its plain torch version on the
   same device tensors, bit for bit, at the main path's block layout
   (B=128, 4096 blocks, count-0 blocks, ragged tails, differential both
   ways): kernel 1 (vbyte decode) at strides 128 and 640 with all five
   byte lengths; kernel 3 (Stream-VByte decode) at stride 128 and at its
   widest (512) with all four byte lengths; kernel 4 (binpack decode) at
   stride 128 and with every width 0..32; kernel 2 (fused decode → each of
   its 8 epilogues) on the vbyte, streamvbyte and binpack cores, with a
   weight stream of the same format. Times from CUDA events with the L2
   flushed before every launch, beside the bound and the plain version's
   time.
4. main paths — a ClueWeb09-sized posting index (50M-doc universe, 16
   lists from each of the paper's length groups K=12, 16, 20, Zipf tfs,
   block_size 128) built onto the card three ways, each served by
   ``SearchEngine(plan="auto")`` with every launch count set to 0 just
   before its workload and read just after: ``format="vbyte"`` (the
   first 50 queries), ``format="auto"`` (100 queries; its per-list
   partition DPs run in worker processes, one ``build_index`` call per
   term, merged on the card) and ``format="streamvbyte"`` (the first 50).
   Every query's result and ``QueryStats`` is then held equal to the plain
   ``plan="torch"`` engine's on the card (the replay runs in 6 spawned
   worker processes, each placing the index on the card from its numpy
   leaves), and 10 AND/OR answers per path against numpy set operations
   on the host lists. A profiler window gives each path's device busy
   share.
5. the ``kernels`` line, the card line, and the result line.
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


def _bound(*, bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    max_err = {"fused_decode": 0}
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
    return records, max_err


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
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for cnt in counters.values():
        cnt.reset()
    record = []
    stats = engine.run_workload(qs, record=record)
    torch.cuda.synchronize()
    launches = {k: c.count for k, c in counters.items()}
    launches["fused_decode_by"] = dict(counters["fused_decode"].by)
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
    _profile(torch, name, engine, qs[:profile_queries])
    seconds = time.perf_counter() - t_path
    emit("path_done", path=name, seconds=round(seconds, 3))
    del engine, index, record, replayed
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "seconds": seconds}


def _profile(torch, name, engine, queries):
    """Device busy share and device time by kernel over the first few
    queries of the workload, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    if not queries:
        return
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for mode, terms in queries:
            engine.search(terms, mode)
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
    emit("profile", path=name, queries=len(queries),
         wall_ms=round(wall_us / 1e3, 3),
         device_busy_ms=round(busy / 1e3, 3),
         device_busy_share=round(busy / wall_us, 4) if busy else None,
         top_device=[{"name": k[:80], "ms": round(us / 1e3, 3), "count": c}
                     for us, k, c in rows[:8]])


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


# ---------------------------------------------------------------------------
# phase 5: the kernels line
# ---------------------------------------------------------------------------
def kernels_line(records, max_err, paths):
    src = "src/repro_torch/kernels/vbyte_decode/csrc/"
    ref = "src/repro/kernels/vbyte_decode/"
    by = Counter()
    for p in paths.values():
        by.update(p["launches"]["fused_decode_by"])
    timed = records["fused_decode"]
    head = max(timed, key=lambda k: (by.get(k, 0), k))

    def entry(name, source, replaces, rec):
        by_path = {p: v["launches"][name] for p, v in paths.items()}
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": ref + replaces,
                "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": max_err[name],
                "ms": rec["ms"], "plain_ms": rec["plain_ms"],
                "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
                "library_ms": None}

    line = {"kernels": [
        entry("vbyte_decode_blocked", "vbyte_decode.cu", "kernel.py:167",
              records["vbyte_decode_blocked"]["S128/diff=1"]),
        dict(entry("fused_decode", "fused_decode.cu", "epilogues.py:383",
                   timed[head]),
             timed_epilogue=head,
             epilogues={k: {"launches": by.get(k, 0),
                            **{f: r[f] for f in ("ms", "plain_ms", "bound_ms",
                                                 "bound_by", "max_abs_err")}}
                        for k, r in timed.items()}),
        entry("stream_decode_blocked", "stream_decode.cu",
              "stream_kernel.py:234",
              records["stream_decode_blocked"]["S128/diff=1"]),
        entry("binpack_decode_blocked", "binpack_decode.cu",
              "binpack_kernel.py:119",
              records["binpack_decode_blocked"]["S128/diff=1"]),
    ], "library_ms_note": "no single PyTorch call computes any of these "
                          "decodes",
        "shapes": "B=128, stride 128, 4096 blocks, differential, cold L2"}
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=100,
                    help="queries of the format='auto' path")
    ap.add_argument("--svb-queries", type=int, default=50,
                    help="queries of the format='streamvbyte' path")
    ap.add_argument("--vbyte-queries", type=int, default=50,
                    help="queries of the format='vbyte' path")
    ap.add_argument("--k20-lists", type=int, default=16,
                    help="K=20 lists of every path")
    ap.add_argument("--profile-queries", type=int, default=5,
                    help="queries per path traced by torch.profiler")
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
    emit("parity_done", seconds=round(time.perf_counter() - t_start, 3))
    paths = phase_main_paths(np, torch, args)
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
