#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                       # the full run
    python3 chip_smoke.py --queries 20 --k20-lists 2   # a short one

Drives the port (``src/repro_torch``) through the entry points a user
calls, on the card, and fails (exit code ≠ 0, no result line) on any
fault. One JSON line per phase:

1. device — the card's name, count and power limit; no card: exit 2.
2. build — both CUDA kernels compiled from ``csrc/`` in parallel, with the
   compiler's register / shared-memory report.
3. kernel parity — kernel 1 (vbyte decode) and kernel 2 (fused decode →
   each of its 8 epilogues) against their plain torch versions on the same
   device tensors, bit for bit, at the main path's block layout (B=128,
   strides 128 and 640, a few thousand blocks, count-0 blocks, ragged
   tails, all five byte lengths, differential both ways); times from CUDA
   events with the L2 flushed before every launch, beside the bound.
4. main path — a ClueWeb09-sized posting index (50M-doc universe, 16
   lists from each of the paper's length groups K=12, 16, 20, Zipf tfs,
   block_size 128) built onto the card, ~100 queries served by
   ``SearchEngine(plan="auto")`` with launch counts read around the
   workload, then every query answered again with ``plan="torch"`` and
   held equal in results and ``QueryStats``, and AND/OR results held
   against numpy set operations on the host lists.
5. the ``kernels`` line, the card line, and the result line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12  # CUDA-core rate of the data sheet's float32 line
L2_FLUSH_BYTES = 64 << 20  # > the 50 MB L2: every timed launch starts cold
BLOCK = 128
PROFILE_QUERIES = 5  # queries traced by torch.profiler for the busy share
CARD = ""  # "name, power limit" from nvidia-smi; set in phase 1


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
         python=sys.version.split()[0])
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


def _dataset(np, rng, *, n_blocks: int, max_bits: int):
    """Ragged blocked operands: every 7th block empty, the rest with 1..B
    values of 1..max_bits bits (one full block at max_bits so the stride
    reaches its widest), plus an aligned impact stream (< 2^8, as the
    index's) with the same counts."""
    from repro_torch.core.vbyte import encode as venc

    lists = []
    for i in range(n_blocks):
        n = 0 if i % 7 == 0 else (BLOCK if i == 1 else
                                  int(rng.integers(1, BLOCK + 1)))
        bits = max_bits if i == 1 else int(rng.integers(1, max_bits + 1))
        lists.append(rng.integers(0, 2**bits, size=n, dtype=np.uint64))
    enc = venc.encode_ragged_blocked(lists, block_size=BLOCK)
    w_enc = venc.encode_ragged_blocked(
        [rng.integers(1, 256, size=len(l), dtype=np.uint64) for l in lists],
        block_size=BLOCK)
    bases = rng.integers(0, 2**32, size=n_blocks, dtype=np.uint64)
    return enc, w_enc, bases.astype(np.uint32).view(np.int32)


def _extras(np, torch, rng, grid, counts, w_payload, dev):
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
            "impact": t(np.array([[7]], np.int32)), "w_payload": t(w_payload)}


def _bound(*, bytes_moved: float, ops: float) -> tuple[float, str]:
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_parity(np, torch, timer):
    """Both kernels against their plain versions; returns timing records."""
    from repro_torch.core.vbyte.masked import decode_blocked as decode_plain
    from repro_torch.kernels.vbyte_decode import epilogues, kernel

    dev = torch.device("cuda")
    rng = np.random.default_rng(1)
    records = {"kernel1": {}, "kernel2": {}}
    max_err = {"kernel1": 0, "kernel2": 0}
    for label, max_bits in (("S128", 7), ("S640", 32)):
        enc, w_enc, bases = _dataset(np, rng, n_blocks=4096,
                                     max_bits=max_bits)
        nb, S = enc.payload.shape
        p = torch.as_tensor(enc.payload, device=dev)
        c = torch.as_tensor(enc.counts, device=dev)
        b = torch.as_tensor(bases, device=dev)
        need = enc.payload_bytes + 8 * nb  # consumed payload + count/base
        for differential in (False, True):
            kw = dict(block_size=BLOCK, differential=differential)
            out = kernel.vbyte_decode_blocked_cuda(p, c, b, **kw)
            ref = decode_plain(p, c, b, **kw)
            torch.cuda.synchronize()
            err = int((out.long() - ref.long()).abs().max())
            max_err["kernel1"] = max(max_err["kernel1"], err)
            if err or not torch.equal(out, ref):
                die(f"kernel 1 differs from its plain version: {label} "
                    f"differential={differential} max_abs_err={err}")
            rec = {"n_blocks": nb, "stride": S, "differential": differential,
                   "max_abs_err": err}
            if differential or label == "S640":
                bound, by = _bound(bytes_moved=need + 4 * nb * BLOCK,
                                   ops=enc.payload_bytes)
                rec.update(
                    ms=timer.ms(lambda: kernel.vbyte_decode_blocked_cuda(
                        p, c, b, **kw), reps=50),
                    plain_ms=timer.ms(lambda: decode_plain(p, c, b, **kw),
                                      reps=10),
                    bound_ms=bound, bound_by=by)
            records["kernel1"][f"{label}/diff={int(differential)}"] = rec
            emit("parity_kernel1", dataset=label, **rec)

            grid = ref.cpu().numpy()
            ex = _extras(np, torch, rng, grid, enc.counts,
                         w_enc.payload, dev)
            ops = {"payload": p, "counts": c, "bases": b}
            for name, ep in epilogues.EPILOGUES.items():
                extras = {}
                if "probe" in ep.extras:
                    extras["probe"] = (ex["probe_r"] if "probe" in
                                       ep.tiled_extras else ex["probe_b"])
                if "impact" in ep.extras:
                    extras["impact"] = ex["impact"]
                if name.startswith("bm25_weighted"):
                    extras["w_payload"] = ex["w_payload"]
                kw2 = dict(format="vbyte", epilogue=name, block_size=BLOCK,
                           differential=differential)
                outs = epilogues.fused_decode(ops, extras, **kw2)
                refs = epilogues.fused_decode_plain(
                    p, c, b, extras, epilogue=name, block_size=BLOCK,
                    differential=differential)
                torch.cuda.synchronize()
                outs = outs if isinstance(outs, tuple) else (outs,)
                refs = refs if isinstance(refs, tuple) else (refs,)
                err = max(int((o.long() - r.long()).abs().max())
                          for o, r in zip(outs, refs))
                max_err["kernel2"] = max(max_err["kernel2"], err)
                if err or not all(o.shape == r.shape and torch.equal(o, r)
                                  for o, r in zip(outs, refs)):
                    die(f"kernel 2 [{name}] differs from its plain version: "
                        f"{label} differential={differential} "
                        f"max_abs_err={err}")
                rec = {"epilogue": name, "n_blocks": nb, "stride": S,
                       "differential": differential, "max_abs_err": err}
                if differential and label == "S128":
                    P = extras["probe"].shape[-1] if "probe" in extras else 0
                    out_bytes = sum(o.numel() * 4 for o in outs)
                    in_bytes = need + (
                        4 * extras["probe"].numel() if "probe" in extras
                        else 0) + (w_enc.payload_bytes
                                   if "w_payload" in extras else 0)
                    n_ops = enc.payload_bytes + nb * P + int(enc.counts.sum())
                    bound, by = _bound(bytes_moved=in_bytes + out_bytes,
                                       ops=n_ops)
                    rec.update(
                        ms=timer.ms(lambda: epilogues.fused_decode(
                            ops, extras, **kw2), reps=50),
                        plain_ms=timer.ms(lambda: epilogues.fused_decode_plain(
                            p, c, b, extras, epilogue=name, block_size=BLOCK,
                            differential=differential), reps=5),
                        bound_ms=bound, bound_by=by)
                    records["kernel2"][name] = rec
                emit("parity_kernel2", dataset=label, **rec)
    return records, max_err


# ---------------------------------------------------------------------------
# phase 4: the main path at full width
# ---------------------------------------------------------------------------
def _results_equal(np, a, b) -> bool:
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    return all(x.dtype == y.dtype and np.array_equal(x, y)
               for x, y in zip(a, b))


def phase_main_path(np, torch, *, n_queries: int, k20_lists: int, seed: int):
    from repro_torch.data.synthetic import CLUEWEB_DOCS
    from repro_torch.index import QueryStats, build_index
    from repro_torch.kernels.vbyte_decode import epilogues, kernel
    from repro_torch.launch.serve import (SearchEngine, search_lists,
                                          search_queries)

    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    lists, tfs = search_lists(rng, {12: 16, 16: 16, 20: k20_lists},
                              universe=CLUEWEB_DOCS)
    t_data = time.perf_counter() - t0
    t0 = time.perf_counter()
    index = build_index(lists, tfs=tfs, n_docs=CLUEWEB_DOCS)  # onto the card
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    resident = sum(tp.arr.payload.numel() + tp.impacts.payload.numel()
                   for tp in index.terms.values())
    idx_stats = index.stats()
    emit("index", n_terms=index.n_terms, n_postings=index.n_postings,
         n_blocks=idx_stats["n_blocks"], bits_per_int=idx_stats["bits_per_int"],
         resident_payload_bytes=resident,
         device=str(index.device), data_seconds=round(t_data, 3),
         build_seconds=round(t_build, 3),
         groups={"K12": 16, "K16": 16, "K20": k20_lists})

    qs = search_queries(rng, index, n_queries)
    engine = SearchEngine(index, top_k=10, plan="auto", probe_width=512)
    t0 = time.perf_counter()
    engine.warmup(qs[:5])
    t_warm = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernel.launches.reset()
    epilogues.launches.reset()
    stats = engine.run_workload(qs)
    torch.cuda.synchronize()
    launches = {"vbyte_decode_blocked": kernel.launches.count,
                "fused_decode": epilogues.launches.count,
                "fused_decode_by_epilogue": dict(epilogues.launches.by)}
    peak = torch.cuda.max_memory_allocated()
    emit("main_path", queries=len(qs), qps=stats["qps"],
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
    if not launches["vbyte_decode_blocked"] or not launches["fused_decode"]:
        die(f"the main path did not launch both kernels: {launches}")

    # the same queries through the plain torch plan on the card: identical
    # results and accounting; AND/OR also against numpy set operations
    plain = SearchEngine(index, top_k=10, plan="torch", probe_width=512)
    t0 = time.perf_counter()
    checked = oracle = 0
    by_mode = {}  # mode -> [n, kernel-plan seconds, torch-plan seconds]
    for mode, terms in qs:
        sa, sb = QueryStats(), QueryStats()
        ta = time.perf_counter()
        a = engine.search(terms, mode, stats=sa)
        tb = time.perf_counter()
        b = plain.search(terms, mode, stats=sb)
        acc = by_mode.setdefault(mode, [0, 0.0, 0.0])
        acc[0] += 1
        acc[1] += tb - ta
        acc[2] += time.perf_counter() - tb
        if not _results_equal(np, a, b):
            die(f"kernel plan and torch plan disagree on {mode} {terms}")
        if dataclasses.asdict(sa) != dataclasses.asdict(sb):
            die(f"QueryStats differ on {mode} {terms}")
        checked += 1
        if mode in ("and", "or") and oracle < 10:
            op = np.intersect1d if mode == "and" else np.union1d
            want = lists[terms[0]]
            for t in terms[1:]:
                want = op(want, lists[t])
            if not np.array_equal(a, want.astype(np.uint32)):
                die(f"{mode} {terms} differs from the numpy oracle")
            oracle += 1
    emit("main_path_parity", queries=checked, oracle_checked=oracle,
         seconds=round(time.perf_counter() - t0, 3), equal=True,
         mean_ms_by_mode={m: {"n": n, "kernels": round(ka / n * 1e3, 3),
                              "torch_plan": round(kb / n * 1e3, 3)}
                          for m, (n, ka, kb) in by_mode.items()})
    _profile(torch, engine, qs[:PROFILE_QUERIES])
    return launches


def _profile(torch, engine, queries):
    """Device busy share and device time by kernel over the first few
    queries of the workload, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

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
    emit("profile", queries=len(queries), wall_ms=round(wall_us / 1e3, 3),
         device_busy_ms=round(busy / 1e3, 3),
         device_busy_share=round(busy / wall_us, 4) if busy else None,
         top_device=[{"name": k[:80], "ms": round(us / 1e3, 3), "count": c}
                     for us, k, c in rows[:8]])


# ---------------------------------------------------------------------------
# phase 5: the kernels line
# ---------------------------------------------------------------------------
def kernels_line(records, max_err, launches):
    k1 = records["kernel1"]["S128/diff=1"]
    by = launches["fused_decode_by_epilogue"]
    head = max(records["kernel2"], key=lambda n: (by.get(n, 0), n))
    k2 = records["kernel2"][head]
    src = "src/repro_torch/kernels/vbyte_decode/csrc/"

    def entry(name, source, replaces, n_launch, err, rec):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": err, "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None}

    line = {"kernels": [
        entry("vbyte_decode_blocked", src + "vbyte_decode.cu",
              "src/repro/kernels/vbyte_decode/kernel.py:167",
              launches["vbyte_decode_blocked"], max_err["kernel1"], k1),
        dict(entry("fused_decode", src + "fused_decode.cu",
                   "src/repro/kernels/vbyte_decode/epilogues.py:383",
                   launches["fused_decode"], max_err["kernel2"], k2),
             timed_epilogue=head,
             epilogues={n: {"launches": by.get(n, 0),
                            **{k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                                 "bound_by", "max_abs_err")}}
                        for n, r in records["kernel2"].items()}),
    ], "library_ms_note": "no single PyTorch call computes either function",
        "shapes": "B=128, stride 128, 4096 blocks, differential, cold L2"}
    print(json.dumps(line), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--queries", type=int, default=100)
    ap.add_argument("--k20-lists", type=int, default=16)
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
    launches = phase_main_path(np, torch, n_queries=args.queries,
                               k20_lists=args.k20_lists, seed=args.seed)
    emit("done", seconds=round(time.perf_counter() - t_start, 3))
    print(card, flush=True)
    kernels_line(records, max_err, launches)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
