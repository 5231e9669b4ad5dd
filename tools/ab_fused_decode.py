#!/usr/bin/env python3
"""Kernel 2 (``csrc/fused_decode.cu``) of this tree against another
revision's, on one NVIDIA GPU, on the same inputs in one process.

    git archive <rev> src/repro_torch/kernels/vbyte_decode/csrc \\
        | tar -x -C _checkout/<rev>
    python3 tools/ab_fused_decode.py \\
        --other _checkout/<rev>/src/repro_torch/kernels/vbyte_decode/csrc

The other revision's ``fused_decode.cu`` (with the decode cores it
includes) is compiled with this tree's nvcc flags into a temporary
directory and loaded beside this tree's library; the wrapper
(``epilogues.fused_decode``) is pointed at one or the other before each
timing, so both take the same checks and launch arguments. Cases:

* parity shape — the inputs of ``chip_smoke.py``'s kernel parity phase
  (4096 blocks of B = 128, stride 128, ragged counts): the broadcast
  epilogues (membership, bm25_accum, bm25_weighted) on sorted rows
  (differential) and on unsorted ones, and kernel 2's other search
  epilogues on sorted rows, on each of the three cores;
* path shapes — ``chip_smoke.probe_path_cases``: the broadcast epilogues
  over 1, 4, 16 and 512 blocks gathered from a posting list, 512 probes,
  and their ``*_rows`` forms, one probe a block;
* gather, parity shape — ``chip_smoke.gather_parity_cases``, vbyte core:
  ``dot_score`` on the bf16 d = 256 and f32 d = 128 tables with 1 and 8
  query rows, and ``bag_sum`` (both tables) and ``adjacency_rebase`` as
  controls;
* gather, path shape — ``chip_smoke.dot_path_case``: ``dot_score`` over
  the two_tower corpus (8,192 full blocks) at every query bucket.

Every case first holds both libraries' outputs against the plain version
(integer outputs bit for bit, float ones within ``chip_smoke._float_close``),
then times them with the L2 flushed before every launch
(``chip_smoke.ColdTimer``) in the order other, this, this, other. One JSON
line per case, then the card line; ``--out FILE`` writes the lines there
too.
Exits non-zero without a card or on any disagreement.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SEARCH_EPILOGUES = ("stream", "checksum", "membership_rows", "bm25_accum_rows",
                    "bm25_weighted_rows")


def other_libraries(_build, csrc: Path, tmp: Path, names) -> dict:
    """The other revision's ``<name>.cu`` for each of ``names`` (with the
    headers beside them) compiled with this tree's nvcc flags into ``tmp``,
    all at once, and loaded."""
    for f in csrc.glob("*.cu*"):
        shutil.copy(f, tmp)
    procs = {}
    for name in names:
        lib = tmp / f"lib{name}_other.so"
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(tmp / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            cs.die(f"nvcc failed for the other {name}.cu:\n{out}")
        libs[name] = _build._Library(name, lib)
    return libs


def _search_case(torch, label, fmt, name, differential, ops, extras, need,
                 n_ints):
    kw = dict(format=fmt, epilogue=name, block_size=cs.BLOCK,
              differential=differential)
    nb = ops["counts"].shape[0]
    P = extras["probe"].shape[-1] if "probe" in extras else 0

    def hold(out, ref):
        if cs._max_err(out, ref):
            cs.die(f"kernel 2 [{fmt}/{name}] {label} differs from its plain "
                   f"version")

    def bound(out):
        out = out if isinstance(out, tuple) else (out,)
        return cs._bound(bytes_moved=need + sum(4 * o.numel() for o in out),
                         ops=need + nb * P + n_ints)

    return {"shape": label, "format": fmt, "epilogue": name, "n_blocks": nb,
            "P": P, "kw": kw, "ops": ops, "extras": extras, "hold": hold,
            "bound": bound}


def _parity_cases(np, torch, rng):
    """The search epilogues at ``chip_smoke.py``'s parity shape."""
    from repro_torch.kernels.vbyte_decode import epilogues

    dev = torch.device("cuda")
    for fmt, _, datasets in cs._parity_plan(rng):
        _, bits = datasets[0]
        enc, w_enc, bases = cs._dataset(np, rng, fmt,
                                        n_blocks=cs.N_PARITY_BLOCKS, bits=bits)
        names = epilogues.FORMAT_OPERANDS[fmt]
        leaves = [torch.as_tensor(np.ascontiguousarray(getattr(enc, k)),
                                  device=dev) for k in names]
        ops = dict(zip(names, leaves),
                   counts=torch.as_tensor(enc.counts, device=dev),
                   bases=torch.as_tensor(bases, device=dev))
        w_ops = {k: np.ascontiguousarray(getattr(w_enc, k)) for k in names}
        for differential in (False, True):
            grid = epilogues.fused_decode_plain(
                ops, {}, format=fmt, epilogue="stream", block_size=cs.BLOCK,
                differential=differential).cpu().numpy()
            ex = cs._extras(np, torch, rng, grid, enc.counts, w_ops, dev)
            todo = cs.PROBE_EPILOGUES + (SEARCH_EPILOGUES if differential
                                         else ())
            for name in todo:
                ep = epilogues.EPILOGUES[name]
                extras = {}
                if "probe" in ep.extras:
                    extras["probe"] = (ex["probe_r"] if "probe" in
                                       ep.tiled_extras else ex["probe_b"])
                if "impact" in ep.extras:
                    extras["impact"] = ex["impact"]
                if name.startswith("bm25_weighted"):
                    extras.update(ex["weights"])
                need = enc.payload_bytes + 8 * len(enc.counts) + sum(
                    4 * v.numel() for k, v in extras.items() if k in
                    ("probe", "impact")) + (w_enc.payload_bytes
                                            if "weighted" in name else 0)
                label = "parity" if differential else "parity/unsorted"
                yield _search_case(torch, label, fmt, name, differential, ops,
                                   extras, need, int(enc.counts.sum()))


def _path_cases(np, torch, rng):
    for fmt, nb, ops, extras, in_bytes, n_ints in cs.probe_path_cases(
            np, torch, rng):
        for name in cs.PROBE_EPILOGUES + cs.ROWS_EPILOGUES:
            yield _search_case(torch, f"nb{nb}", fmt, name, True, ops,
                               extras[name], in_bytes[name], n_ints)


def _gather_case(torch, label, key, name, extras, tl, ops, st):
    kw = dict(format=st["fmt"], epilogue=name, block_size=st["B"],
              differential=st["differential"])

    def hold(out, ref):
        cs.hold_gather(torch, key, name, extras, tl, ops, st, lambda: out,
                       lambda: ref)

    return {"shape": label, "format": st["fmt"], "epilogue": key,
            "n_blocks": st["nb"], "P": 0, "kw": kw, "ops": ops,
            "extras": extras, "hold": hold,
            "bound": lambda out: cs.gather_bound(name, extras, tl, st)}


def _gather_cases(np, torch):
    """dot_score and its controls on the vbyte core at the parity shape,
    then dot_score at the path shape."""
    tables, queries = cs._gather_tables(torch)
    for ops, st, variants in cs.gather_parity_cases(np, torch, tables,
                                                    queries):
        if st["fmt"] != "vbyte" or st["B"] != cs.BLOCK:
            continue
        for key, name, extras, tl in variants:
            yield _gather_case(torch, "parity", key, name, extras, tl, ops,
                               st)
    ops, st, variants = cs.dot_path_case(np, torch, tables, queries)
    for key, name, extras, tl in variants:
        yield _gather_case(torch, "path", key, name, extras, tl, ops, st)


def fused_cases(np, torch) -> list:
    return (list(_parity_cases(np, torch, np.random.default_rng(1)))
            + list(_path_cases(np, torch, np.random.default_rng(3)))
            + list(_gather_cases(np, torch)))


def matching(cases: list, pattern: str) -> list:
    """The cases whose key ``shape/format/epilogue`` matches ``pattern``."""
    return [c for c in cases if re.search(
        pattern, f"{c['shape']}/{c['format']}/{c['epilogue']}")]


def run_cases(np, torch, cases, other, this, timer, reps: int, card: str,
              lines: list) -> None:
    """Hold both kernel 2 libraries against the plain version on every
    case, then time them in turns other, this, this, other."""
    from repro_torch.kernels.vbyte_decode import _build, epilogues

    for case in cases:
        ops, extras, kw = case["ops"], case["extras"], case["kw"]
        ref = epilogues.fused_decode_plain(ops, extras, **kw)
        for tag, lib in (("other", other), ("this", this)):
            _build._LOADED[("fused_decode", _build.CSRC)] = lib
            out = epilogues.fused_decode(ops, extras, **kw)
            torch.cuda.synchronize()
            case["hold"](out, ref)
        bound, by = case["bound"](out)
        del ref, out
        turns = []
        for tag, lib in (("other", other), ("this", this),
                         ("this", this), ("other", other)):
            _build._LOADED[("fused_decode", _build.CSRC)] = lib
            turns.append((tag, timer.ms(
                lambda: epilogues.fused_decode(ops, extras, **kw),
                reps=reps)))
        other_ms = [t for tag, t in turns if tag == "other"]
        this_ms = [t for tag, t in turns if tag == "this"]
        rec = {k: case[k] for k in ("shape", "format", "epilogue",
                                    "n_blocks", "P")}
        rec.update({"kernel": "fused_decode", "other_ms": other_ms,
                    "this_ms": this_ms, "other_mean_ms": sum(other_ms) / 2,
                    "this_mean_ms": sum(this_ms) / 2,
                    "speedup": sum(other_ms) / sum(this_ms),
                    "bound_ms": bound, "bound_by": by, "card": card})
        lines.append(rec)
        print(json.dumps(rec), flush=True)
    _build._LOADED[("fused_decode", _build.CSRC)] = this


def floor_line(torch, timer, reps: int, card: str) -> dict:
    """The least a launch takes under this timer: one 4-byte add."""
    tiny = torch.zeros(1, device="cuda")
    rec = {"shape": "floor", "op": "one-element add_",
           "ms": timer.ms(lambda: tiny.add_(1), reps=reps), "card": card}
    print(json.dumps(rec), flush=True)
    return rec


def write_lines(path, lines) -> None:
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text("".join(json.dumps(r) + "\n" for r in lines))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other revision's csrc directory")
    ap.add_argument("--reps", type=int, default=50,
                    help="timed launches per library and turn")
    ap.add_argument("--match", default="",
                    help="run only the cases whose key "
                         "shape/format/epilogue matches this regular "
                         "expression")
    ap.add_argument("--out", type=Path,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from repro_torch.kernels.vbyte_decode import _build

    card = cs.phase_device(torch)
    this = _build.library("fused_decode")
    tmp = Path(tempfile.mkdtemp(prefix="ab_fused_decode_"))
    lines = []
    try:
        other = other_libraries(_build, args.other.resolve(), tmp,
                                ("fused_decode",))["fused_decode"]
        timer = cs.ColdTimer(torch)
        lines.append(floor_line(torch, timer, args.reps, card))
        run_cases(np, torch, matching(fused_cases(np, torch), args.match),
                  other, this, timer, args.reps, card, lines)
    finally:
        _build._LOADED.pop(("fused_decode", _build.CSRC), None)
        shutil.rmtree(tmp, ignore_errors=True)
    write_lines(args.out, lines)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
