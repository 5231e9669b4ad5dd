#!/usr/bin/env python3
"""Decode kernels 1, 3 and 4 (``csrc/vbyte_decode.cu``,
``stream_decode.cu``, ``binpack_decode.cu``) of this tree against another
revision's, on one NVIDIA GPU, on the same inputs in one process; then
kernel 2 (``tools/ab_fused_decode.py``'s cases) the same way.

    git archive <rev> src/repro_torch/kernels/vbyte_decode/csrc \\
        | tar -x -C _checkout/<rev>
    python3 tools/ab_decode.py \\
        --other _checkout/<rev>/src/repro_torch/kernels/vbyte_decode/csrc

Each of the other revision's sources (with the headers beside it) is
compiled with this tree's nvcc flags into a temporary directory and
loaded beside this tree's library; the wrapper is pointed at one or the
other before each timing, so both take the same checks and launch
arguments. Shapes, every one a differential decode of B = 128 blocks:

* ``parity`` — ``chip_smoke.py``'s kernel parity inputs: 4,096 blocks,
  stride 128, every 7th block empty, ragged counts;
* ``path/K<k>`` — the search path's own launches of kernels 1, 3 and 4:
  the whole-list decodes of OR and TAAT (``index/query.py``'s
  ``_decode_blocks``), one list of each length group K = 12, 16, 20 built
  by ``build_index`` as the ``vbyte``, ``streamvbyte`` and ``auto`` paths
  build it;
* ``scale`` — every posting of the search index in one launch per format
  (``chip_smoke.scale_case``: rows padded to the widest list's stride);
  the K=20 lists alone at their own stride and padded to the index's
  (what staging the full stride costs); and for kernel 1 also the gin
  path's gap stream (``gin_gaps``: ogbn-products' 61,859,140 edges at
  ``--gin-scale`` 1).

Kernel 2's cases are ``tools/ab_fused_decode.py``'s (the search
epilogues at parity and path shapes, the broadcast and ``*_rows`` forms;
the gather epilogues), plus ``adjacency_rebase`` over the gin path's gap
stream with the forward's ``edge_base`` (shape ``gin``).

Every case first holds both libraries' outputs bit for bit against the
plain version, then times them with the L2 flushed before every launch
(``chip_smoke.ColdTimer``) in the order other, this, this, other, and
prints ms, the bound and billions of integers per second. One JSON line
per case, then the card line; ``--out FILE`` writes the lines there too.
``--skip-fused`` leaves out kernel 2; ``--match REGEX`` runs only the
cases whose key (``shape/format``, ``shape/format/epilogue`` for kernel 2)
matches. Exits non-zero without a card or on any disagreement.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import ab_fused_decode as abf  # noqa: E402
import chip_smoke as cs  # noqa: E402

LIBS = {"vbyte": "vbyte_decode", "streamvbyte": "stream_decode",
        "binpack": "binpack_decode"}
PATH_FORMATS = {"vbyte": "vbyte", "binpack": "auto",  # index format=
                "streamvbyte": "streamvbyte"}


def _ops(torch, arr) -> dict:
    return {k: v.contiguous() for k, v in arr.device_operands().items()}


def parity_cases(np, torch):
    from repro_torch.kernels.vbyte_decode import epilogues

    rng = np.random.default_rng(1)
    for fmt, _, datasets in cs._parity_plan(rng):
        _, bits = datasets[0]
        enc, _, bases = cs._dataset(np, rng, fmt,
                                    n_blocks=cs.N_PARITY_BLOCKS, bits=bits)
        ops = {k: torch.as_tensor(np.ascontiguousarray(getattr(enc, k)),
                                  device="cuda")
               for k in epilogues.FORMAT_OPERANDS[fmt]}
        ops["counts"] = torch.as_tensor(enc.counts, device="cuda")
        ops["bases"] = torch.as_tensor(bases, device="cuda")
        yield "parity", fmt, ops, cs.decode_stats(
            fmt, ops, enc.payload_bytes, int(enc.counts.sum()))


def path_cases(np, torch, seed: int):
    """One list of each length group, as the search paths draw them, in
    the index each path builds; the docid stream its OR/TAAT decodes."""
    from repro_torch.data.synthetic import CLUEWEB_DOCS, posting_list_group
    from repro_torch.index import build_index

    rng = np.random.default_rng(seed)
    for k in (12, 16, 20):
        docs = posting_list_group(rng, k, 1, universe=CLUEWEB_DOCS)[0]
        for fmt, index_format in PATH_FORMATS.items():
            tp = build_index({0: docs}, n_docs=CLUEWEB_DOCS,
                             format=index_format, device="cuda").terms[0]
            if tp.arr.format != fmt:
                cs.die(f"path K{k}: the {index_format} index stored "
                       f"{tp.arr.format}, not {fmt}")
            ops = _ops(torch, tp.arr)
            yield f"path/K{k}", fmt, ops, cs.decode_stats(
                fmt, ops, tp.arr.payload_bytes, tp.arr.n)


def scale_cases(np, torch, args):
    lists = cs.search_index_lists(np, args.seed, args.k20_lists)
    strides = {}
    for fmt in LIBS:
        ops, st = cs.scale_case(np, torch, fmt, lists)
        strides[fmt] = st["stride"]
        yield "scale", fmt, ops, st
    # the cost of staging padding: the K=20 lists alone at their own
    # widest stride, and padded to the whole index's
    k20 = dict(list(lists.items())[-args.k20_lists:])
    for fmt in LIBS:
        ops, st = cs.scale_case(np, torch, fmt, k20)
        yield "scale/K20", fmt, ops, st
        if strides[fmt] > st["stride"]:
            ops, st = cs.scale_case(np, torch, fmt, k20,
                                    stride=strides[fmt])
            yield f"scale/K20/S{strides[fmt]}", fmt, ops, st
    del lists, k20


def gin_graph(np, args):
    """The gin path's adjacency, compressed on the card (ogbn-products'
    shape at ``--gin-scale``, from ``--seed``), and its edge count."""
    from repro_torch.configs.shapes import GNN_SHAPES
    from repro_torch.data.graph import compress_adjacency
    from repro_torch.data.sampler import CSRGraph
    from repro_torch.data.synthetic import random_graph

    dims = GNN_SHAPES["ogb_products"].dims
    n = int(dims["raw_nodes"] * args.gin_scale)
    e = int(dims["raw_edges"] * args.gin_scale)
    g = random_graph(np.random.default_rng(args.seed), n, e, 1, 2)
    csr = CSRGraph.from_edges(g["edge_src"], g["edge_dst"], n)
    del g
    return compress_adjacency(csr, device="cuda"), e


def gin_gaps_case(torch, comp):
    """Kernel 1 over the gin path's gap stream (its legacy decode)."""
    gaps = comp["gaps"]
    ops = _ops(torch, gaps)
    yield "scale/gin_gaps", "vbyte", ops, cs.decode_stats(
        "vbyte", ops, gaps.payload_bytes, gaps.n)


def gin_rebase_case(torch, comp, n_edges: int) -> dict:
    """Kernel 2's adjacency_rebase over the same stream, with the edge_base
    that the gin forward builds (``chip_smoke.gin_rebase_case``), as a
    ``tools/ab_fused_decode.py`` case."""
    ops, extras, st = cs.gin_rebase_case(torch, comp, n_edges)

    def hold(out, ref):
        if not torch.equal(out, ref):
            cs.die("kernel 2 [vbyte/adjacency_rebase] differs from its plain "
                   "version at the gin path's shape")

    return {"shape": "gin", "format": "vbyte",
            "epilogue": "adjacency_rebase", "n_blocks": st["nb"], "P": 0,
            "kw": dict(format="vbyte", epilogue="adjacency_rebase",
                       block_size=st["B"], differential=True),
            "ops": ops, "extras": extras, "hold": hold,
            "bound": lambda out: cs.gather_bound("adjacency_rebase", extras,
                                                 None, st)}


def run_decode_case(np, torch, label, fmt, ops, st, libs, timer, reps, card):
    from repro_torch.kernels.vbyte_decode import _build, epilogues
    from repro_torch.kernels.vbyte_decode.dispatch import CUDA_DECODERS

    name = LIBS[fmt]
    leaves = [ops[k] for k in epilogues.FORMAT_OPERANDS[fmt]]
    c, b = ops["counts"], ops["bases"]
    kw = dict(block_size=cs.BLOCK, differential=True)
    dec = CUDA_DECODERS[fmt]
    ref = epilogues.PLAIN_DECODERS[fmt](*leaves, c, b, **kw)
    for tag in ("other", "this"):
        _build._LOADED[(name, _build.CSRC)] = libs[tag][name]
        out = dec(*leaves, c, b, **kw)
        torch.cuda.synchronize()
        if not torch.equal(out, ref):
            cs.die(f"{tag} {name} differs from its plain version: {label} "
                   f"{fmt}")
    # a yardstick of the traffic alone: one clone of the decoded grid
    # (reads and writes it once: 8·B bytes a block)
    copy_ms = timer.ms(lambda: out.clone(), reps=reps)
    del ref, out
    turns = []
    for tag in ("other", "this", "this", "other"):
        _build._LOADED[(name, _build.CSRC)] = libs[tag][name]
        turns.append((tag, timer.ms(lambda: dec(*leaves, c, b, **kw),
                                    reps=reps)))
    _build._LOADED[(name, _build.CSRC)] = libs["this"][name]
    other_ms = [t for tag, t in turns if tag == "other"]
    this_ms = [t for tag, t in turns if tag == "this"]
    o, t = sum(other_ms) / 2, sum(this_ms) / 2
    return {"shape": label, "kernel": name, "format": fmt,
            "n_blocks": st["n_blocks"], "stride": st["stride"],
            "n_ints": st["n_ints"], "payload_bytes": st["payload_bytes"],
            "other_ms": other_ms, "this_ms": this_ms, "other_mean_ms": o,
            "this_mean_ms": t, "speedup": o / t,
            "bound_ms": st["bound_ms"], "bound_by": st["bound_by"],
            "other_gints_per_s": st["n_ints"] / o / 1e6,
            "this_gints_per_s": st["n_ints"] / t / 1e6,
            "this_share_of_bound": st["bound_ms"] / t,
            "grid_clone_ms": copy_ms, "card": card}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", required=True, type=Path,
                    help="the other revision's vbyte_decode csrc directory")
    ap.add_argument("--reps", type=int, default=50,
                    help="timed launches per library and turn")
    ap.add_argument("--scale-reps", type=int, default=10,
                    help="timed launches per library and turn at the scale "
                         "shape")
    ap.add_argument("--fused-reps", type=int, default=20,
                    help="timed launches per library and turn for kernel 2")
    ap.add_argument("--k20-lists", type=int, default=16,
                    help="K=20 lists of the search index (scale shape)")
    ap.add_argument("--gin-scale", type=float, default=1.0,
                    help="fraction of ogbn-products' graph for gin_gaps "
                         "(0: leave it out)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--skip-fused", action="store_true",
                    help="leave out kernel 2's cases")
    ap.add_argument("--match", default="",
                    help="run only the cases whose key (shape/format, or "
                         "shape/format/epilogue for kernel 2) matches this "
                         "regular expression")
    ap.add_argument("--out", type=Path,
                    help="also write the JSON lines to this file")
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from repro_torch.kernels.vbyte_decode import _build

    card = cs.phase_device(torch)
    names = list(LIBS.values()) + ([] if args.skip_fused
                                   else ["fused_decode"])
    built = _build.build([(n, _build.CSRC) for n in names])
    libs = {"this": {n: _build.library(n) for n in names}, "other": {}}
    tmp = Path(tempfile.mkdtemp(prefix="ab_decode_"))
    lines = []
    try:
        libs["other"] = abf.other_libraries(_build, args.other.resolve(), tmp,
                                            names)
        timer = cs.ColdTimer(torch)
        lines.append(abf.floor_line(torch, timer, args.reps, card))
        gens = [(parity_cases(np, torch), args.reps),
                (path_cases(np, torch, args.seed), args.reps),
                (scale_cases(np, torch, args), args.scale_reps)]
        comp = None
        if args.gin_scale > 0:
            comp, n_edges = gin_graph(np, args)
            gens.append((gin_gaps_case(torch, comp), args.scale_reps))
        for gen, reps in gens:
            for label, fmt, ops, st in gen:
                if not re.search(args.match, f"{label}/{fmt}"):
                    continue
                rec = run_decode_case(np, torch, label, fmt, ops, st, libs,
                                      timer, reps, card)
                lines.append(rec)
                print(json.dumps(rec), flush=True)
                del ops
                torch.cuda.empty_cache()
        if not args.skip_fused:
            cases = abf.fused_cases(np, torch)
            if comp is not None:
                cases.append(gin_rebase_case(torch, comp, n_edges))
            cases = abf.matching(cases, args.match)
            abf.run_cases(np, torch, cases, libs["other"]["fused_decode"],
                          libs["this"]["fused_decode"], timer,
                          args.fused_reps, card, lines)
    finally:
        for n in names:
            _build._LOADED.pop((n, _build.CSRC), None)
        shutil.rmtree(tmp, ignore_errors=True)
    abf.write_lines(args.out, lines)
    print(json.dumps({"built_seconds": {n: r.seconds
                                        for n, r in built.items()}}))
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
