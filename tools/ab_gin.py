#!/usr/bin/env python3
"""The GIN forward of this tree against another revision's, on one NVIDIA
GPU, on the same graph, in turns (other, this, this, other).

    git archive <rev> | tar -x -C _checkout/<rev>
    python3 tools/ab_gin.py --other _checkout/<rev>/src

gin-tu at full width over an ogbn-products-sized graph (2,449,029 nodes,
61,859,140 edges, d_feat 100; ``data/synthetic.py::random_graph`` from
``--seed``), adjacency compressed, built once on the host and saved; each
turn is a process of its own that imports one tree's ``repro_torch``,
places the graph on the card, runs one forward to warm up and then
``--reps`` forwards, each timed on the host around a synchronisation.
Prints one JSON line per turn: the forward times, the peak device memory
over the timed forwards (``max_memory_allocated``), and the logits' sum
(equal on every turn of a tree whose forward is deterministic).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
N_NODES, N_EDGES, D_FEAT, N_CLASSES = 2449029, 61859140, 100, 47


def make(path: str, seed: int, scale: float) -> None:
    import numpy as np

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.data.sampler import CSRGraph
    from repro_torch.data.synthetic import random_graph

    n, e = int(N_NODES * scale), int(N_EDGES * scale)
    g = random_graph(np.random.default_rng(seed), n, e, D_FEAT, N_CLASSES)
    csr = CSRGraph.from_edges(g["edge_src"], g["edge_dst"], n)
    np.savez(path, indptr=csr.indptr, indices=csr.indices, feats=g["feats"],
             labels=g["labels"])


def turn(src: str, path: str, reps: int) -> None:
    import numpy as np

    sys.path.insert(0, src)
    import torch
    from repro_torch.data.graph import compress_adjacency
    from repro_torch.data.sampler import CSRGraph
    from repro_torch.models import gnn, registry

    z = np.load(path)
    csr = CSRGraph(indptr=z["indptr"], indices=z["indices"])
    cfg = registry.resolve_config("gin-tu", "ogb_products")
    batch = {"feats": torch.as_tensor(z["feats"], device="cuda"),
             "labels": torch.as_tensor(z["labels"], device="cuda"),
             **{k: v for k, v in compress_adjacency(csr, device="cuda").items()
                if not k.startswith("_")}}
    params = gnn.init_params(cfg, seed=0, device="cuda")
    times = []
    with torch.inference_mode():
        gnn.forward(params, batch, cfg)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(reps):
            t = time.perf_counter()
            logits = gnn.forward(params, batch, cfg)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
    print(json.dumps({"src": src, "forward_ms": times,
                      "peak_device_bytes": torch.cuda.max_memory_allocated(),
                      "logits_sum": float(logits.double().sum())}),
          flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", type=Path,
                    help="the other revision's src directory")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="fraction of ogbn-products' nodes and edges")
    ap.add_argument("--turn", nargs=2, metavar=("SRC", "GRAPH"),
                    help=argparse.SUPPRESS)  # one turn, in its own process
    args = ap.parse_args(argv)
    if args.turn:
        turn(args.turn[0], args.turn[1], args.reps)
        return 0
    if args.other is None:
        ap.error("--other is required")
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        graph = str(Path(tmp) / "graph.npz")
        make(graph, args.seed, args.scale)
        this, other = str(ROOT / "src"), str(args.other.resolve())
        for src in (other, this, this, other):
            subprocess.run([sys.executable, __file__, "--reps",
                            str(args.reps), "--turn", src, graph], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
