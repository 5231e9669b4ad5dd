"""Training launcher of the port.

Assembles an architecture's config (registry), a mesh, its train step,
a synthetic data source, checkpoint and restart, and straggler
detection. The LM, GNN and recsys families train::

    PYTHONPATH=src python -m repro_torch.launch.train --arch gin-tu \\
        --steps 20 --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.train --arch sasrec \\
        --steps 20 --reduced --device cpu   # or bert4rec, bst,
                                            # two-tower-retrieval
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch h2o-danube-1.8b --steps 3 --reduced --device cpu  # any LM
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch h2o-danube-1.8b --steps 3 [--multi-pod]  # the mesh, cards

``--reduced`` trains the reduced config with the single-device step
(what the reference's 1-device host mesh, jitted without shardings,
runs), on the reference's batch (GNN: a 256-node,
2,048-edge ``random_graph``; recsys: a fresh ``recsys_batch`` of 16 rows
every step; LM: 4 × 64-token batches of a ``token_stream`` through
``CompressedTokenPipeline``, decoded on the device, one microbatch).
Without it, the launcher lays the production mesh over the cards
(``launch/mesh.py``: every card on the data axis; ``--multi-pod`` adds a
``pod`` axis of size 1), resolves the full config at the architecture's
first shape at the mesh's data-parallel degree, and trains through
``train.jit_train_step`` with the registry's state specs
(``build_cell``): on one card the one-position mesh, which gives the
single-device step. Over more cards the step deals its own microbatches
out whole where the cards divide their count (the LM configs' 4 or 8
over up to 4 cards), and otherwise splits each microbatch's rows over
the cards and reduces its loss across them (the recsys and GNN cells'
microbatch of 1: masked means, the two-tower in-batch softmax, a graph
whose node rows and edges split over every card). The batch is the one
that shape names: for an LM,
``train_4k``'s 4,096 tokens a row at ``LM_TRAIN_ROWS`` rows (cut from
the shape's 256, which one card does not hold), in the config's
microbatches, from the same pipeline; for gin-tu, ``full_graph_sm``'s
node and edge counts, its adjacency compressed
(``data/graph.compress_adjacency``) because the shape asks for
compressed adjacency; for recsys, ``train_batch``'s 65,536 rows (a fresh
batch every step), kept whole (``recsys.train_options``: block
recomputation for BERT4Rec, the two-tower loss in row chunks). (The
reference's launcher gives every config its reduced batch, which for
gin-tu lacks the compressed fields: a deviation of the reference,
ROADMAP queue 3, not carried over.)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import (gnn_train_state_from_tree,
                                 recsys_train_state_from_tree,
                                 train_state_tree)
from repro_torch.distributed.sharding import to_named
from repro_torch.ft import StragglerDetector
from repro_torch.launch.mesh import dp_degree, make_production_mesh
from repro_torch.models import registry
from repro_torch.train import (OptimizerConfig, init_train_state,
                               jit_train_step, make_train_step)

REDUCED_NODES, REDUCED_EDGES = 256, 2048  # the reference's reduced batch
REDUCED_RECSYS_BATCH = 16
REDUCED_LM_BATCH, REDUCED_LM_SEQ = 4, 64  # the reference's reduced batch
LM_TRAIN_ROWS = 8  # train_4k rows a step on one card (the shape has 256)


def make_batch_fn(arch: str, cfg, shape, rng, device):
    """The host data source: ``step -> batch`` of tensors on ``device``.
    ``shape`` None is the reduced batch; else a ``ShapeDef``: the graph's
    node and edge counts, the recsys train batch, or the LM's sequence
    length (at ``LM_TRAIN_ROWS`` rows)."""
    fam = registry.family_of(arch)
    if fam == "lm":
        from repro_torch.data.pipeline import CompressedTokenPipeline
        from repro_torch.data.synthetic import token_stream

        B, S = ((REDUCED_LM_BATCH, REDUCED_LM_SEQ) if shape is None else
                (LM_TRAIN_ROWS, shape.dims["seq_len"]))
        pipe = CompressedTokenPipeline(
            token_stream(rng, B * (S + 1) * 32, cfg.vocab), B, S,
            device=device)
        return pipe.get_batch
    if fam == "recsys":
        import dataclasses

        shape = shape or dataclasses.replace(
            registry.shapes_of(arch)["train_batch"],
            dims={"batch": REDUCED_RECSYS_BATCH})
        return lambda step: registry.recsys_batch_for(cfg, shape, rng,
                                                      device=device)
    from repro_torch.data.synthetic import random_graph

    n, e = ((REDUCED_NODES, REDUCED_EDGES) if shape is None else
            (shape.dims["n_nodes"], shape.dims["n_edges"]))
    g = random_graph(rng, n, e, cfg.d_feat, cfg.n_classes)
    batch = {"feats": torch.as_tensor(g["feats"], device=device),
             "labels": torch.as_tensor(g["labels"], device=device),
             "label_mask": torch.ones(n, dtype=torch.bool, device=device)}
    if cfg.compressed_adjacency:
        from repro_torch.data.graph import compress_adjacency
        from repro_torch.data.sampler import CSRGraph

        csr = CSRGraph.from_edges(g["edge_src"], g["edge_dst"], n)
        comp = compress_adjacency(csr, device=device)
        batch.update({k: v for k, v in comp.items() if not k.startswith("_")})
    else:
        batch.update(edge_src=torch.as_tensor(g["edge_src"], device=device),
                     edge_dst=torch.as_tensor(g["edge_dst"], device=device))
    return lambda step: batch


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced config on the reference's small batch; "
                         "without it the full config at its first shape (an "
                         f"LM: train_4k at {LM_TRAIN_ROWS} rows, cut from 256)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the production mesh with a leading pod axis")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--peak-lr", type=float, default=3e-4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    fam = registry.family_of(args.arch)
    init = registry._family_init(fam)
    shape = mesh = None
    microbatch = 1
    if args.reduced:
        cfg = registry.reduced_config(args.arch)
    else:
        mesh = make_production_mesh(
            multi_pod=args.multi_pod,
            devices=None if dev.type == "cuda" else [dev])
        dev = mesh.devices.flat[0]
        name = list(registry.shapes_of(args.arch))[0]
        shape = registry.shapes_of(args.arch)[name]
        cfg = registry.resolve_config(args.arch, name,
                                      dp_degree=dp_degree(mesh))
        if fam == "lm":
            microbatch = cfg.microbatch
    if fam == "lm":
        from repro_torch.convert import lm_train_state_from_tree
        from repro_torch.models import lm

        loss_fn = lambda p, b: lm.loss_fn(p, b, cfg)  # noqa: E731
        from_tree = lm_train_state_from_tree
    elif fam == "recsys":
        from repro_torch.models import recsys

        loss_fn = lambda p, b: recsys.loss_fn(p, b, cfg)  # noqa: E731
        from_tree = recsys_train_state_from_tree
    else:
        from repro_torch.models import gnn

        loss_fn = lambda p, b: gnn.loss_fn(p, b, cfg)  # noqa: E731
        from_tree = gnn_train_state_from_tree

    rng = np.random.default_rng(0)
    opt = OptimizerConfig(peak_lr=args.peak_lr, warmup_steps=5,
                          total_steps=args.steps)
    state = init_train_state(init(cfg, seed=0, device=dev),
                             grad_compression=args.grad_compression)
    step_fn = make_train_step(loss_fn, opt,
                              grad_compression=args.grad_compression,
                              microbatch=microbatch)
    if mesh is not None:
        cell = registry.build_cell(args.arch, name, mesh_dp=dp_degree(mesh),
                                   opt_cfg=opt)
        sspec, bspec = cell.arg_specs
        if args.grad_compression:
            sspec = dict(sspec, ef=dict(sspec["params"]))
        step_fn = jit_train_step(step_fn, in_shardings=(
            to_named(mesh, sspec), to_named(mesh, bspec)))
        print(f"mesh {mesh.shape} over {len(set(map(str, mesh.devices.flat)))}"
              f" device(s)")

    mgr = CheckpointManager(args.ckpt_dir, keep=2) if args.ckpt_dir else None
    start = 0
    if mgr is not None:
        restored, at = mgr.restore_latest(train_state_tree(state))
        if restored is not None:
            state = from_tree(restored, cfg, device=dev)
            start = at + 1
            print(f"[resume] from step {at}")

    det = StragglerDetector()
    batch_fn = make_batch_fn(args.arch, cfg, shape, rng, dev)
    losses = {}
    t0 = time.time()
    for step in range(start, args.steps):
        state, metrics = step_fn(state, batch_fn(step))
        det.heartbeat("host0", step)
        losses[step] = float(metrics["loss"])
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {step:>4} loss={losses[step]:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f}")
        if mgr is not None and step and step % args.ckpt_every == 0:
            mgr.save(step, train_state_tree(state), async_=True)
    stragglers = det.stragglers()
    if mgr is not None:
        mgr.wait()
        mgr.save(args.steps - 1, train_state_tree(state))
    dt = (time.time() - t0) / max(args.steps - start, 1)
    print(f"done: {dt*1e3:.1f} ms/step, stragglers={stragglers}")
    return {"start": start, "losses": losses, "state": state}


if __name__ == "__main__":
    main()
