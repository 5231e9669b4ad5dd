"""Architecture registry of the port: configs and shape resolution.

The port of ``repro/models/registry.py`` for the LM, GNN and recsys
families (``family_of``, ``shapes_of``, ``resolve_config``,
``reduced_config``, the families' ``_family_init`` for training) and, in
place of its abstract inputs, concrete batches with the leaves and
dtypes of the reference's ``_lm_batch`` (:func:`lm_batch_for`) and
``_recsys_batch`` (:func:`recsys_batch_for`). Shardings and step
functions are mesh/XLA tools with no counterpart on one card.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.shapes import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                        ShapeDef)

ARCH_IDS = {
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "gin-tu": "repro_torch.configs.gin_tu",
    "sasrec": "repro_torch.configs.sasrec",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    "bert4rec": "repro_torch.configs.bert4rec",
    "bst": "repro_torch.configs.bst",
}


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}; expected one "
                         f"of {tuple(ARCH_IDS)}")
    return importlib.import_module(ARCH_IDS[arch_id])


def family_of(arch_id: str) -> str:
    return _module(arch_id).FAMILY


def shapes_of(arch_id: str) -> dict[str, ShapeDef]:
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
            "recsys": RECSYS_SHAPES}[family_of(arch_id)]


def resolve_config(arch_id: str, shape_name: str, *, dp_degree: int = 1,
                   overrides=None):
    """The architecture's config for one shape: a GNN takes ``d_feat``,
    ``n_classes``, ``task`` and the adjacency mode from the shape; an MoE
    LM dispatches in ``max(dp_degree, 1)`` groups. ``overrides`` replace
    fields; a key ``"moe.<field>"`` replaces a field of the MoE
    settings."""
    mod = _module(arch_id)
    cfg = mod.CONFIG
    shape = shapes_of(arch_id)[shape_name]
    if mod.FAMILY == "gnn":
        cfg = dataclasses.replace(
            cfg, d_feat=shape.dims["d_feat"],
            n_classes=shape.dims["n_classes"],
            task=shape.dims.get("task", "node"),
            compressed_adjacency=shape.dims.get("compressed_adjacency", False))
    if mod.FAMILY == "lm" and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=max(dp_degree, 1)))
    if overrides:
        moe_over = {k[4:]: v for k, v in overrides.items()
                    if k.startswith("moe.")}
        flat_over = {k: v for k, v in overrides.items() if "." not in k}
        if moe_over and getattr(cfg, "moe", None) is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **moe_over))
        if flat_over:
            cfg = dataclasses.replace(cfg, **flat_over)
    return cfg


def _family_init(fam: str):
    """The family's ``init_params(cfg, *, seed, device)`` for a train
    state."""
    if fam == "lm":
        from repro_torch.models import lm

        return lm.init_params
    if fam == "gnn":
        from repro_torch.models import gnn

        return gnn.init_params
    from repro_torch.models import recsys

    return recsys.init_params


def lm_batch_for(cfg, shape: ShapeDef, rng, *, device) -> dict:
    """A concrete batch of the LM ``shape`` for ``cfg``, token ids drawn
    uniformly from ``[0, vocab)`` by the numpy generator ``rng``: the
    leaves and dtypes of the reference's ``_lm_batch`` (int32 tensors on
    ``device``): ``tokens [B, S+1]`` (train), ``[B, S]`` (prefill) or
    ``[B]`` (decode), at the shape's ``global_batch`` and ``seq_len``."""
    import numpy as np
    import torch

    B, S = shape.dims["global_batch"], shape.dims["seq_len"]
    dims = {"train": (B, S + 1), "prefill": (B, S), "decode": (B,)}
    if shape.step not in dims:
        raise ValueError(shape.step)
    toks = rng.integers(0, cfg.vocab, size=dims[shape.step])
    return {"tokens": torch.as_tensor(toks.astype(np.int32), device=device)}


def recsys_batch_for(cfg, shape: ShapeDef, rng, *, device) -> dict:
    """A concrete batch of ``shape`` for the recsys config ``cfg``, drawn
    from the numpy generator ``rng``: the leaves and dtypes of the
    reference's ``_recsys_batch`` (int32 tensors on ``device``).

    * train — ``data.synthetic.recsys_batch`` at the shape's batch;
    * serve — ``hist [B, L]`` and ``target [B]`` (BST), ``user_id [B]``,
      ``hist`` and one candidate list ``cands [C]`` (two-tower), else
      ``hist`` and ``cands [B, C]``: the reference's ``serve_recsys``
      draws, in its order;
    * retrieval — ``hist [1, L]`` (and ``user_id [1]`` for two-tower) and
      ``cands``, a ``CompressedIntArray`` of the shape's ``n_candidates``
      distinct sorted ids drawn from the table's rows ``[1,
      vocab_rows)``: vbyte, differential, block 128, its payload stride a
      multiple of the shape's ``payload_stride``.
    """
    import numpy as np
    import torch

    from repro_torch.data.synthetic import recsys_batch

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    B, L, k = shape.dims["batch"], cfg.seq_len, cfg.kind
    if shape.step == "train":
        b = recsys_batch(rng, k, B, L, cfg.n_items, n_mask=cfg.n_mask,
                         n_negatives=cfg.n_negatives, n_users=cfg.n_users)
        return {name: t(v) for name, v in b.items()}
    if shape.step == "serve":
        C = cfg.serve_candidates
        if k == "bst":
            return {"hist": t(rng.integers(1, cfg.n_items, (B, L))),
                    "target": t(rng.integers(1, cfg.n_items, B))}
        if k == "two_tower":
            return {"user_id": t(rng.integers(1, 100, B)),
                    "hist": t(rng.integers(1, cfg.n_items, (B, L))),
                    "cands": t(rng.integers(1, cfg.n_items, C))}
        return {"hist": t(rng.integers(1, cfg.n_items, (B, L))),
                "cands": t(rng.integers(1, cfg.n_items, (B, C)))}
    if shape.step == "retrieval":
        from repro_torch.core import CompressedIntArray

        n = shape.dims["n_candidates"]
        batch = {"hist": t(rng.integers(1, cfg.n_items, (1, L)))}
        if k == "two_tower":
            batch["user_id"] = t(rng.integers(1, max(cfg.n_users, 2), 1))
        ids = np.sort(rng.choice(np.arange(1, cfg.vocab_rows, dtype=np.int64),
                                 n, replace=False))
        batch["cands"] = CompressedIntArray.encode(
            ids.astype(np.uint64), differential=True,
            stride_multiple=shape.dims["payload_stride"], device=device)
        return batch
    raise ValueError((k, shape.step))


def reduced_config(arch_id: str):
    """Tiny same-family config: a few layers and experts, small dims and
    tables."""
    mod = _module(arch_id)
    cfg, fam = mod.CONFIG, mod.FAMILY
    if fam == "lm":
        moe = cfg.moe and dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_ff=64, capacity_factor=2.0,
        )
        return dataclasses.replace(
            cfg, n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=16,
            d_ff=128, vocab=512, moe=moe, window=cfg.window and 16,
            q_chunk=16, kv_chunk=16, loss_chunk=8,
        )
    if fam == "gnn":
        return dataclasses.replace(cfg, n_layers=2, d_hidden=16,
                                   d_feat=12, n_classes=3)
    return dataclasses.replace(
        cfg, n_items=1000, n_users=max(cfg.n_users and 1000, 0),
        embed_dim=16, id_dim=16, seq_len=min(cfg.seq_len, 12),
        n_blocks=1, n_heads=2 if cfg.kind != "sasrec" else 1,
        mlp_dims=(32, 16) if cfg.mlp_dims else (),
        n_mask=min(cfg.n_mask, 3) if cfg.n_mask else 0, n_negatives=16,
        serve_candidates=32,
    )
