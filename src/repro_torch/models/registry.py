"""Architecture registry of the port: configs and shape resolution.

The port of the two-tower and gin-tu parts of ``repro/models/registry.py``
(``family_of``, ``resolve_config``, ``reduced_config``, and the GNN
family's ``_family_init`` for training). The LM and the other recsys
architectures, and recsys training, wait for the model stack (ROADMAP
queue 1 item 14); asking for them raises ``NotImplementedError``.
Abstract inputs, shardings and step functions are mesh/XLA tools with no
counterpart on one card.
"""
from __future__ import annotations

import dataclasses
import importlib

from repro_torch.configs.shapes import GNN_SHAPES, RECSYS_SHAPES, ShapeDef

ARCH_IDS = {
    "gin-tu": "repro_torch.configs.gin_tu",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
}
# the reference's other architectures, not ported yet
LATER_ARCHS = ("olmoe-1b-7b", "mixtral-8x7b", "h2o-danube-1.8b", "yi-6b",
               "glm4-9b", "sasrec", "bert4rec", "bst")


def _module(arch_id: str):
    if arch_id in LATER_ARCHS:
        raise NotImplementedError(
            f"architecture {arch_id!r} is not ported yet (ROADMAP queue 1 "
            "item 14)")
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}; expected one "
                         f"of {tuple(ARCH_IDS)}")
    return importlib.import_module(ARCH_IDS[arch_id])


def family_of(arch_id: str) -> str:
    return _module(arch_id).FAMILY


def shapes_of(arch_id: str) -> dict[str, ShapeDef]:
    return {"gnn": GNN_SHAPES, "recsys": RECSYS_SHAPES}[family_of(arch_id)]


def resolve_config(arch_id: str, shape_name: str, *, overrides=None):
    """The architecture's config for one shape: a GNN takes ``d_feat``,
    ``n_classes``, ``task`` and the adjacency mode from the shape."""
    mod = _module(arch_id)
    cfg = mod.CONFIG
    shape = shapes_of(arch_id)[shape_name]
    if mod.FAMILY == "gnn":
        cfg = dataclasses.replace(
            cfg, d_feat=shape.dims["d_feat"],
            n_classes=shape.dims["n_classes"],
            task=shape.dims.get("task", "node"),
            compressed_adjacency=shape.dims.get("compressed_adjacency", False))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def _family_init(fam: str):
    """The family's ``init_params(cfg, *, seed, device)`` for a train state:
    the GNN family's only."""
    if fam == "gnn":
        from repro_torch.models import gnn

        return gnn.init_params
    raise NotImplementedError(f"training the {fam!r} family is not ported "
                              "yet (ROADMAP queue 1 item 14)")


def reduced_config(arch_id: str):
    """Tiny same-family config: a few layers, small dims and tables."""
    mod = _module(arch_id)
    cfg, fam = mod.CONFIG, mod.FAMILY
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
