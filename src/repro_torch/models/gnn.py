"""GIN (Xu et al., arXiv:1810.00826) — node and graph classification.

The port of ``repro/models/gnn.py``: ``GNNConfig``, ``init_params``,
``forward`` and ``loss_fn``, over raw edge-index batches or
VByte-compressed adjacency decoded on the card. A batch is a dict of
tensors: ``feats [N, d_feat]``, ``labels``, optional ``label_mask``
``[N]`` (node task) or ``graph_ids [N]`` (graph task), ``edge_valid
[E]``, and either ``edge_src``/``edge_dst [E]`` or the fields of
``repro_torch.data.graph.compress_adjacency``. ``loss_fn`` is
differentiable in the parameters (``repro_torch.train.make_train_step``):
where they require grad, each forward also groups its edges by source
once, for the aggregation's backward.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.kernels.segment_sum import (owner_sum, segments,
                                             segments_by_source,
                                             segments_from_owners)
from repro_torch.nn import layers as nnl
from repro_torch.nn.gnn import (GINLayer, decode_compressed_edges, gin_layer,
                                gin_layer_init)


@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 64
    d_feat: int = 1433
    n_classes: int = 7
    task: str = "node"  # "node" | "graph"
    compressed_adjacency: bool = False  # batch carries a VByte gap stream
    decode_plan: str = "auto"  # dispatch plan: auto|cuda|torch|fused|unfused
    agg_dtype: str = "f32"  # message/aggregation precision: "f32" | "bf16"
    feats_dtype: str = "f32"  # input feature storage: "f32" | "bf16"
    extras: dict[str, Any] = field(default_factory=dict)

    def param_count(self) -> int:
        d, h = self.d_feat, self.d_hidden
        per = lambda din: din * h + h + h * h + h + 1  # noqa: E731
        return per(d) + (self.n_layers - 1) * per(h) + h * self.n_classes + self.n_classes


class GIN(nn.Module):
    """``n_layers`` GIN layers and a linear head ``head_w [d_hidden,
    n_classes]``, ``head_b [n_classes]``."""

    def __init__(self, layers: list[GINLayer], head_w, head_b):
        super().__init__()
        self.layers = nn.ModuleList(layers)
        self.head_w = nnl._param(head_w)
        self.head_b = nnl._param(head_b)

    def tree(self) -> dict:
        """The parameters under the reference's tree paths:
        ``layers/gin_i/{eps, mlp1/w, b1, mlp2/w, b2}`` and ``head/{w, b}``
        (``repro_torch.tree.flatten`` gives them in its leaf order)."""
        return {"layers": {f"gin_{i}": {"eps": g.eps, "mlp1": {"w": g.mlp1},
                                        "b1": g.b1, "mlp2": {"w": g.mlp2},
                                        "b2": g.b2}
                           for i, g in enumerate(self.layers)},
                "head": {"w": self.head_w, "b": self.head_b}}


def init_params(cfg: GNNConfig, *, generator: torch.Generator | None = None,
                seed: int = 0, device=None) -> GIN:
    """Random GIN parameters on ``device`` (default: the card)."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(seed)
    layers = [gin_layer_init(cfg.d_feat if i == 0 else cfg.d_hidden,
                             cfg.d_hidden, generator=generator)
              for i in range(cfg.n_layers)]
    return GIN(layers, nnl.dense_init(cfg.d_hidden, cfg.n_classes,
                                      generator=generator),
               torch.zeros(cfg.n_classes, device=generator.device))


def _edges_from_batch(batch, cfg: GNNConfig, n_nodes: int, *, grad: bool):
    """``(src, segments, edge_valid, by_source)``: the edges grouped by
    owner (the node that receives the message), each owner's edges in
    batch order; with ``grad``, also grouped by source, each source's
    edges in batch order (the order of the reference's scatter-add in its
    backward), else ``None``."""
    edge_valid = batch.get("edge_valid")
    if cfg.compressed_adjacency:
        n_edges = batch["edge_valid"].shape[0]  # edge capacity
        # CSR order already: (neighbor = src of the message, list owner)
        nbr, owner = decode_compressed_edges(
            batch["gaps"], batch["row_offsets"], n_edges,
            row_gap_bases=batch.get("row_gap_bases"), plan=cfg.decode_plan)
        by = (segments_by_source(nbr, owner, n_nodes, edge_valid)
              if grad else None)
        return (nbr, segments(batch["row_offsets"].to(nbr.device)),
                edge_valid, by)
    # raw edges: one stable sort by owner per forward
    src, dst = batch["edge_src"].to(torch.int32), batch["edge_dst"]
    perm, seg = segments_from_owners(dst, n_nodes)
    by = segments_by_source(src, dst, n_nodes, edge_valid) if grad else None
    return (src[perm], seg, None if edge_valid is None else edge_valid[perm],
            by)


def forward(params: GIN, batch, cfg: GNNConfig, *,
            dtype=nnl.DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    """Per-node logits ``[N, C]`` (node task) or per-graph ``[G, C]``,
    float32."""
    agg_dtype = torch.bfloat16 if cfg.agg_dtype == "bf16" else torch.float32
    grad = torch.is_grad_enabled() and any(p.requires_grad
                                           for p in params.parameters())
    h = batch["feats"].to(dtype)
    n_nodes = h.shape[0]
    src, seg, edge_valid, by = _edges_from_batch(batch, cfg, n_nodes,
                                                 grad=grad)
    if edge_valid is not None:  # masked edges as source -1, once per forward
        src = torch.where(edge_valid, src, -1)
    for layer in params.layers:
        h = gin_layer(layer, h, src, seg, dtype=dtype, agg_dtype=agg_dtype,
                      by_source=by)
    if cfg.task == "graph":
        # sum-pool readout per graph (n_graphs = the label count), in h's
        # type, rounded after every add as the reference's segment_sum
        gids = batch["graph_ids"]
        perm, gseg = segments_from_owners(gids, batch["labels"].shape[0])
        nodes = torch.arange(n_nodes, dtype=torch.int32, device=h.device)
        h = owner_sum(h, perm.to(torch.int32), gseg, accumulate=h.dtype,
                      by_source=(segments_by_source(nodes, gids, n_nodes)
                                 if grad else None))
    logits = h @ params.head_w.to(dtype) + params.head_b.to(dtype)
    return logits.float()


def loss_fn(params: GIN, batch, cfg: GNNConfig, *,
            dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    """Mean cross-entropy over the (masked) labels, and the accuracy."""
    logits = forward(params, batch, cfg, dtype=dtype)
    labels = batch["labels"].to(torch.int64)
    mask = batch.get("label_mask")
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, labels[:, None], dim=-1)[:, 0]
    if mask is not None:
        nll = torch.where(mask, nll, 0.0)
        denom = torch.clamp(mask.sum(), min=1)
    else:
        denom = nll.shape[0]
    loss = nll.sum() / denom
    acc = torch.argmax(logits, dim=-1) == labels
    if mask is not None:
        acc = torch.where(mask, acc, False).sum() / denom
    else:
        acc = acc.float().mean()
    return loss, {"accuracy": acc}
