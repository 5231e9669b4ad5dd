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
                                gin_layer_init, gin_update)


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
    """Mean cross-entropy over the (masked) labels, and the accuracy.
    ``params`` may be a ``data_parallel.RowSplit`` with ``batch`` its
    positions' parts (a node batch split by node rows and edges:
    :func:`_split_forward`); the per-node terms are joined at home and
    reduced as one batch's."""
    from repro_torch.distributed.data_parallel import RowSplit

    if isinstance(params, RowSplit):
        if cfg.task != "node":
            raise ValueError("a graph-task batch is replicated, not split "
                             "by rows")
        logits = _split_forward(params, batch, cfg, dtype=dtype)
        terms = [_terms(lg, b) for lg, b in zip(logits, batch)]
        return _reduce({k: params.gather([t[k] for t in terms])
                        for k in terms[0]})
    return _reduce(_terms(forward(params, batch, cfg, dtype=dtype), batch))


def _terms(logits, batch) -> dict:
    """Per-node (or per-graph) cross-entropy and hits, masked where the
    batch has a ``label_mask``."""
    labels = batch["labels"].to(torch.int64)
    mask = batch.get("label_mask")
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.take_along_dim(logp, labels[:, None], dim=-1)[:, 0]
    acc = torch.argmax(logits, dim=-1) == labels
    if mask is None:
        return {"nll": nll, "acc": acc}
    return {"nll": torch.where(mask, nll, 0.0), "mask": mask,
            "acc": torch.where(mask, acc, False)}


def _reduce(t: dict):
    if "mask" not in t:
        return t["nll"].sum() / t["nll"].shape[0], {
            "accuracy": t["acc"].float().mean()}
    denom = torch.clamp(t["mask"].sum(), min=1)
    return t["nll"].sum() / denom, {"accuracy": t["acc"].sum() / denom}


# ----------------------------------------------------------------------------
# a node batch split over a mesh's positions
# ----------------------------------------------------------------------------
def _position_edges(parts: list, p: int, cfg: GNNConfig, n_nodes: int,
                    grad: bool):
    """Position ``p``'s edges: ``(src, segments, by_source, lo, hi)`` with
    ``src`` masked (-1) where invalid and grouped by owner, each owner's
    edges in batch order; ``segments`` over the owners ``lo .. hi`` that
    its edges reach; ``by_source`` (with ``grad``) its edges grouped by
    source over all ``n_nodes`` rows, owners counted from ``lo``.
    Compressed adjacency: the position's gap blocks decode alone (kernel
    2's ``adjacency_rebase``, one launch), its edge range the blocks' and
    ``edge_valid`` read over that range from the positions that hold it."""
    from repro_torch.distributed.data_parallel import (block_offsets,
                                                       realign, rows_of)

    b = parts[p]
    if not cfg.compressed_adjacency:  # grouped over every owner
        src, seg, valid, by = _edges_from_batch(b, cfg, n_nodes, grad=grad)
        if valid is not None:
            src = torch.where(valid, src, -1)
        return src, seg, by, 0, n_nodes
    gaps, ro = b["gaps"], b["row_offsets"]
    dev = gaps.device
    if b.get("row_gap_bases") is None:
        raise ValueError("a split gap stream decodes by ranges: the batch "
                         "needs row_gap_bases")
    spans = rows_of(parts, "edge_valid")
    n_edges = spans[-1][1]
    e0 = min(block_offsets(parts, "gaps")[p] * gaps.block_size, n_edges)
    e1 = min(e0 + gaps.n_blocks * gaps.block_size, n_edges)
    if e1 == e0:
        empty = torch.zeros(0, dtype=torch.int32, device=dev)
        seg = segments(torch.zeros(1, dtype=torch.int32, device=dev))
        return (empty, seg, segments_by_source(empty, empty, n_nodes)
                if grad else None, 0, 0)
    nbr, owner = decode_compressed_edges(
        gaps, ro, e1 - e0, row_gap_bases=b["row_gap_bases"],
        plan=cfg.decode_plan, start=e0)
    valid = realign([q["edge_valid"] for q in parts], spans, e0, e1, dev)
    lo, hi = (int(x) for x in torch.stack([owner[0], owner[-1]]).tolist())
    hi += 1
    local = owner - lo
    ro_local = ro.to(dev)[lo:hi + 1].clamp(e0, e1) - e0
    by = segments_by_source(nbr, local, n_nodes, valid) if grad else None
    return torch.where(valid, nbr, -1), segments(ro_local), by, lo, hi


def _owner_rows(partials: list, spans: list, lo: int, hi: int, device,
                dtype) -> torch.Tensor:
    """The sums of the owners ``lo .. hi`` on ``device``: the positions'
    partial sums (``partials[p]`` over the owners ``spans[p]``) added in
    position order, zero rows where a position reaches none."""
    out = None
    for x, (a, b) in zip(partials, spans):
        s, e = max(a, lo), min(b, hi)
        if s >= e:
            continue
        piece = torch.nn.functional.pad(x[s - a:e - a].to(device),
                                        (0, 0, s - lo, hi - e))
        out = piece if out is None else out + piece
    if out is None:
        out = torch.zeros((hi - lo, partials[0].shape[1]), dtype=dtype,
                          device=device)
    return out


def _split_forward(split, parts: list, cfg: GNNConfig, *,
                   dtype=nnl.DEFAULT_COMPUTE_DTYPE) -> list:
    """:func:`forward` of a node batch whose node rows and edges ``split``
    spreads over its positions: each position's logits for its nodes.
    Each layer shares ``h`` once (``RowSplit.share``: its backward adds
    the positions' source-side gradients in position order); each
    position sums its edges by owner (``owner_sum`` over its range), and
    an owner whose edges straddle positions adds their partials in
    position order."""
    from repro_torch.distributed.data_parallel import rows_of

    agg_dtype = torch.bfloat16 if cfg.agg_dtype == "bf16" else torch.float32
    models = split.replicas
    grad = torch.is_grad_enabled() and any(p.requires_grad for p in
                                           models[0].parameters())
    h = [b["feats"].to(dtype) for b in parts]
    nodes = rows_of(parts, "feats")
    n_nodes = nodes[-1][1]
    edges = [_position_edges(parts, p, cfg, n_nodes, grad)
             for p in range(split.n)]
    spans = [(e[3], e[4]) for e in edges]
    for i in range(len(models[0].layers)):
        whole = split.share(h)
        partials = [owner_sum(w, src, seg, accumulate=agg_dtype, by_source=by)
                    for w, (src, seg, by, _, _) in zip(whole, edges)]
        h = [gin_update(m.layers[i], hq, _owner_rows(
                 partials, spans, lo, hi, dev, agg_dtype),
                 dtype=dtype, agg_dtype=agg_dtype)
             for m, hq, (lo, hi), dev in zip(models, h, nodes, split.devices)]
    return [(hq @ m.head_w.to(dtype) + m.head_b.to(dtype)).float()
            for m, hq in zip(models, h)]
