"""Two-tower retrieval: the towers, and scoring against a compressed
candidate list.

The port of the two-tower parts of ``repro/models/recsys.py``:
``RecSysConfig`` (whole), ``init_params`` for ``kind="two_tower"``,
``user_tower``, ``user_tower_compressed``, ``item_tower`` and
``retrieval_scores_compressed``. The parameters live in a
:class:`TwoTower` module; the tower functions keep the reference's
signatures. The sasrec, bert4rec and bst kinds need the attention stack
and raise ``NotImplementedError`` until it is ported (ROADMAP queue 1
item 14).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
from torch import nn

from repro_torch._device import resolve_device
from repro_torch.nn import layers as nnl
from repro_torch.nn.embedding_bag import bag_from_padded

_LATER = ("recsys kind {!r} needs the attention stack, which is not ported "
          "yet (ROADMAP queue 1 item 14)")


@dataclass(frozen=True)
class RecSysConfig:
    name: str
    kind: str  # "sasrec" | "bert4rec" | "bst" | "two_tower"
    n_items: int
    embed_dim: int
    seq_len: int
    n_blocks: int = 2
    n_heads: int = 1
    mlp_dims: tuple[int, ...] = ()
    n_users: int = 0  # two-tower
    id_dim: int = 128  # two-tower id embedding width
    n_mask: int = 0  # bert4rec masked positions per sequence
    n_negatives: int = 1024  # sampled-softmax shared negatives
    serve_candidates: int = 4096
    # serving-time embedding-table layout of the reference's mesh engine:
    # "row" | "replicated" | "column" (one device here: unused)
    serve_table_mode: str = "row"
    extras: dict[str, Any] = field(default_factory=dict)

    @property
    def vocab_rows(self) -> int:
        # +2: padding id 0 is reserved, bert4rec adds a [MASK] row at the end;
        # rounded to a multiple of 512 (the reference row-shards the table)
        return -(-(self.n_items + 2) // 512) * 512

    @property
    def user_rows(self) -> int:
        return -(-(self.n_users + 2) // 512) * 512

    def param_count(self) -> int:
        d = self.embed_dim
        if self.kind == "two_tower":
            n = self.user_rows * self.id_dim + self.vocab_rows * self.id_dim
            dims_u = (self.id_dim * 2,) + self.mlp_dims
            dims_i = (self.id_dim,) + self.mlp_dims
            n += sum(a * b + b for a, b in zip(dims_u[:-1], dims_u[1:]))
            n += sum(a * b + b for a, b in zip(dims_i[:-1], dims_i[1:]))
            return n
        n = self.vocab_rows * d + (self.seq_len + 1) * d
        per_block = 4 * d * d + 2 * (d * d + d) + 4 * d  # attn + pw-ffn + norms
        n += self.n_blocks * per_block
        if self.kind == "bst":
            dims = ((self.seq_len + 1) * d,) + self.mlp_dims + (1,)
            n += sum(a * b + b for a, b in zip(dims[:-1], dims[1:]))
        return n

    def dense_flops_per_example(self) -> int:
        """Approx fwd FLOPs per scored example."""
        d = self.embed_dim
        if self.kind == "two_tower":
            dims_u = (self.id_dim * 2,) + self.mlp_dims
            dims_i = (self.id_dim,) + self.mlp_dims
            mm = sum(a * b for a, b in zip(dims_u[:-1], dims_u[1:]))
            mm += sum(a * b for a, b in zip(dims_i[:-1], dims_i[1:]))
            return 2 * mm
        L = self.seq_len + (1 if self.kind == "bst" else 0)
        per_block = 2 * L * (6 * d * d) + 2 * 2 * L * L * d  # proj+ffn, qk+pv
        n = self.n_blocks * per_block
        if self.kind == "bst":
            dims = (L * d,) + self.mlp_dims + (1,)
            n += 2 * sum(a * b for a, b in zip(dims[:-1], dims[1:]))
        return n


class TwoTower(nn.Module):
    """Two-tower parameters: id embeddings (float32 ``[rows, id_dim]``) and
    the user and item MLP towers. The user tower reads the user's id
    embedding and the mean of its history's item-id embeddings."""

    def __init__(self, user_emb: torch.Tensor, item_id_emb: torch.Tensor,
                 user_mlp: nnl.MLP, item_mlp: nnl.MLP):
        super().__init__()
        self.user_emb = nnl._param(user_emb)
        self.item_id_emb = nnl._param(item_id_emb)
        self.user_mlp = user_mlp
        self.item_mlp = item_mlp


def init_params(cfg: RecSysConfig, *, generator: torch.Generator | None = None,
                seed: int = 0, device=None) -> TwoTower:
    """Random two-tower parameters on ``device`` (default: the card), drawn
    from ``generator`` (default: one on ``device`` seeded with ``seed``)."""
    if cfg.kind != "two_tower":
        raise NotImplementedError(_LATER.format(cfg.kind))
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(seed)
    g = generator
    return TwoTower(
        nnl.embedding_init(cfg.user_rows, cfg.id_dim, generator=g),
        nnl.embedding_init(cfg.vocab_rows, cfg.id_dim, generator=g),
        nnl.mlp_init((cfg.id_dim * 2,) + cfg.mlp_dims, generator=g),
        nnl.mlp_init((cfg.id_dim,) + cfg.mlp_dims, generator=g))


def _normalize(v, dtype):
    norm = torch.linalg.vector_norm(v.float(), dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=1e-6).to(dtype)


def user_tower(params: TwoTower, user_id, hist, cfg: RecSysConfig, *,
               dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    u = nnl.embedding_lookup(params.user_emb, user_id, dtype=dtype)  # [B, id_dim]
    bag = bag_from_padded(params.item_id_emb, hist, mode="mean", dtype=dtype)
    x = torch.cat([u, bag], dim=-1)
    return _normalize(nnl.mlp(params.user_mlp, x, dtype=dtype), dtype)


def user_tower_compressed(params: TwoTower, user_id, hists,
                          cfg: RecSysConfig, *, plan="auto",
                          dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    """User tower over compressed histories: the mean-bag is kernel 2's
    ``bag_sum`` epilogue on the card. ``hists`` is
    ``CompressedIntArray.encode_ragged(histories, block_size=seq_len)``,
    one block per user. Matches ``user_tower`` when the padded histories
    hold the same ids (pad id 0 excluded)."""
    from repro_torch.nn.embedding_bag import embedding_bag_compressed

    u = nnl.embedding_lookup(params.user_emb, user_id, dtype=dtype)
    bag = embedding_bag_compressed(params.item_id_emb, hists, mode="mean",
                                   plan=plan, dtype=dtype)[: u.shape[0]]
    x = torch.cat([u, bag.to(dtype)], dim=-1)
    return _normalize(nnl.mlp(params.user_mlp, x, dtype=dtype), dtype)


def item_tower(params: TwoTower, item_ids, cfg: RecSysConfig, *,
               dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    x = nnl.embedding_lookup(params.item_id_emb, item_ids, dtype=dtype)
    return _normalize(nnl.mlp(params.item_mlp, x, dtype=dtype), dtype)


def item_table(params: TwoTower, cfg: RecSysConfig, *,
               dtype=nnl.DEFAULT_COMPUTE_DTYPE,
               chunk: int = 1 << 20) -> torch.Tensor:
    """``item_tower`` over the whole (rounded) vocabulary, ``[vocab_rows,
    d]`` in ``dtype``, computed ``chunk`` rows at a time: rows are
    independent, and the whole vocabulary at once would hold a
    ``[vocab_rows, 1024]`` intermediate (17.2 GB at 2^23 items)."""
    dev = params.item_id_emb.device
    V = cfg.vocab_rows
    out = None
    for s in range(0, V, chunk):
        ids = torch.arange(s, min(s + chunk, V), device=dev)
        t = item_tower(params, ids, cfg, dtype=dtype).to(dtype)
        if out is None:
            out = torch.empty((V, t.shape[1]), dtype=dtype, device=dev)
        out[s:s + t.shape[0]] = t
    return out


def topk_lower_index(scores: torch.Tensor, k: int):
    """``(values, indices)`` of the ``k`` largest along the last axis, equal
    scores ordered by lower index first (``jax.lax.top_k``'s order;
    ``torch.topk`` promises none): a stable descending sort."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def retrieval_scores_compressed(params: TwoTower, batch, cfg: RecSysConfig, *,
                                top_k: int = 100, plan="auto",
                                dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    """retrieval_cand: score one user against a compressed candidate list.

    ``batch["cands"]`` is the sorted candidate ids as a
    ``CompressedIntArray`` (delta-coded, any format); ``batch["user_id"]``
    ``[1]`` and ``batch["hist"]`` ``[1, seq_len]``. The two-tower head
    decodes, then scores: the candidates run through the item tower.
    Returns ``(scores [C], (top scores, top ids))``, where ``C`` counts
    every slot of the decoded grid (pad slots are id 0, as in the
    reference). ``plan="auto"`` decodes with the kernels on the card (the
    reference's off-TPU switch to its gather-lowered decoder is a TPU
    lowering choice; the decoded ids are the same). The reference's
    deprecated unpacked ``cand_*`` batch keys are not ported.
    """
    from repro_torch.kernels.vbyte_decode import dispatch

    if cfg.kind != "two_tower":
        raise NotImplementedError(_LATER.format(cfg.kind))
    cands = dispatch.decode(batch["cands"], plan=plan).reshape(-1)
    u = user_tower(params, batch["user_id"], batch["hist"], cfg, dtype=dtype)
    i = item_tower(params, cands, cfg, dtype=dtype)  # [C, v]
    scores = (i @ u[0]).float()
    top_s, top_i = topk_lower_index(scores, top_k)
    return scores, (top_s, cands[top_i])
