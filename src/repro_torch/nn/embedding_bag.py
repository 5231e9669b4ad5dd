"""EmbeddingBag from gather + segment sum, and the fused one-pass path.

The port of ``repro/nn/embedding_bag.py``. Ragged multi-hot id bags are
looked up with ``index_select`` and reduced with ``index_add_``; the id
lists themselves may be stored compressed, one bag per block.

* ``embedding_bag`` — decoded ids → gather → segment sum/mean/max.
* ``embedding_bag_compressed`` — the gather-sum runs in the decode
  kernel's ``bag_sum`` epilogue (kernel 2 on the card): the ids never
  leave shared memory. This is the path ``dispatch`` picks by default.
* ``bag_from_padded`` — fixed-width padded bags (the dense-batch path).
"""
from __future__ import annotations

import torch

from .layers import DEFAULT_COMPUTE_DTYPE


def _segment_sum(x, segment_ids, n):
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, segment_ids.to(torch.int64), x)


def embedding_bag(
    table: torch.Tensor,  # [V, d]
    ids: torch.Tensor,  # [N] int flat id stream
    segment_ids: torch.Tensor,  # [N] bag index per id (sorted)
    n_bags: int,
    *,
    mode: str = "sum",
    weights: torch.Tensor | None = None,  # [N] per-sample weights
    valid: torch.Tensor | None = None,  # [N] bool mask for padded ids
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> torch.Tensor:
    """Returns ``[n_bags, d]``."""
    vecs = table[ids.to(torch.int64)].to(dtype)  # [N, d]
    if weights is not None:
        vecs = vecs * weights[:, None].to(dtype)
    if valid is not None:
        vecs = torch.where(valid[:, None], vecs, 0)
    if mode == "sum":
        return _segment_sum(vecs, segment_ids, n_bags)
    if mode == "mean":
        s = _segment_sum(vecs, segment_ids, n_bags)
        ones = (torch.ones(ids.shape, dtype=dtype, device=ids.device)
                if valid is None else valid.to(dtype))
        cnt = _segment_sum(ones, segment_ids, n_bags)
        return s / torch.clamp(cnt, min=1)[:, None]
    if mode == "max":
        if valid is not None:
            vecs = torch.where(valid[:, None], vecs, -torch.inf)
        out = torch.full((n_bags, vecs.shape[1]), -torch.inf, dtype=vecs.dtype,
                         device=vecs.device)
        idx = segment_ids.to(torch.int64)[:, None].expand_as(vecs)
        out = out.scatter_reduce(0, idx, vecs, reduce="amax")
        return torch.where(torch.isfinite(out), out, 0)
    raise ValueError(f"unknown mode {mode!r}")


def embedding_bag_compressed(
    table: torch.Tensor,  # [V, d]
    bags,  # CompressedIntArray (one bag per block; see encode_ragged), or dict
    *,
    format: str | None = None,
    block_size: int | None = None,
    differential: bool | None = None,
    mode: str = "sum",
    plan="auto",
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> torch.Tensor:
    """Fused EmbeddingBag over a compressed id stream: one bag per block.

    ``bags`` is the ``CompressedIntArray`` from ``encode_ragged(...)`` (or
    any blocked layout where block b is bag b); with a raw operand dict the
    three metadata kwargs are required. Returns ``[n_blocks, d]`` in
    ``dtype``. On the card the gather-sum is kernel 2's ``bag_sum``
    epilogue. ``table.to(dtype)`` costs nothing when the caller already
    holds the table in ``dtype`` (``ServingEngine`` casts it once).
    """
    from repro_torch.kernels.vbyte_decode import dispatch

    counts = bags["counts"] if isinstance(bags, dict) else bags.counts
    out = dispatch.decode(
        bags, format=format, block_size=block_size,
        differential=differential, epilogue="bag_sum",
        epilogue_operands={"table": table.to(dtype)}, plan=plan)
    if mode == "sum":
        return out
    if mode == "mean":
        counts = counts.reshape(-1).to(out.dtype)
        return out / torch.clamp(counts, min=1)[:, None]
    raise ValueError(f"unknown mode {mode!r} (fused path supports sum|mean)")


def bag_from_padded(
    table: torch.Tensor,  # [V, d]
    padded_ids: torch.Tensor,  # [B, L] int, padded with pad_id
    *,
    pad_id: int = 0,
    mode: str = "sum",
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> torch.Tensor:
    """EmbeddingBag over fixed-width padded bags (the dense-batch path).
    Gathers, then casts (the reference casts the table first: the same
    values)."""
    vecs = table[padded_ids.to(torch.int64)].to(dtype)  # [B, L, d]
    valid = (padded_ids != pad_id)[..., None]
    vecs = torch.where(valid, vecs, 0)
    if mode == "sum":
        return vecs.sum(dim=1)
    if mode == "mean":
        return vecs.sum(dim=1) / torch.clamp(valid.sum(dim=1), min=1)
    raise ValueError(f"unknown mode {mode!r}")
