"""GIN message passing over an edge list, and the decode of compressed
adjacency.

The port of ``repro/nn/gnn.py``. Messages are gathered from the source
nodes and summed into the destinations with ``index_add_`` (on the card,
atomics: the order of the float sums changes from run to run).
Adjacency arrives as raw ``(src, dst)`` or as a VByte-compressed gap
stream decoded on the device by :func:`decode_compressed_edges`.

The reference's ``constrain`` calls are sharding annotations for its
device mesh; one card has no counterpart, so they are dropped.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.vbyte.masked import to_i32_bits
from repro_torch.kernels.vbyte_decode.ops import as_i32_bits

from .layers import DEFAULT_COMPUTE_DTYPE, _param, dense_init


class GINLayer(nn.Module):
    """h' = MLP((1 + ε)·h + Σ_{j∈N(i)} h_j) — GIN-ε with a sum aggregator.
    ``eps`` is a float32 scalar, ``mlp1`` ``[d_in, d_out]``, ``mlp2``
    ``[d_out, d_out]``, biases ``b1``/``b2`` ``[d_out]``."""

    def __init__(self, eps, mlp1, b1, mlp2, b2):
        super().__init__()
        self.eps = _param(eps)
        self.mlp1 = _param(mlp1)
        self.b1 = _param(b1)
        self.mlp2 = _param(mlp2)
        self.b2 = _param(b2)

    def forward(self, h, src, dst, *, n_nodes: int, edge_valid=None,
                dtype=DEFAULT_COMPUTE_DTYPE, agg_dtype=torch.float32):
        return gin_layer(self, h, src, dst, n_nodes=n_nodes,
                         edge_valid=edge_valid, dtype=dtype,
                         agg_dtype=agg_dtype)


def gin_layer_init(d_in: int, d_out: int, *,
                   generator: torch.Generator) -> GINLayer:
    dev = generator.device
    return GINLayer(torch.zeros((), device=dev),
                    dense_init(d_in, d_out, generator=generator),
                    torch.zeros(d_out, device=dev),
                    dense_init(d_out, d_out, generator=generator),
                    torch.zeros(d_out, device=dev))


def gin_layer(params: GINLayer, h: torch.Tensor, src: torch.Tensor,
              dst: torch.Tensor, *, n_nodes: int,
              edge_valid: torch.Tensor | None = None,
              dtype=DEFAULT_COMPUTE_DTYPE,
              agg_dtype=torch.float32) -> torch.Tensor:
    """One GIN layer. ``agg_dtype`` is the message/aggregation precision.

    Memory: the ``[E, d]`` messages are the largest tensor (24.7 GB for
    ogbn-products' first layer in f32). They are gathered from ``h`` cast
    to ``agg_dtype`` (the reference gathers, then casts: the same values)
    and masked in place, where the reference's ``where`` makes a copy.
    """
    msgs = h.to(agg_dtype).index_select(0, src)  # [E, d]
    if edge_valid is not None:
        msgs.masked_fill_(~edge_valid[:, None], 0)
    agg = torch.zeros((n_nodes, msgs.shape[1]), dtype=agg_dtype,
                      device=msgs.device)
    agg.index_add_(0, dst, msgs)
    del msgs
    scale = (1.0 + params.eps).to(agg_dtype)
    x = (scale * h.to(agg_dtype) + agg).to(dtype)
    x = torch.relu(x @ params.mlp1.to(dtype) + params.b1.to(dtype))
    x = x @ params.mlp2.to(dtype) + params.b2.to(dtype)
    return torch.relu(x)


def decode_compressed_edges(gaps, row_offsets, n_edges: int, *,
                            row_gap_bases=None, plan="auto"):
    """Decode a per-list delta-encoded VByte adjacency stream on its device.

    ``gaps`` is the blocked gap stream as a ``CompressedIntArray``
    (``repro_torch.data.graph.compress_adjacency`` builds it): each node's
    sorted neighbor list is delta-encoded on its own (first gap = absolute
    id), and ``gaps.bases`` holds the gap-stream running sum at each block
    start, so the global inclusive cumsum is a per-block differential
    decode. ``row_gap_bases`` ``[n_nodes]`` (uint32, or int32 holding its
    bits) is the running sum at each list start. With it, the per-edge
    ``incl − row_gap_base`` subtraction runs in the decode kernel's
    ``adjacency_rebase`` epilogue (kernel 2 on the card), so the global
    cumsum never reaches device memory. Without it, the list bases are
    gathered from the decoded stream (the legacy global path: kernel 1
    on the card, then torch ops).

    Returns ``(src [E], dst [E])`` int32: the neighbor whose features are
    aggregated, and the list's owner.
    """
    from repro_torch.kernels.vbyte_decode import dispatch

    nb = gaps.n_blocks
    block_size = gaps.block_size
    dev = gaps.device
    row_offsets = as_i32_bits(row_offsets.to(dev))

    # edge e belongs to list l(e): row_offsets[l] <= e < row_offsets[l+1].
    # Metadata only — it does not wait for the decode.
    e_idx = torch.arange(n_edges, dtype=torch.int32, device=dev)
    owner = torch.searchsorted(row_offsets, e_idx, right=True,
                               out_int32=True) - 1
    del e_idx

    if row_gap_bases is not None:
        # fused one-pass path: per-edge rebase inside the kernel epilogue
        edge_base = torch.zeros(nb * block_size, dtype=torch.int32,
                                device=dev)
        edge_base[:n_edges] = as_i32_bits(row_gap_bases.to(dev)).index_select(
            0, owner)
        nbr_grid = dispatch.decode(
            gaps, epilogue="adjacency_rebase",
            epilogue_operands={"edge_base": edge_base.reshape(nb, block_size)},
            plan=plan)
        return nbr_grid.reshape(-1)[:n_edges], owner

    # legacy global path: differential decode against per-block running-sum
    # bases = the global inclusive cumsum of the gaps, computed per block;
    # each list's base is the exclusive cumsum at its first edge
    incl = dispatch.decode(gaps, plan=plan).reshape(-1)[:n_edges]
    excl = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                      incl[:-1]])
    base = excl.index_select(0, row_offsets.index_select(0, owner))
    nbr = to_i32_bits(incl.to(torch.int64) - base.to(torch.int64))
    return nbr, owner
