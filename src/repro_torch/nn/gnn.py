"""GIN message passing over an edge list, and the decode of compressed
adjacency.

The port of ``repro/nn/gnn.py``. Each node's incoming messages are
summed by ``kernels.segment_sum.owner_sum`` over edges grouped by owner
(CSR order), in edge order: the reference's ``segment_sum`` order, the
same bits on every run, and no ``[E, d]`` message tensor; its backward
sums each node's gradients over the edges grouped by source, built once
per forward (``segments_by_source``). Adjacency
arrives as raw ``(src, dst)``, grouped once per forward
(``segments_from_owners``), or as a VByte-compressed gap stream decoded
on the device by :func:`decode_compressed_edges`, already in CSR order.

The reference's ``constrain`` calls place activations on its mesh; over
the port's mesh each replica already holds its own rows
(``distributed/api.py``), so they are not carried over.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.core.vbyte.masked import to_i32_bits
from repro_torch.kernels.segment_sum import Segments, owner_sum
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

    def forward(self, h, src, seg: Segments, *, edge_valid=None,
                dtype=DEFAULT_COMPUTE_DTYPE, agg_dtype=torch.float32,
                by_source=None):
        return gin_layer(self, h, src, seg, edge_valid=edge_valid,
                         dtype=dtype, agg_dtype=agg_dtype,
                         by_source=by_source)


def gin_layer_init(d_in: int, d_out: int, *,
                   generator: torch.Generator) -> GINLayer:
    dev = generator.device
    return GINLayer(torch.zeros((), device=dev),
                    dense_init(d_in, d_out, generator=generator),
                    torch.zeros(d_out, device=dev),
                    dense_init(d_out, d_out, generator=generator),
                    torch.zeros(d_out, device=dev))


def gin_layer(params: GINLayer, h: torch.Tensor, src: torch.Tensor,
              seg: Segments, *, edge_valid: torch.Tensor | None = None,
              dtype=DEFAULT_COMPUTE_DTYPE, agg_dtype=torch.float32,
              by_source=None) -> torch.Tensor:
    """One GIN layer over edges grouped by owner: ``src`` int32 ``[E]`` in
    CSR order, ``seg`` their :class:`Segments` (one per node), and
    ``by_source`` the same edges grouped by source (``segments_by_source``)
    for the aggregation's backward where ``h`` requires grad.
    ``agg_dtype`` is the message/aggregation precision: ``h`` is gathered
    in its own type and summed in ``agg_dtype`` (the reference gathers,
    then casts: the same values)."""
    agg = owner_sum(h, src, seg, edge_valid, accumulate=agg_dtype,
                    by_source=by_source)
    return gin_update(params, h, agg, dtype=dtype, agg_dtype=agg_dtype)


def gin_update(params: GINLayer, h: torch.Tensor, agg: torch.Tensor, *,
               dtype=DEFAULT_COMPUTE_DTYPE, agg_dtype=torch.float32
               ) -> torch.Tensor:
    """The layer after its aggregation: ``MLP((1 + ε)·h + agg)`` over the
    rows of ``h`` and their sums ``agg`` (``agg_dtype``)."""
    scale = (1.0 + params.eps).to(agg_dtype)
    x = (scale * h.to(agg_dtype) + agg).to(dtype)
    x = torch.relu(x @ params.mlp1.to(dtype) + params.b1.to(dtype))
    x = x @ params.mlp2.to(dtype) + params.b2.to(dtype)
    return torch.relu(x)


def edge_owners(row_offsets: torch.Tensor, n_edges: int,
                start: int = 0) -> torch.Tensor:
    """The list l(e) that edge e belongs to, ``row_offsets[l] <= e <
    row_offsets[l+1]``, for the edges ``start .. start + n_edges``: int32
    ``[n_edges]`` on ``row_offsets``' device. Metadata only — it does not
    wait for the decode."""
    row_offsets = as_i32_bits(row_offsets)
    e_idx = torch.arange(start, start + n_edges, dtype=torch.int32,
                         device=row_offsets.device)
    return torch.searchsorted(row_offsets, e_idx, right=True,
                              out_int32=True) - 1


def edge_bases(gaps, row_gap_bases: torch.Tensor,
               owner: torch.Tensor) -> torch.Tensor:
    """``adjacency_rebase``'s ``edge_base`` operand: int32 ``[n_blocks,
    block_size]`` on the gaps' device, slot e holding the gap-stream
    running sum at the start of edge e's list (``row_gap_bases[owner[e]]``),
    0 past the last edge."""
    nb, block_size = gaps.n_blocks, gaps.block_size
    edge_base = torch.zeros(nb * block_size, dtype=torch.int32,
                            device=gaps.device)
    edge_base[:owner.numel()] = as_i32_bits(
        row_gap_bases.to(gaps.device)).index_select(0, owner)
    return edge_base.reshape(nb, block_size)


def decode_compressed_edges(gaps, row_offsets, n_edges: int, *,
                            row_gap_bases=None, plan="auto", start: int = 0):
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
    aggregated, and the list's owner. ``gaps`` may be a range of the
    stream's blocks whose first edge is ``start`` (a position's range over
    a mesh): the rebase reads each edge's list from the whole
    ``row_offsets``, so that range decodes alone.
    """
    from repro_torch.kernels.vbyte_decode import dispatch

    dev = gaps.device
    row_offsets = as_i32_bits(row_offsets.to(dev))
    owner = edge_owners(row_offsets, n_edges, start)
    if start and row_gap_bases is None:
        raise ValueError("a range of the gap stream decodes alone only with "
                         "row_gap_bases")

    if row_gap_bases is not None:
        # fused one-pass path: per-edge rebase inside the kernel epilogue
        edge_base = edge_bases(gaps, row_gap_bases, owner)
        nbr_grid = dispatch.decode(
            gaps, epilogue="adjacency_rebase",
            epilogue_operands={"edge_base": edge_base}, plan=plan)
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
