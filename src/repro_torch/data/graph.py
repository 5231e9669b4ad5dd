"""VByte-compressed adjacency (the paper's posting lists = neighbor lists).

The port of ``repro/data/graph.py``. Each CSR row (sorted neighbor ids) is
delta-encoded independently — the first gap is the absolute id — and the
concatenated gap stream is VByte-blocked. The card decodes the gaps and
rebuilds ids with a per-list prefix sum
(``repro_torch.nn.gnn.decode_compressed_edges``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.core.compressed_array import CompressedIntArray
from repro_torch.core.vbyte.encode import encode_blocked

from .sampler import CSRGraph


def adjacency_gaps(csr: CSRGraph) -> np.ndarray:
    """Per-row delta stream: gaps[e] = indices[e] - indices[e-1], absolute at row starts."""
    idx = csr.indices.astype(np.int64)
    gaps = np.empty_like(idx)
    gaps[1:] = idx[1:] - idx[:-1]
    gaps[0] = idx[0] if len(idx) else 0
    starts = csr.indptr[:-1]
    starts = starts[starts < len(idx)]
    gaps[starts] = idx[starts]
    if np.any(gaps < 0):
        raise ValueError("CSR rows must be sorted for delta encoding")
    return gaps.astype(np.uint64)


def compress_adjacency(csr: CSRGraph, *, block_size: int = 128,
                       device=None) -> dict:
    """The compressed adjacency fields of a GNN batch, on ``device``
    (default: the card).

    ``gaps`` is a ``CompressedIntArray``: the blocked VByte gap stream with
    ``differential=True`` against precomputed running-sum ``bases``
    [n_blocks] — the gap running sum entering each block, which makes the
    global cumsum a block-local differential decode (the inverted index's
    skip pointers, applied to adjacency). ``row_gap_bases`` [n_nodes] —
    the running sum entering each list, int32 holding uint32 bits — makes
    absolute-id reconstruction local to each block. ``row_offsets`` is
    the CSR ``indptr`` as int32, ``edge_valid`` all true.
    """
    dev = resolve_device(device)
    gaps = adjacency_gaps(csr)
    enc = encode_blocked(gaps, block_size=block_size, differential=False)
    csum = np.concatenate([[0], np.cumsum(gaps, dtype=np.uint64)]).astype(np.uint64)
    block_starts = np.arange(enc.n_blocks) * block_size
    block_starts = np.minimum(block_starts, len(gaps))
    row_starts = np.minimum(csr.indptr[:-1], len(gaps))
    gaps_arr = CompressedIntArray.from_operands(
        {"payload": enc.payload, "counts": enc.counts,
         "bases": csum[block_starts].astype(np.uint32)},  # running-sum bases
        format="vbyte", block_size=block_size, differential=True,
        n=len(gaps), payload_bytes=enc.payload_bytes, device=dev)
    row_bases = csum[row_starts].astype(np.uint32).view(np.int32)
    return {
        "gaps": gaps_arr,
        "row_gap_bases": torch.as_tensor(row_bases, device=dev),
        "row_offsets": torch.as_tensor(csr.indptr.astype(np.int32), device=dev),
        "edge_valid": torch.ones(csr.n_edges, dtype=torch.bool, device=dev),
        "_bits_per_edge": enc.bits_per_int
        + 32.0 * (enc.n_blocks + csr.n_nodes) / max(csr.n_edges, 1),
    }
