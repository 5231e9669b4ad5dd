"""Optimal block partitioning and per-list codec choice (shortest-path DP).

The port of ``repro/index/partition.py`` (numpy, so copied). The uniform
blocked layout cuts every posting list into fixed ``block_size``-integer
blocks: the right device shape, but the wrong compression shape for
binpack, where one outlier gap forces a whole block to its bit width.
This module keeps the device shape and frees the logical partition:
blocks of a ``CompressedIntArray`` may hold any count ``≤ block_size``
(``counts`` masks everywhere), so the builder can cut blocks at outliers.

Finding the cuts is a shortest path: nodes are candidate boundaries
(every ``grid``-th position, plus ``n``), an edge ``i → j``
(``j - i ≤ block_size``) is one block holding ``values[i:j]``, and its
weight is

    encoded payload bits  +  per-block metadata overhead
                          +  λ · modelled decode ops
                             (repro_torch.launch.cost_model.codec_decode_cost)

One DP per format; the format with the fewest payload bits wins the list,
ties (within ``slack_bits``) broken toward the cheaper decoder. The DP
relaxes edges in the reference's order with the same float64 additions,
so it picks the same bounds; it runs as a plain Python loop over lists,
which is several times faster than a numpy call per node.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.compressed_array import (CompressedIntArray,
                                               block_checksums)
from repro_torch.core.vbyte import binpack as bpk
from repro_torch.core.vbyte import encode as venc
from repro_torch.core.vbyte import stream_vbyte as svb
from repro_torch.launch.cost_model import (CODEC_BLOCK_OPS, CODEC_INT_OPS,
                                           codec_decode_cost)

PARTITION_FORMATS = ("vbyte", "streamvbyte", "binpack")

# Per-block metadata the tight payload accounting ignores: counts (4 B) +
# bases (4 B) + skip table entry (8 B). Charging it stops one-gap blocks.
BLOCK_OVERHEAD_BITS = 128.0

# λ: modelled decode ops → equivalent bits. Small by design — payload bits
# dominate, so bits/int can only improve over uniform blocks.
DEFAULT_LAMBDA = 0.02


@dataclass(frozen=True)
class Partition:
    """One list's chosen block partition + codec."""

    bounds: np.ndarray  # int64 [n_chunks + 1], bounds[0]=0, bounds[-1]=n
    format: str
    payload_bits: float  # tight encoded bits of this partition
    cost: float  # full DP objective (bits + overhead + λ·decode ops)

    @property
    def counts(self) -> np.ndarray:
        return np.diff(self.bounds).astype(np.int32)

    @property
    def n_chunks(self) -> int:
        return max(len(self.bounds) - 1, 0)


def _node_positions(n: int, grid: int) -> np.ndarray:
    pos = np.arange(0, n, grid, dtype=np.int64)
    return np.append(pos, n)


def _edge_bits(enc: np.ndarray, pos: np.ndarray, max_k: int,
               format: str) -> np.ndarray:
    """Payload bits of every candidate block: ``[n_nodes - 1, max_k]``.

    Entry ``(a, k-1)`` is the block spanning nodes ``a → a + k``;
    spans past the last node get ``+inf``.
    """
    m = pos.shape[0] - 1  # edges start at nodes 0..m-1
    bits = np.full((m, max_k), np.inf)
    if format == "binpack":
        # grid-cell width maxima, then a running max over k cells
        w = bpk.bit_widths(enc).astype(np.int64)
        cell_max = np.maximum.reduceat(w, pos[:-1])
        run = cell_max.astype(np.float64)
        for k in range(1, max_k + 1):
            if k > 1:
                run = np.maximum(run[:-1], cell_max[k - 1:])
            a = np.arange(run.shape[0])
            Lk = (pos[a + k] - pos[a]).astype(np.float64)
            bits[:run.shape[0], k - 1] = 8 * np.ceil(run * Lk / 8) + 8
        return bits
    if format == "vbyte":
        plen = np.concatenate([[0], np.cumsum(venc.vbyte_lengths(enc))])
    else:
        plen = np.concatenate([[0], np.cumsum(svb.svb_lengths(enc))])
    for k in range(1, max_k + 1):
        a = np.arange(max(m - k + 1, 0))
        i, j = pos[a], pos[a + k]
        b = 8.0 * (plen[j] - plen[i])
        if format == "streamvbyte":
            b = b + 8.0 * np.ceil((j - i) / 4.0)
        bits[: a.shape[0], k - 1] = b
    return bits


def _shortest_path(pos: np.ndarray, weights: np.ndarray,
                   max_k: int) -> tuple[float, np.ndarray]:
    """DAG shortest path over boundary nodes; returns (cost, bounds).

    Nodes relax their out-edges in ascending order and an edge wins only
    when strictly cheaper, so ties keep the earliest predecessor."""
    m = pos.shape[0]
    inf = float("inf")
    dist = [inf] * m
    prev = [0] * m
    dist[0] = 0.0
    rows = weights.tolist()
    for a in range(m - 1):
        d = dist[a]
        if d == inf:
            continue
        for j, w in enumerate(rows[a][:min(max_k, m - 1 - a)], a + 1):
            c = d + w
            if c < dist[j]:
                dist[j] = c
                prev[j] = a
    cuts = [m - 1]
    while cuts[-1] != 0:
        cuts.append(prev[cuts[-1]])
    return dist[m - 1], pos[np.array(cuts[::-1], np.int64)]


def choose_partition(
    docids: np.ndarray,
    *,
    block_size: int = 128,
    grid: int = 8,
    formats=PARTITION_FORMATS,
    lam: float = DEFAULT_LAMBDA,
    slack_bits: float = 0.0,
    differential: bool = True,
) -> Partition:
    """Pick the cheapest (format, block partition) for one posting list.

    One shortest-path DP per candidate format over boundary nodes every
    ``grid`` positions (edge span ≤ ``block_size``). The winner is the
    format with the fewest tight payload bits at its optimal partition;
    formats within ``slack_bits`` of the minimum break the tie by
    modelled decode cost.
    """
    v = venc.validate_u32(docids).ravel()
    n = int(v.size)
    if n == 0:
        return Partition(bounds=np.array([0, 0], np.int64),
                         format=formats[0], payload_bits=0.0, cost=0.0)
    enc = venc.delta_encode(v) if differential else v
    pos = _node_positions(n, grid)
    max_k = max(block_size // grid, 1)
    best = None
    for fmt in formats:
        bits = _edge_bits(enc, pos, max_k, fmt)
        # λ·decode ops per edge (linear in span + per-block tile setup)
        decode_ops = np.zeros_like(bits)
        for k in range(1, max_k + 1):
            a = np.arange(max(pos.shape[0] - 1 - k + 1, 0))
            Lk = (pos[a + k] - pos[a]).astype(np.float64)
            decode_ops[a, k - 1] = (CODEC_INT_OPS[fmt] * Lk
                                    + CODEC_BLOCK_OPS[fmt])
        weights = bits + BLOCK_OVERHEAD_BITS + lam * decode_ops
        cost, bounds = _shortest_path(pos, weights, max_k)
        counts = np.diff(bounds)
        pay = _partition_payload_bits(enc, bounds, fmt)
        ops = codec_decode_cost(float(n), format=fmt,
                                n_blocks=float(counts.size)).flops
        cand = Partition(bounds=bounds, format=fmt,
                         payload_bits=pay, cost=cost)
        if best is None:
            best, best_ops = cand, ops
        elif pay < best.payload_bits - slack_bits or (
                abs(pay - best.payload_bits) <= slack_bits
                and ops < best_ops):
            best, best_ops = cand, ops
    return best


def _partition_payload_bits(enc: np.ndarray, bounds: np.ndarray,
                            format: str) -> float:
    """Tight encoded bits of ``enc`` under ``bounds`` — matches the
    encodings' ``payload_bytes`` accounting exactly."""
    counts = np.diff(bounds).astype(np.int64)
    if format == "vbyte":
        return 8.0 * float(venc.vbyte_lengths(enc).sum())
    if format == "streamvbyte":
        return 8.0 * (float(svb.svb_lengths(enc).sum())
                      + float((-(-counts // 4)).sum()))
    w = bpk.bit_widths(enc).astype(np.int64)
    total = 0.0
    for i, j in zip(bounds[:-1], bounds[1:]):
        wm = int(w[i:j].max(initial=0))
        total += 8.0 * (-(-(wm * (j - i)) // 8)) + 8.0
    return total


# ---------------------------------------------------------------------------
# partitioned emission
# ---------------------------------------------------------------------------
def encode_partitioned(
    values: np.ndarray,
    bounds: np.ndarray,
    *,
    format: str,
    block_size: int = 128,
    differential: bool = True,
    stride_multiple: int = 128,
    checksum: bool = False,
    device=None,
) -> CompressedIntArray:
    """Encode ``values`` with the given variable-count block partition.

    Emits an ordinary uniform-``block_size`` :class:`CompressedIntArray`
    (placed on ``device``, default the card) whose block ``b`` holds
    ``values[bounds[b]:bounds[b+1]]`` — the same device shapes as the
    uniform encoders. With ``differential=True`` a chunk's first gap is the
    global gap and ``bases[b]`` carries the preceding absolute value.
    """
    v = venc.validate_u32(values).ravel()
    n = int(v.size)
    bounds = np.asarray(bounds, dtype=np.int64).ravel()
    counts = np.diff(bounds).astype(np.int32)
    if counts.size == 0:
        counts = np.zeros(1, np.int32)
        bounds = np.array([0, 0], np.int64)
    if int(counts.max(initial=0)) > block_size:
        raise ValueError(f"partition chunk exceeds block_size={block_size}")
    if int(counts.sum()) != n:
        raise ValueError("partition bounds do not cover the value range")
    nb = counts.shape[0]
    enc_values = venc.delta_encode(v) if differential else v
    bases = np.zeros(nb, np.uint32)
    if differential and n:
        starts = bounds[:-1]
        live = starts > 0
        bases[live] = v[starts[live] - 1].astype(np.uint32)

    if format == "binpack":
        grid = np.zeros((nb, block_size), np.uint64)
        mask = np.arange(block_size)[None, :] < counts[:, None]
        grid[mask] = enc_values
        widths = bpk.block_widths(grid, counts)
        data = bpk.pack_blocked_data(grid, widths,
                                     stride_multiple=stride_multiple,
                                     min_stride=None)
        enc = bpk.BinpackEncoding(
            widths=widths[:, None], data=data, counts=counts, bases=bases,
            n=n, block_size=block_size, differential=differential)
    elif format == "streamvbyte":
        if block_size % 4:
            raise ValueError(f"block_size={block_size} must be a multiple of 4")
        ctrl_stride = block_size // 4
        rows_c, rows_d = [], []
        for i, j in zip(bounds[:-1], bounds[1:]):
            c, d = svb.encode_stream(enc_values[i:j])
            rows_c.append(c)
            rows_d.append(d)
        stride = max((r.size for r in rows_d), default=1)
        stride = max(-(-max(stride, 1) // stride_multiple) * stride_multiple, 1)
        stride = min(stride, block_size * svb.MAX_BYTES_PER_INT)
        control = np.zeros((nb, ctrl_stride), np.uint8)
        data = np.zeros((nb, stride), np.uint8)
        for b, (rc, rd) in enumerate(zip(rows_c, rows_d)):
            control[b, : rc.size] = rc
            data[b, : rd.size] = rd
        enc = svb.StreamVByteEncoding(
            control=control, data=data, counts=counts, bases=bases, n=n,
            block_size=block_size, differential=differential)
    elif format == "vbyte":
        rows = [venc.encode_stream(enc_values[i:j])
                for i, j in zip(bounds[:-1], bounds[1:])]
        stride = max((r.size for r in rows), default=1)
        stride = max(-(-max(stride, 1) // stride_multiple) * stride_multiple, 1)
        stride = min(stride, block_size * venc.MAX_BYTES_PER_INT)
        payload = np.zeros((nb, stride), np.uint8)
        for b, r in enumerate(rows):
            payload[b, : r.size] = r
        enc = venc.BlockedEncoding(
            payload=payload, counts=counts, bases=bases, n=n,
            block_size=block_size, differential=differential,
            payload_bytes=sum(r.size for r in rows))
    else:
        raise ValueError(f"unknown format {format!r}; expected one of "
                         f"{PARTITION_FORMATS}")

    cs = None
    if checksum:
        vgrid = np.zeros((nb, block_size), np.uint64)
        vgrid[np.arange(block_size)[None, :] < counts[:, None]] = v
        cs = block_checksums(vgrid, counts)
    return CompressedIntArray.from_encoding(enc, format, checksums=cs,
                                            device=device)
