"""Host-side binary-packing (binpack) encoding (numpy, vectorized).

The port's copy of ``repro/core/vbyte/binpack.py`` (numpy only, so copied
rather than rewritten). Each block's integers are packed at the block's
**max bit width** ``w ∈ {0..32}``, LSB-first — value ``j`` occupies bits
``[j·w, (j+1)·w)`` of the block's byte row — with the width in a one-byte
per-block **width column**. Decode needs no boundary recovery and no
length prefix sum: every value's bit position is the affine ``j·w``
(``binpack_masked.py``, ``kernels/vbyte_decode/binpack_kernel.py``).

Blocked layout: ``widths uint8 [n_blocks, 1]`` + ``data uint8 [n_blocks,
stride]`` + per-block ``counts``/``bases``. One outlier gap forces the
whole block to its width, which the index builder's block partition
(``repro_torch.index.partition``) exploits by cutting blocks at outliers.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_BYTES_PER_INT = 4  # a 32-bit value packs into at most 32 bits
MAX_WIDTH = 32
_POW2 = (np.uint64(1) << np.arange(1, MAX_WIDTH, dtype=np.uint64)).astype(
    np.uint64)  # thresholds 2^1..2^31 for bit_length via searchsorted


def bit_widths(values: np.ndarray) -> np.ndarray:
    """Bit length of each value (0 for 0, 32 for values ≥ 2^31)."""
    v = np.asarray(values, dtype=np.uint64)
    # bit_length(v) = #{k ≥ 0 : 2^k ≤ v}; searchsorted over 2^1..2^31 gives
    # bit_length - 1 for v ≥ 1 (exact integer compares, no float log2)
    w = np.searchsorted(_POW2, v, side="right").astype(np.int64) + 1
    return np.where(v == 0, 0, w)


def block_widths(enc_values: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Per-block max bit width over the valid prefix: uint8 [n_blocks]."""
    nb, B = enc_values.shape
    valid = np.arange(B)[None, :] < np.asarray(counts).reshape(-1, 1)
    wv = bit_widths(enc_values) * valid
    return wv.max(axis=1, initial=0).astype(np.uint8)


def pack_rows(vals: np.ndarray, w: int) -> np.ndarray:
    """Pack ``uint64 [g, B]`` rows at width ``w``: ``uint8 [g, ceil(B·w/8)]``.

    LSB-first within each value and across the row bit stream, so the final
    partial byte's high bits are zero.
    """
    g, B = vals.shape
    if w == 0:
        return np.zeros((g, 0), np.uint8)
    bits = ((vals[:, :, None] >> np.arange(w, dtype=np.uint64)) & np.uint64(1))
    bits = bits.astype(np.uint8).reshape(g, B * w)
    pad = (-bits.shape[1]) % 8
    if pad:
        bits = np.pad(bits, ((0, 0), (0, pad)))
    return np.packbits(bits, axis=1, bitorder="little")


def pack_blocked_data(
    enc_values: np.ndarray,  # uint64 [n_blocks, block_size], zero-padded
    widths: np.ndarray,  # uint8 [n_blocks]
    *,
    stride_multiple: int,
    min_stride: int | None,
) -> np.ndarray:
    """Pack every block at its own width into a dense ``[n_blocks, stride]``.

    Blocks are grouped by width so each group packs in one vectorized pass.
    Padded value slots are zero, so bits past ``counts·w`` are zero too.
    """
    nb, B = enc_values.shape
    row_bytes = -(-(widths.astype(np.int64) * B) // 8)
    stride = int(row_bytes.max(initial=1))
    stride = max(stride, min_stride or 0, 1)
    stride = -(-stride // stride_multiple) * stride_multiple
    if stride > B * MAX_BYTES_PER_INT:
        stride = B * MAX_BYTES_PER_INT
    data = np.zeros((nb, stride), np.uint8)
    for w in np.unique(widths):
        rows = np.flatnonzero(widths == w)
        packed = pack_rows(enc_values[rows], int(w))
        data[rows, : packed.shape[1]] = packed
    return data


@dataclass(frozen=True)
class BinpackEncoding:
    """Fixed-shape blocked binpack encoding (see module docstring)."""

    widths: np.ndarray  # uint8 [n_blocks, 1] — per-block bit width
    data: np.ndarray  # uint8 [n_blocks, stride]
    counts: np.ndarray  # int32 [n_blocks] — valid integers per block
    bases: np.ndarray  # uint32 [n_blocks] — differential carry-in
    n: int  # total integers
    block_size: int
    differential: bool
    ragged: bool = False  # one independent list (bag) per block

    @property
    def n_blocks(self) -> int:
        return self.data.shape[0]

    @property
    def stride(self) -> int:
        return self.data.shape[1]

    @property
    def payload_bytes(self) -> int:
        """Tight compressed size: packed bits (rounded up per block) plus
        the one-byte-per-block width column."""
        if self.n == 0:
            return 0
        w = self.widths.reshape(-1).astype(np.int64)
        c = self.counts.astype(np.int64)
        return int((-(-(w * c) // 8)).sum()) + self.n_blocks

    @property
    def device_bytes(self) -> int:
        """Bytes actually shipped to device (incl. padding + metadata)."""
        return (self.widths.nbytes + self.data.nbytes
                + self.counts.nbytes + self.bases.nbytes)

    @property
    def bits_per_int(self) -> float:
        return 8.0 * self.payload_bytes / max(self.n, 1)


def encode_blocked(
    values: np.ndarray | None = None,
    *,
    block_size: int = 128,
    differential: bool = False,
    stride_multiple: int = 128,
    min_stride: int | None = None,
    wrap: bool = False,
    meta=None,
) -> BinpackEncoding:
    """Encode ``values`` into the blocked binpack layout.

    Same block semantics as ``encode.encode_blocked``: with
    ``differential=True`` the gaps are packed and ``bases[b]`` holds the
    absolute value preceding block ``b``. ``meta`` accepts a pre-computed
    :class:`~repro_torch.core.vbyte.encode.BlockedMeta`.
    """
    from .encode import prepare_blocked

    if meta is None:
        meta = prepare_blocked(values, block_size=block_size,
                               differential=differential, wrap=wrap)
    block_size, differential = meta.block_size, meta.differential
    grid = np.zeros((meta.n_blocks * block_size,), np.uint64)
    grid[: meta.n] = meta.enc_values
    grid = grid.reshape(meta.n_blocks, block_size)
    widths = block_widths(grid, meta.counts)
    data = pack_blocked_data(grid, widths, stride_multiple=stride_multiple,
                             min_stride=min_stride)
    return BinpackEncoding(
        widths=widths[:, None],
        data=data,
        counts=meta.counts,
        bases=meta.bases,
        n=meta.n,
        block_size=block_size,
        differential=differential,
    )


def encode_ragged_blocked(
    lists,
    *,
    block_size: int = 128,
    differential: bool = False,
    stride_multiple: int = 128,
    min_stride: int | None = None,
    wrap: bool = False,
) -> BinpackEncoding:
    """Encode ragged id bags: block b holds list b (≤ block_size ids), each
    bag packed at its own max width."""
    from .encode import ragged_block_values

    vpad, counts = ragged_block_values(
        lists, block_size=block_size, differential=differential, wrap=wrap)
    # zero the padded slots so they cannot inflate the block width
    vpad = vpad * (np.arange(block_size)[None, :] < counts[:, None])
    widths = block_widths(vpad, counts)
    data = pack_blocked_data(vpad, widths, stride_multiple=stride_multiple,
                             min_stride=min_stride)
    return BinpackEncoding(
        widths=widths[:, None],
        data=data,
        counts=counts,
        bases=np.zeros(vpad.shape[0], np.uint32),
        n=int(counts.sum()),
        block_size=block_size,
        differential=differential,
        ragged=True,
    )


def decode_block_scalar(data_row: np.ndarray, width: int, count: int, *,
                        differential: bool = False, base: int = 0
                        ) -> np.ndarray:
    """Scalar oracle for one block: bit-at-a-time unpack of ``count`` values."""
    out = np.zeros(count, np.uint64)
    prev = np.uint64(base)
    for j in range(count):
        x = np.uint64(0)
        for k in range(width):
            bitpos = j * width + k
            bit = (int(data_row[bitpos >> 3]) >> (bitpos & 7)) & 1
            x |= np.uint64(bit) << np.uint64(k)
        if differential:
            prev = np.uint64((prev + x) & np.uint64(0xFFFFFFFF))
            out[j] = prev
        else:
            out[j] = x
    return out


def decode_blocked_scalar(widths: np.ndarray, data: np.ndarray,
                          counts: np.ndarray, bases: np.ndarray,
                          block_size: int, *, differential: bool
                          ) -> np.ndarray:
    """Oracle for the blocked layout: [n_blocks, block_size] uint64."""
    nb = data.shape[0]
    w = np.asarray(widths).reshape(-1)
    out = np.zeros((nb, block_size), np.uint64)
    for b in range(nb):
        c = int(counts[b])
        out[b, :c] = decode_block_scalar(
            data[b], int(w[b]), c, differential=differential,
            base=int(bases[b]))
    return out
