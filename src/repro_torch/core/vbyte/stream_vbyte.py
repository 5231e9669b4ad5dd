"""Host-side Stream VByte encoding (numpy, vectorized).

The port's copy of ``repro/core/vbyte/stream_vbyte.py`` (numpy only, so
copied rather than rewritten). Stream VByte (Lemire, Kurz & Rupp) moves
integer lengths out of the data into a separate **control stream** of
2-bit codes (``code = encoded_bytes - 1``, four codes per control byte,
packed LSB-first); the **data stream** holds each integer's 1–4
little-endian bytes back to back, all 8 bits of every byte carrying
payload.

Two layouts, mirroring ``encode.py``:

* **stream**: ``(control uint8[ceil(n/4)], data uint8[sum(lengths)])``.
* **blocked**: ``block_size`` integers per block (``block_size % 4 == 0``
  so control bytes never straddle blocks), control
  ``[n_blocks, block_size // 4]``, data padded to a common stride, plus
  per-block ``counts``/``bases`` exactly like ``BlockedEncoding``.

Padding control codes are 0, which means length 1: the ``count`` mask is
what makes a padded block decode right.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_BYTES_PER_INT = 4  # 32-bit integers need at most 4 whole bytes
_LEN_THRESHOLDS = np.array([1 << 8, 1 << 16, 1 << 24], dtype=np.uint64)


def svb_lengths(values: np.ndarray) -> np.ndarray:
    """Number of encoded data bytes for each value (1..4)."""
    v = np.asarray(values, dtype=np.uint64)
    return (np.searchsorted(_LEN_THRESHOLDS, v, side="right") + 1).astype(np.int64)


def _byte_matrix(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return ([n, 4] uint8 little-endian byte matrix, [n] lengths)."""
    v = np.asarray(values, dtype=np.uint64)
    if v.ndim != 1:
        raise ValueError(f"expected 1-D values, got shape {v.shape}")
    if v.size and int(v.max()) > 0xFFFFFFFF:
        raise ValueError("Stream VByte encoder supports 32-bit unsigned integers")
    lengths = svb_lengths(v)
    shifts = np.arange(MAX_BYTES_PER_INT, dtype=np.uint64) * np.uint64(8)
    data = ((v[:, None] >> shifts[None, :]) & np.uint64(0xFF)).astype(np.uint8)
    return data, lengths


def pack_control(codes: np.ndarray) -> np.ndarray:
    """Pack 2-bit codes (0..3) into control bytes, 4 per byte, LSB-first.

    ``len(codes)`` must be a multiple of 4 (pad with zeros first).
    """
    c = np.asarray(codes, dtype=np.uint8)
    if c.size % 4:
        raise ValueError("pad codes to a multiple of 4 before packing")
    q = c.reshape(-1, 4)
    return (q[:, 0] | (q[:, 1] << 2) | (q[:, 2] << 4) | (q[:, 3] << 6)).astype(np.uint8)


def unpack_control(control: np.ndarray, n: int) -> np.ndarray:
    """Inverse of :func:`pack_control`: first ``n`` 2-bit codes."""
    c = np.asarray(control, dtype=np.uint8)
    shifts = np.arange(4, dtype=np.uint8) * np.uint8(2)
    codes = ((c[:, None] >> shifts[None, :]) & np.uint8(3)).reshape(-1)
    return codes[:n].astype(np.int64)


def encode_stream(values: np.ndarray, *, wrap: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """Encode to the two tight streams: ``(control, data)``."""
    from .encode import validate_u32

    data, lengths = _byte_matrix(validate_u32(values, wrap=wrap))
    n = data.shape[0]
    codes = np.zeros(-(-max(n, 1) // 4) * 4, dtype=np.uint8)
    codes[:n] = (lengths - 1).astype(np.uint8)
    control = pack_control(codes)[: -(-n // 4)] if n else np.zeros(0, np.uint8)
    keep = np.arange(MAX_BYTES_PER_INT)[None, :] < lengths[:, None]
    return control, data[keep]


def decode_stream_scalar(control: np.ndarray, data: np.ndarray, n: int, *,
                         differential: bool = False, base: int = 0) -> np.ndarray:
    """Scalar oracle: decode ``n`` integers from (control, data) streams."""
    control = np.asarray(control, dtype=np.uint8)
    data = np.asarray(data, dtype=np.uint8)
    out = np.zeros(n, dtype=np.uint64)
    off = 0
    prev = np.uint64(base)
    for j in range(n):
        code = (int(control[j // 4]) >> (2 * (j % 4))) & 3
        length = code + 1
        x = np.uint64(0)
        for k in range(length):
            x |= np.uint64(data[off + k]) << np.uint64(8 * k)
        off += length
        if differential:
            prev = np.uint64((prev + x) & np.uint64(0xFFFFFFFF))
            out[j] = prev
        else:
            out[j] = x
    return out


@dataclass(frozen=True)
class StreamVByteEncoding:
    """Fixed-shape blocked Stream-VByte encoding (see module docstring)."""

    control: np.ndarray  # uint8 [n_blocks, block_size // 4]
    data: np.ndarray  # uint8 [n_blocks, data_stride]
    counts: np.ndarray  # int32 [n_blocks] — valid integers per block
    bases: np.ndarray  # uint32 [n_blocks] — differential carry-in (0 if not differential)
    n: int  # total integers
    block_size: int
    differential: bool
    ragged: bool = False  # one independent list (bag) per block

    @property
    def n_blocks(self) -> int:
        return self.control.shape[0]

    @property
    def stride(self) -> int:
        return self.data.shape[1]

    @property
    def payload_bytes(self) -> int:
        """Tight compressed size: data bytes + control bytes (no padding)."""
        if self.n == 0:
            return 0
        shifts = np.arange(4, dtype=np.uint8) * np.uint8(2)
        codes = (self.control[:, :, None] >> shifts) & np.uint8(3)
        codes = codes.reshape(self.n_blocks, self.block_size).astype(np.int64)
        valid = np.arange(self.block_size)[None, :] < self.counts[:, None]
        data_bytes = int(((codes + 1) * valid).sum())
        control_bytes = int((-(-self.counts.astype(np.int64) // 4)).sum())
        return data_bytes + control_bytes

    @property
    def device_bytes(self) -> int:
        """Bytes actually shipped to device (incl. padding + metadata)."""
        return (self.control.nbytes + self.data.nbytes
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
) -> StreamVByteEncoding:
    """Encode ``values`` into the blocked Stream-VByte layout.

    Same block semantics as ``encode.encode_blocked``: with
    ``differential=True`` the gaps are encoded and ``bases[b]`` holds the
    absolute value preceding block ``b``. ``meta`` accepts a pre-computed
    :class:`~repro_torch.core.vbyte.encode.BlockedMeta`.
    """
    from .encode import prepare_blocked, scatter_blocked_payload

    if meta is None:
        meta = prepare_blocked(values, block_size=block_size,
                               differential=differential, wrap=wrap)
    block_size, differential = meta.block_size, meta.differential
    if block_size % 4:
        raise ValueError(f"block_size={block_size} must be a multiple of 4")
    n, n_blocks = meta.n, meta.n_blocks
    data_mat, lengths = _byte_matrix(meta.enc_values)

    # control stream: codes padded with 0 for tail slots, 4 codes per byte
    codes = np.zeros(n_blocks * block_size, dtype=np.uint8)
    codes[:n] = (lengths - 1).astype(np.uint8)
    control = pack_control(codes).reshape(n_blocks, block_size // 4)

    # data stream: dense bytes per block, padded to a common stride
    data = scatter_blocked_payload(
        data_mat,
        lengths,
        n_blocks=n_blocks,
        block_size=block_size,
        max_bytes=MAX_BYTES_PER_INT,
        stride_multiple=stride_multiple,
        min_stride=min_stride,
    )

    return StreamVByteEncoding(
        control=control,
        data=data,
        counts=meta.counts,
        bases=meta.bases,
        n=n,
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
) -> StreamVByteEncoding:
    """Encode ragged id bags: block b holds list b (≤ block_size ids).

    Pad slots get code 0; masking by ``counts`` is load-bearing.
    """
    if block_size % 4:
        raise ValueError(f"block_size={block_size} must be a multiple of 4")
    from .encode import ragged_block_values, scatter_blocked_payload

    vpad, counts = ragged_block_values(
        lists, block_size=block_size, differential=differential, wrap=wrap)
    n_lists = vpad.shape[0]
    data_mat, lengths = _byte_matrix(vpad.reshape(-1))
    lengths = lengths.reshape(n_lists, block_size)
    pad_slot = np.arange(block_size)[None, :] >= counts[:, None]
    lengths[pad_slot] = 0

    codes = (np.maximum(lengths, 1) - 1).astype(np.uint8)  # pad slots: code 0
    control = pack_control(codes.reshape(-1)).reshape(n_lists, block_size // 4)
    data = scatter_blocked_payload(
        data_mat,
        lengths.reshape(-1),
        n_blocks=n_lists,
        block_size=block_size,
        max_bytes=MAX_BYTES_PER_INT,
        stride_multiple=stride_multiple,
        min_stride=min_stride,
    )
    return StreamVByteEncoding(
        control=control,
        data=data,
        counts=counts,
        bases=np.zeros(n_lists, dtype=np.uint32),
        n=int(counts.sum()),
        block_size=block_size,
        differential=differential,
        ragged=True,
    )


def decode_blocked_scalar(control: np.ndarray, data: np.ndarray, counts: np.ndarray,
                          bases: np.ndarray, block_size: int, *,
                          differential: bool) -> np.ndarray:
    """Oracle for the blocked layout: [n_blocks, block_size] uint64, zero-padded."""
    n_blocks = control.shape[0]
    out = np.zeros((n_blocks, block_size), dtype=np.uint64)
    for b in range(n_blocks):
        c = int(counts[b])
        out[b, :c] = decode_stream_scalar(
            control[b], data[b], c, differential=differential, base=int(bases[b])
        )
    return out
