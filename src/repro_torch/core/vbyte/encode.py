"""Host-side VByte encoding (numpy, vectorized).

Implements the format of Plaisance, Kurz & Lemire (2015), §I:

    Starting from the least significant bits, an integer is written seven
    bits per byte; the most significant bit of each byte is 1 in all bytes
    except the last (the terminator), where it is 0.

Two layouts are produced:

* **stream**: the paper's byte stream — ``concat(vbyte(x) for x in values)``.
* **blocked**: the fixed-shape layout the decode kernels take —
  ``block_size`` integers per block, each block padded to a common byte
  ``stride``; per-block ``counts`` (tail masking) and ``bases``
  (differential-coding carry) make every block independently decodable,
  which is what lets one CUDA warp decode one block with no cross-block
  state.

Encoding is vectorized: no python loop over integers. The bytes produced
are identical to the JAX package's encoder (the tests hold them equal).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_BYTES_PER_INT = 5  # 32-bit integers need at most ceil(32/7) = 5 bytes
_LEN_THRESHOLDS = np.array([1 << 7, 1 << 14, 1 << 21, 1 << 28], dtype=np.uint64)
_U32_MAX = 0xFFFFFFFF


def validate_u32(values, *, wrap: bool = False, what: str = "encoder input") -> np.ndarray:
    """Validate encoder input and return it as ``uint64`` in ``[0, 2^32)``.

    Float dtypes, negative values and values ≥ 2^32 raise ``ValueError``
    instead of being silently truncated by a ``uint64`` cast. ``wrap=True``
    is the explicit escape hatch: truncate floats and reduce mod 2^32
    (two's-complement for signed inputs), matching the decoders'
    wraparound semantics.
    """
    a = np.asarray(values)
    if not (np.issubdtype(a.dtype, np.integer) or a.dtype == np.bool_):
        if not wrap:
            raise ValueError(
                f"{what} must be an integer array, got dtype {a.dtype} "
                "(pass wrap=True to truncate explicitly)")
        a = a.astype(np.int64)
    if wrap:
        if np.issubdtype(a.dtype, np.signedinteger):
            a = a.astype(np.int64).astype(np.uint64)
        return a.astype(np.uint64) & np.uint64(_U32_MAX)
    if a.size and np.issubdtype(a.dtype, np.signedinteger) and int(a.min()) < 0:
        raise ValueError(
            f"{what} must be non-negative, got min {int(a.min())} "
            "(pass wrap=True to wrap mod 2^32 explicitly)")
    a = a.astype(np.uint64)
    if a.size and int(a.max()) > _U32_MAX:
        raise ValueError(
            f"{what} must be < 2^32, got max {int(a.max())} "
            "(pass wrap=True to wrap mod 2^32 explicitly)")
    return a


def vbyte_lengths(values: np.ndarray) -> np.ndarray:
    """Number of encoded bytes for each value (1..5)."""
    v = np.asarray(values, dtype=np.uint64)
    return (np.searchsorted(_LEN_THRESHOLDS, v, side="right") + 1).astype(np.int64)


def _byte_matrix(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Return ([n, 5] uint8 byte matrix incl. continuation bits, [n] lengths)."""
    v = np.asarray(values, dtype=np.uint64)
    if v.ndim != 1:
        raise ValueError(f"expected 1-D values, got shape {v.shape}")
    if v.size and int(v.max()) > _U32_MAX:
        raise ValueError("VByte encoder supports 32-bit unsigned integers")
    lengths = vbyte_lengths(v)
    shifts = np.arange(MAX_BYTES_PER_INT, dtype=np.uint64) * np.uint64(7)
    chunks = (v[:, None] >> shifts[None, :]) & np.uint64(0x7F)  # [n, 5]
    k = np.arange(MAX_BYTES_PER_INT, dtype=np.int64)
    cont = k[None, :] < (lengths[:, None] - 1)  # continuation flag per byte
    data = chunks.astype(np.uint8) | (cont.astype(np.uint8) << 7)
    return data, lengths


def encode_stream(values: np.ndarray, *, wrap: bool = False) -> np.ndarray:
    """Encode to the paper's tight byte stream. Returns uint8[total_bytes]."""
    data, lengths = _byte_matrix(validate_u32(values, wrap=wrap))
    keep = np.arange(MAX_BYTES_PER_INT)[None, :] < lengths[:, None]
    return data[keep]  # row-major boolean take preserves byte order


def delta_encode(values: np.ndarray) -> np.ndarray:
    """Successive differences (x1-0, x2-x1, ...) per the paper's convention.

    Requires a non-decreasing sequence (sorted ids, possibly with repeats).
    """
    v = np.asarray(values, dtype=np.uint64)
    if v.size and np.any(np.diff(v.astype(np.int64)) < 0):
        raise ValueError("differential coding requires a non-decreasing sequence")
    return np.diff(v, prepend=np.uint64(0))


def delta_decode(gaps: np.ndarray) -> np.ndarray:
    """The inverse of :func:`delta_encode`: the running sum of the gaps
    (uint64)."""
    return np.cumsum(np.asarray(gaps, dtype=np.uint64)).astype(np.uint64)


@dataclass(frozen=True)
class BlockedEncoding:
    """Fixed-shape blocked VByte encoding (see module docstring).

    ``payload_bytes`` is the tight compressed size (the paper's metric,
    block padding excluded): the sum of the encoded lengths of the values
    actually packed. The JAX package re-derives the same number by
    scalar-decoding every block; here it is recorded when the bytes are
    laid out, which gives the identical integer for every encoding this
    encoder produces without a per-integer python loop.
    """

    payload: np.ndarray  # uint8 [n_blocks, stride]
    counts: np.ndarray  # int32 [n_blocks] — valid integers per block
    bases: np.ndarray  # uint32 [n_blocks] — differential carry-in (0 if not differential)
    n: int  # total integers
    block_size: int
    differential: bool
    payload_bytes: int
    ragged: bool = False  # one independent list (bag) per block

    @property
    def n_blocks(self) -> int:
        return self.payload.shape[0]

    @property
    def stride(self) -> int:
        return self.payload.shape[1]

    @property
    def device_bytes(self) -> int:
        """Bytes shipped to the device (payload incl. padding + metadata)."""
        return self.payload.nbytes + self.counts.nbytes + self.bases.nbytes

    @property
    def bits_per_int(self) -> float:
        return 8.0 * self.payload_bytes / max(self.n, 1)


@dataclass(frozen=True)
class BlockedMeta:
    """Single-pass blocked-layout metadata: validated values, what gets
    packed, ``bases`` and ``counts`` — computed once and shared by the
    payload encode and the skip table (:meth:`skip_table`)."""

    values: np.ndarray  # validated uint64 absolute values
    enc_values: np.ndarray  # what gets packed (gaps when differential)
    bases: np.ndarray  # uint32 [n_blocks]
    counts: np.ndarray  # int32 [n_blocks]
    n: int
    n_blocks: int
    block_size: int
    differential: bool

    def skip_table(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-block (first, last) absolute values — uint32 [n_blocks] each."""
        if self.n == 0:
            z = np.zeros(0, np.uint32)
            return z, z
        idx = np.arange(self.n_blocks)
        first = self.values[idx * self.block_size]
        last = self.values[np.minimum((idx + 1) * self.block_size, self.n) - 1]
        return first.astype(np.uint32), last.astype(np.uint32)


def prepare_blocked(
    values: np.ndarray,
    *,
    block_size: int = 128,
    differential: bool = False,
    wrap: bool = False,
) -> BlockedMeta:
    """Validate + derive blocked metadata once, for reuse across encoders."""
    v = validate_u32(values, wrap=wrap).ravel()
    n = int(v.size)
    n_blocks = max(1, -(-n // block_size))
    enc_values, bases, counts = blocked_metadata(
        v, n_blocks=n_blocks, block_size=block_size, differential=differential)
    return BlockedMeta(
        values=v, enc_values=enc_values, bases=bases, counts=counts, n=n,
        n_blocks=n_blocks, block_size=block_size, differential=differential)


def blocked_metadata(
    v: np.ndarray, *, n_blocks: int, block_size: int, differential: bool
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Shared blocked-layout metadata: ``(encoded_values, bases, counts)``.

    With ``differential=True`` the *gaps* are what get encoded and each
    block's ``bases[b]`` holds the absolute value preceding the block, so
    ``decode(block b) = bases[b] + cumsum(gaps in block b)`` — every block is
    independent (the analogue of inverted-index skip blocks).
    """
    n = int(v.size)
    if differential:
        enc_values = delta_encode(v)
        # carry-in for block b = last absolute value of block b-1
        last_idx = np.minimum(np.arange(1, n_blocks) * block_size, max(n, 1)) - 1
        bases = np.zeros(n_blocks, dtype=np.uint32)
        if n:
            bases[1:] = v[last_idx].astype(np.uint32)
    else:
        enc_values = v
        bases = np.zeros(n_blocks, dtype=np.uint32)

    counts = np.full(n_blocks, block_size, dtype=np.int32)
    if n:
        counts[-1] = n - (n_blocks - 1) * block_size
    else:
        counts[0] = 0
    return enc_values, bases, counts


def scatter_blocked_payload(
    data: np.ndarray,
    lengths: np.ndarray,
    *,
    n_blocks: int,
    block_size: int,
    max_bytes: int,
    stride_multiple: int,
    min_stride: int | None,
) -> np.ndarray:
    """Scatter per-integer byte rows into a dense ``[n_blocks, stride]`` grid.

    ``data`` is ``uint8[n, max_bytes]`` (row i holds integer i's encoded
    bytes, first ``lengths[i]`` valid). The stride is the max block byte
    count rounded up to ``stride_multiple``.
    """
    n = data.shape[0]
    pad_n = n_blocks * block_size
    lengths_p = np.zeros(pad_n, dtype=np.int64)
    lengths_p[:n] = lengths
    block_bytes = lengths_p.reshape(n_blocks, block_size).sum(axis=1)
    stride = int(block_bytes.max(initial=1))
    stride = max(stride, min_stride or 0, 1)
    stride = -(-stride // stride_multiple) * stride_multiple
    if stride > block_size * max_bytes:
        stride = block_size * max_bytes

    payload = np.zeros((n_blocks, stride), dtype=np.uint8)
    if n:
        # destination offset of every encoded byte, all vectorized
        within = np.arange(max_bytes)[None, :]
        keep = within < lengths[:, None]  # [n, max_bytes]
        block_id = np.arange(n) // block_size
        # byte offset of each integer inside its block:
        # exclusive cumsum of lengths, reset at every block boundary
        csum = np.concatenate([[0], np.cumsum(lengths)[:-1]])
        block_start = np.repeat(
            np.concatenate([[0], np.cumsum(block_bytes)[:-1]]), block_size
        )[:n]
        off_in_block = csum - block_start
        dst = block_id[:, None] * stride + off_in_block[:, None] + within
        payload.reshape(-1)[dst[keep]] = data[keep]
    return payload


def encode_blocked(
    values: np.ndarray | None = None,
    *,
    block_size: int = 128,
    differential: bool = False,
    stride_multiple: int = 128,
    min_stride: int | None = None,
    wrap: bool = False,
    meta: BlockedMeta | None = None,
) -> BlockedEncoding:
    """Encode into the blocked layout (see blocked_metadata).

    ``meta`` accepts a pre-computed :class:`BlockedMeta` so the builder's
    encode → skip-table path runs the metadata pass once per list.
    """
    if meta is None:
        meta = prepare_blocked(values, block_size=block_size,
                               differential=differential, wrap=wrap)
    data, lengths = _byte_matrix(meta.enc_values)
    payload = scatter_blocked_payload(
        data,
        lengths,
        n_blocks=meta.n_blocks,
        block_size=meta.block_size,
        max_bytes=MAX_BYTES_PER_INT,
        stride_multiple=stride_multiple,
        min_stride=min_stride,
    )
    return BlockedEncoding(
        payload=payload,
        counts=meta.counts,
        bases=meta.bases,
        n=meta.n,
        block_size=meta.block_size,
        differential=meta.differential,
        payload_bytes=int(lengths.sum()),
    )


def ragged_block_values(
    lists, *, block_size: int, differential: bool, wrap: bool = False
) -> tuple[np.ndarray, np.ndarray]:
    """Shared ragged-bag layout: one independent list per block.

    Returns ``(values [n_lists, block_size] uint64, counts [n_lists] int32)``
    with each row holding list i (delta-encoded per row when
    ``differential`` — first gap is the absolute id, so ``bases`` stay 0 and
    every bag decodes self-contained).
    """
    n_lists = max(1, len(lists))
    counts = np.zeros(n_lists, dtype=np.int32)
    vpad = np.zeros((n_lists, block_size), dtype=np.uint64)
    for i, lst in enumerate(lists):
        if np.asarray(lst).size == 0:
            continue  # empty bag: dtype carries no intent (e.g. [] padding)
        a = validate_u32(lst, wrap=wrap, what=f"list {i}").ravel()
        if a.size > block_size:
            raise ValueError(
                f"list {i} has {a.size} ids > block_size={block_size}")
        counts[i] = a.size
        if differential:
            a = delta_encode(a)
        vpad[i, : a.size] = a
    return vpad, counts


def encode_ragged_blocked(
    lists,
    *,
    block_size: int = 128,
    differential: bool = False,
    stride_multiple: int = 128,
    min_stride: int | None = None,
    wrap: bool = False,
) -> BlockedEncoding:
    """Encode ragged id bags: block b holds list b (≤ block_size ids).

    ``counts`` carry the ragged lengths; ``bases`` are all zero (per-row
    differential is self-based).
    """
    vpad, counts = ragged_block_values(
        lists, block_size=block_size, differential=differential, wrap=wrap)
    n_lists = vpad.shape[0]
    data, lengths = _byte_matrix(vpad.reshape(-1))
    lengths = lengths.reshape(n_lists, block_size)
    lengths[np.arange(block_size)[None, :] >= counts[:, None]] = 0
    payload = scatter_blocked_payload(
        data,
        lengths.reshape(-1),
        n_blocks=n_lists,
        block_size=block_size,
        max_bytes=MAX_BYTES_PER_INT,
        stride_multiple=stride_multiple,
        min_stride=min_stride,
    )
    return BlockedEncoding(
        payload=payload,
        counts=counts,
        bases=np.zeros(n_lists, dtype=np.uint32),
        n=int(counts.sum()),
        block_size=block_size,
        differential=differential,
        payload_bytes=int(lengths.sum()),
        ragged=True,
    )
