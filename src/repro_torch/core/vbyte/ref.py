"""Scalar reference decoder — the paper's Algorithm 1 (conventional VByte).

``decode_stream_scalar`` is the pure-python/numpy oracle the tests hold
every vectorized decoder and both CUDA kernels against.
"""
from __future__ import annotations

import numpy as np


def decode_stream_scalar(data: np.ndarray, n: int, *, differential: bool = False,
                         base: int = 0) -> np.ndarray:
    """Decode ``n`` integers from a VByte byte stream (Algorithm 1)."""
    data = np.asarray(data, dtype=np.uint8)
    out = np.zeros(n, dtype=np.uint64)
    i = 0
    prev = np.uint64(base)
    for j in range(n):
        x = np.uint64(0)
        shift = np.uint64(0)
        while True:
            b = np.uint64(data[i])
            i += 1
            x |= (b & np.uint64(0x7F)) << shift
            if b < 128:
                break
            shift += np.uint64(7)
        if differential:
            prev = np.uint64((prev + x) & np.uint64(0xFFFFFFFF))
            out[j] = prev
        else:
            # 32-bit lanes like the paper: a 5-byte stream with >32 payload
            # bits wraps mod 2^32, matching every vectorized decoder
            out[j] = x & np.uint64(0xFFFFFFFF)
    return out


def consumed_bytes(data: np.ndarray, n: int) -> int:
    """Bytes consumed decoding the first ``n`` integers of a stream."""
    data = np.asarray(data, dtype=np.uint8)
    seen = 0
    for i, b in enumerate(data):
        if b < 128:
            seen += 1
            if seen == n:
                return i + 1
    if n == 0:
        return 0
    raise ValueError("stream ended before n integers were decoded")


def decode_blocked_scalar(payload: np.ndarray, counts: np.ndarray, bases: np.ndarray,
                          block_size: int, *, differential: bool) -> np.ndarray:
    """Oracle for the blocked layout: [n_blocks, block_size] uint64, zero-padded."""
    n_blocks = payload.shape[0]
    out = np.zeros((n_blocks, block_size), dtype=np.uint64)
    for b in range(n_blocks):
        c = int(counts[b])
        out[b, :c] = decode_stream_scalar(
            payload[b], c, differential=differential, base=int(bases[b])
        )
    return out
