"""Public decode wrappers and the shape contract of the decode kernels.

``vbyte_decode_blocked`` (kernel 1), ``stream_vbyte_decode_blocked``
(kernel 3) and ``binpack_decode_blocked`` (kernel 4) take the reference's
operand shapes (``counts``/``bases`` as ``[n_blocks]`` or ``[n_blocks,
1]``, binpack ``widths`` likewise), normalise them and run the kernel on a
CUDA tensor, its plain torch version on a CPU tensor. There is no
``block_tile`` padding: the CUDA kernels mask the ragged edge of their
grid themselves, so output shapes are exactly ``[n_blocks, …]``.
"""
from __future__ import annotations

import numpy as np
import torch

from .binpack_kernel import binpack_decode_blocked_cuda
from .kernel import vbyte_decode_blocked_cuda
from .stream_kernel import stream_decode_blocked_cuda


def normalize_block_meta(name: str, x: torch.Tensor, n_blocks: int) -> torch.Tensor:
    """Validate per-block metadata (``counts``/``bases``) shape; return 1-D.

    The public contract accepts ``[n_blocks]`` or ``[n_blocks, 1]``.
    Anything else — wrong length, transposed, extra dims — raises a clear
    ValueError instead of a silent reshape.
    """
    shape = tuple(x.shape)
    if shape == (n_blocks,):
        return x
    if shape == (n_blocks, 1):
        return x[:, 0]
    raise ValueError(
        f"{name} must have shape [n_blocks] or [n_blocks, 1] with "
        f"n_blocks={n_blocks}; got {shape}")


def normalize_probe(probe, width: int) -> np.ndarray:
    """Validate + pad a sorted probe set for the membership/bm25 epilogues.

    ``probe`` is a 1-D sorted array of docids (< 2^31 — the in-kernel
    comparison runs in int32). Returns ``int32 [1, width]`` padded with -1
    (the never-matches sentinel the epilogue masks out). Raises on unsorted,
    too-long, or out-of-range inputs instead of silently mis-matching.
    """
    p = np.asarray(probe).reshape(-1)
    if p.size > width:
        raise ValueError(f"probe has {p.size} ids > width={width}")
    if p.size:
        if p.min() < 0 or int(p.max()) >= 1 << 31:
            raise ValueError("probe docids must be in [0, 2^31) — the "
                             "membership epilogue compares in int32")
        if np.any(np.diff(p.astype(np.int64)) < 0):
            raise ValueError("probe must be sorted (non-decreasing)")
    out = np.full((1, width), -1, np.int32)
    out[0, : p.size] = p.astype(np.int32)
    return out


def as_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """Per-block metadata as int32 (uint32 values keep their bits)."""
    if x.dtype == torch.int32:
        return x
    if x.dtype == torch.uint32:
        return x.view(torch.int32)
    v = x.to(torch.int64) & 0xFFFFFFFF
    return torch.where(v >= 1 << 31, v - (1 << 32), v).to(torch.int32)


def normalize_counts_bases(counts, bases, nb: int):
    """``counts``/``bases`` as the kernels take them: contiguous int32
    ``[n_blocks]`` (bases keep their uint32 bits)."""
    counts = as_i32_bits(normalize_block_meta("counts", counts, nb))
    bases = as_i32_bits(normalize_block_meta("bases", bases, nb))
    return counts.contiguous(), bases.contiguous()


def vbyte_decode_blocked(
    payload: torch.Tensor,  # uint8 [n_blocks, stride]
    counts: torch.Tensor,  # int   [n_blocks] or [n_blocks, 1]
    bases: torch.Tensor,  # int32 (uint32 bits) [n_blocks] or [n_blocks, 1]
    *,
    block_size: int,
    differential: bool,
) -> torch.Tensor:
    """Decode a blocked VByte payload to int32 (uint32 bits) [n_blocks, block_size]."""
    counts, bases = normalize_counts_bases(counts, bases, payload.shape[0])
    return vbyte_decode_blocked_cuda(payload.contiguous(), counts, bases,
                                     block_size=block_size,
                                     differential=differential)


def stream_vbyte_decode_blocked(
    control: torch.Tensor,  # uint8 [n_blocks, block_size // 4]
    data: torch.Tensor,  # uint8 [n_blocks, data_stride]
    counts: torch.Tensor,  # int   [n_blocks] or [n_blocks, 1]
    bases: torch.Tensor,  # int32 (uint32 bits) [n_blocks] or [n_blocks, 1]
    *,
    block_size: int,
    differential: bool,
) -> torch.Tensor:
    """Decode a blocked Stream-VByte payload to int32 (uint32 bits)
    ``[n_blocks, block_size]``."""
    counts, bases = normalize_counts_bases(counts, bases, control.shape[0])
    return stream_decode_blocked_cuda(
        control.contiguous(), data.contiguous(), counts, bases,
        block_size=block_size, differential=differential)


def binpack_decode_blocked(
    widths: torch.Tensor,  # uint8 [n_blocks, 1] or [n_blocks]
    data: torch.Tensor,  # uint8 [n_blocks, stride]
    counts: torch.Tensor,  # int   [n_blocks] or [n_blocks, 1]
    bases: torch.Tensor,  # int32 (uint32 bits) [n_blocks] or [n_blocks, 1]
    *,
    block_size: int,
    differential: bool,
) -> torch.Tensor:
    """Decode a blocked binpack payload to int32 (uint32 bits)
    ``[n_blocks, block_size]``."""
    nb = data.shape[0]
    widths = normalize_block_meta("widths", widths, nb)[:, None]
    counts, bases = normalize_counts_bases(counts, bases, nb)
    return binpack_decode_blocked_cuda(
        widths.to(torch.uint8).contiguous(), data.contiguous(), counts, bases,
        block_size=block_size, differential=differential)
