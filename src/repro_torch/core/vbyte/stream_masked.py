"""Stream-VByte decode as vectorized torch ops — the plain version of kernel 3.

The control stream hands the decoder the integer boundaries, so the whole
decode is

  code_j    = (control[j//4] >> 2*(j%4)) & 3          (unpack)
  len_j     = (code_j + 1) · [j < count]              (tail masking)
  start_j   = Σ_{k<j} len_k                           (exclusive prefix sum)
  out_j     = Σ_{k<len_j, start_j+k<S} data[start_j+k] << 8k
  differential: out = base + inclusive_cumsum(out)    (mod 2^32)

Padding control codes are 0 (length 1), so the ``count`` mask is
load-bearing. A data byte at or past the row's end ``S`` adds nothing:
that is what the reference's Pallas kernel computes (its dense routing,
``stream_kernel.py::_dense_stream_routing``, only routes bytes that exist)
and what the CUDA kernel (``kernels/vbyte_decode/stream_kernel.py``)
computes. The reference's jnp decoder instead clamps such reads to byte
``S-1``; the two agree on every row whose lengths fit in ``S`` (all rows
an encoder writes) and differ only on corrupt ones. Counts are clamped to
``[0, B]`` as in kernel 1. Values travel as int32 holding the uint32 bits.
"""
from __future__ import annotations

import torch

from .masked import U32_MASK, to_i32_bits, to_u32

MAX_BYTES_PER_INT = 4


def control_codes(control: torch.Tensor, block_size: int) -> torch.Tensor:
    """Unpack 2-bit codes: uint8 [..., B/4] -> int64 [..., B] (LSB-first)."""
    j = torch.arange(block_size, device=control.device)
    packed = control.to(torch.int64)[..., j // 4]
    return (packed >> (2 * (j % 4))) & 3


def integer_lengths(codes: torch.Tensor,
                    counts: torch.Tensor | None = None) -> torch.Tensor:
    """Data-byte lengths per integer (1..4), zeroed past ``counts``."""
    lens = codes + 1
    if counts is None:
        return lens
    j = torch.arange(codes.shape[-1], device=codes.device)
    return torch.where(j < counts.to(torch.int64)[..., None], lens, 0)


def start_offsets(lengths: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix sum of lengths: each integer's first data byte."""
    return torch.cumsum(lengths, dim=-1) - lengths


def gather_values(data: torch.Tensor, starts: torch.Tensor,
                  lengths: torch.Tensor) -> torch.Tensor:
    """``out_j = Σ_{k<len_j} data[start_j+k] << 8k`` (int64), where a byte
    index at or past the row end reads as nothing."""
    S = data.shape[-1]
    k = torch.arange(MAX_BYTES_PER_INT, device=data.device)
    pos = starts[..., None] + k
    src = pos.clamp(max=S - 1)
    flat = torch.gather(data.to(torch.int64), -1,
                        src.reshape(*data.shape[:-1], -1)
                        ).reshape(*starts.shape, MAX_BYTES_PER_INT)
    used = (k < lengths[..., None]) & (pos < S)
    contrib = torch.where(used, flat << (8 * k), 0)
    return contrib.sum(dim=-1)


def decode_blocked(
    control: torch.Tensor,
    data: torch.Tensor,
    counts: torch.Tensor,
    bases: torch.Tensor,
    *,
    block_size: int,
    differential: bool,
) -> torch.Tensor:
    """Decode the blocked Stream-VByte layout to int32 ``[n_blocks,
    block_size]`` (uint32 bits), zero-padded: slot j is valid iff
    j < counts[b].

    ``control`` uint8 ``[n_blocks, B/4]``, ``data`` uint8 ``[n_blocks, S]``,
    ``counts``/``bases`` 1-D ``[n_blocks]`` (``bases`` int32 holding the
    uint32 carry-in bits).
    """
    B = block_size
    cnt = counts.to(torch.int64).clamp(0, B)
    lens = integer_lengths(control_codes(control, B), cnt)
    out = gather_values(data, start_offsets(lens), lens)

    valid = torch.arange(B, device=data.device)[None, :] < cnt[:, None]
    out = torch.where(valid, out, 0)
    if differential:
        out = to_u32(bases).reshape(-1, 1) + torch.cumsum(out, dim=1)
        out = torch.where(valid, out & U32_MASK, 0)
    return to_i32_bits(out)


def decode_stream(control: torch.Tensor, data: torch.Tensor, n_max: int, *,
                  n: int | None = None, differential: bool = False,
                  base: int = 0) -> torch.Tensor:
    """Decode one (control, data) stream pair to int32 ``[n_max]`` (uint32
    bits) through :func:`decode_blocked` as a single block of
    ``ceil(n_max / 4) · 4`` slots: ``control`` holds at least
    ``ceil(n_max / 4)`` bytes (zero past the valid region), ``n`` valid
    integers (default ``n_max``), slots past ``n`` zero."""
    n = n_max if n is None else n
    dev = data.device
    out = decode_blocked(
        control[None, : -(-n_max // 4)], data[None, :],
        torch.tensor([n], dtype=torch.int32, device=dev),
        to_i32_bits(torch.tensor([base], dtype=torch.int64, device=dev)),
        block_size=-(-n_max // 4) * 4, differential=differential)
    return out[0, :n_max]
