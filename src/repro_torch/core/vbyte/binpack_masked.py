"""Binpack decode as vectorized torch ops — the plain version of kernel 4.

Value ``j`` of a width-``w`` block starts at bit ``j·w``, so the decode is
a static shift and mask per slot, with no scan:

  bitpos_j = j · w
  byte0_j  = min(bitpos_j >> 3, S-1),  shift_j = bitpos_j & 7
  lo24_j   = data[byte0 .. byte0+2],  hi16_j = data[byte0+3 .. byte0+4]
  out_j    = ((lo24 >> shift) | (hi16 << (24 - shift))) & mask(w)
  differential: out = base + inclusive_cumsum(out)   (mod 2^32)

This is the function of the reference's Pallas kernel
(``binpack_kernel.py::binpack_decode_tile``) down to its garbage-input
cases, which the CUDA kernel (``kernels/vbyte_decode/binpack_kernel.py``)
repeats: ``w = 0`` decodes zeros; ``w ≥ 32`` (32, or a corrupt width)
masks with all ones; ``byte0`` is clamped to ``S-1`` and bytes of the
5-byte window at or past ``S`` read as 0; ``hi16 << (24 - shift)`` wraps
in 32 bits. The reference's jnp decoder clamps each window byte to
``S-1`` instead; the two agree on every row an encoder writes (valid
values end inside ``ceil(count·w/8)`` bytes) and differ only on corrupt
ones. Counts are clamped to ``[0, B]``. Values travel as int32 holding the
uint32 bits; the arithmetic runs in int64 masked to 32 bits.
"""
from __future__ import annotations

import torch

from .masked import U32_MASK, to_i32_bits, to_u32

GATHER_BYTES = 5  # shift ≤ 7 bits + width ≤ 32 bits spans at most 5 bytes


def block_bit_positions(widths: torch.Tensor, block_size: int) -> torch.Tensor:
    """bitpos[b, j] = j · w_b, int64 [n_blocks, block_size]."""
    w = widths.reshape(-1).to(torch.int64)
    j = torch.arange(block_size, device=widths.device)
    return j[None, :] * w[:, None]


def gather_words(data: torch.Tensor, byte0: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The 40-bit window at each byte offset as ``(lo24, hi16)`` int64;
    window bytes at or past the row end read as 0."""
    S = data.shape[-1]
    k = torch.arange(GATHER_BYTES, device=data.device)
    pos = byte0[..., None] + k
    b = torch.gather(data.to(torch.int64), -1,
                     pos.clamp(max=S - 1).reshape(*data.shape[:-1], -1)
                     ).reshape(*byte0.shape, GATHER_BYTES)
    b = torch.where(pos < S, b, 0)
    lo24 = b[..., 0] | (b[..., 1] << 8) | (b[..., 2] << 16)
    hi16 = b[..., 3] | (b[..., 4] << 8)
    return lo24, hi16


def extract_values(lo24: torch.Tensor, hi16: torch.Tensor,
                   shift: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """``(word40 >> shift) & mask(w)`` as the uint32 value (int64)."""
    w = widths.reshape(-1).to(torch.int64)[:, None]
    val = ((lo24 >> shift) | (hi16 << (24 - shift))) & U32_MASK
    mask = torch.where(w >= 32, U32_MASK, (1 << w.clamp(max=31)) - 1)
    return val & mask


def decode_blocked(
    widths: torch.Tensor,
    data: torch.Tensor,
    counts: torch.Tensor,
    bases: torch.Tensor,
    *,
    block_size: int,
    differential: bool,
) -> torch.Tensor:
    """Decode the blocked binpack layout to int32 ``[n_blocks, block_size]``
    (uint32 bits), zero-padded: slot j is valid iff j < counts[b].

    ``widths`` uint8 ``[n_blocks, 1]`` (or ``[n_blocks]``), ``data`` uint8
    ``[n_blocks, S]``, ``counts``/``bases`` 1-D ``[n_blocks]``.
    """
    B = block_size
    S = data.shape[-1]
    bitpos = block_bit_positions(widths, B)
    lo24, hi16 = gather_words(data, (bitpos >> 3).clamp(max=S - 1))
    out = extract_values(lo24, hi16, bitpos & 7, widths)

    cnt = counts.to(torch.int64).clamp(0, B)
    valid = torch.arange(B, device=data.device)[None, :] < cnt[:, None]
    out = torch.where(valid, out, 0)
    if differential:
        out = to_u32(bases).reshape(-1, 1) + torch.cumsum(out, dim=1)
        out = torch.where(valid, out & U32_MASK, 0)
    return to_i32_bits(out)


def decode_stream(widths, data: torch.Tensor, n_max: int, *,
                  n: int | None = None, differential: bool = False,
                  base: int = 0) -> torch.Tensor:
    """Decode one packed stream of width ``widths[0]`` to int32 ``[n_max]``
    (uint32 bits) through :func:`decode_blocked` as a single block of
    ``n_max`` slots: ``n`` valid integers (default ``n_max``), slots past
    ``n`` zero."""
    n = n_max if n is None else n
    dev = data.device
    w = torch.as_tensor(widths, device=dev).reshape(1, 1)
    out = decode_blocked(
        w, data[None, :], torch.tensor([n], dtype=torch.int32, device=dev),
        to_i32_bits(torch.tensor([base], dtype=torch.int64, device=dev)),
        block_size=n_max, differential=differential)
    return out[0, :n_max]
