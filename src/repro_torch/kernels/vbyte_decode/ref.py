"""Gather-lowered decoder for the blocked vbyte layout (plan path ``ref``).

Deliberately a *different* strategy from both the CUDA kernel (ballot +
popcount routing into shared memory) and ``core.vbyte.masked`` (scatter-
add): here each output integer *gathers* its ≤ 5 source bytes through
searchsorted offsets. Independent implementations agreeing is the
correctness story.
"""
from __future__ import annotations

import torch

from repro_torch.core.vbyte.masked import U32_MASK, to_i32_bits, to_u32


def vbyte_decode_blocked_ref(payload: torch.Tensor, counts: torch.Tensor,
                             bases: torch.Tensor, *, block_size: int,
                             differential: bool) -> torch.Tensor:
    """int32 ``[n_blocks, block_size]`` (uint32 bits), zero-padded."""
    nb, S = payload.shape
    B = block_size
    dev = payload.device
    p = payload.to(torch.int64)
    end = 1 - (p >> 7)  # terminator flags
    term_count = torch.cumsum(end, dim=1).contiguous()  # inclusive count
    j = torch.arange(B, device=dev, dtype=torch.int64)
    # index of the j-th terminator byte (end of integer j) in each row
    term_idx = torch.searchsorted(
        term_count, (j + 1).expand(nb, B).contiguous(), side="left")
    start = torch.cat([torch.zeros(nb, 1, dtype=torch.int64, device=dev),
                       term_idx[:, :-1] + 1], dim=1)
    length = term_idx - start + 1
    k = torch.arange(5, device=dev, dtype=torch.int64)
    src = torch.clamp(start[:, :, None] + k, 0, S - 1)  # [nb, B, 5]
    bytes_jk = torch.gather(p, 1, src.reshape(nb, B * 5)).reshape(nb, B, 5)
    used = k < length[:, :, None]
    vals = torch.where(used, (bytes_jk & 0x7F) << (7 * k),
                       torch.zeros_like(bytes_jk))
    out = vals.sum(dim=2) & U32_MASK
    valid = j[None, :] < counts.to(torch.int64).reshape(-1, 1)
    zero = torch.zeros_like(out)
    out = torch.where(valid, out, zero)
    if differential:
        out = to_u32(bases).reshape(-1, 1) + torch.cumsum(out, dim=1)
        out = torch.where(valid, out & U32_MASK, zero)
    return to_i32_bits(out)
