"""MASKED VBYTE as vectorized torch ops — the plain version of kernel 1.

The x86 algorithm (paper §IV) extracts continuation bits with pmovmskb,
looks the mask up in a table of shuffles, routes payload bytes to lanes
with pshufb and fuses the differential prefix sum. Written as whole-tensor
arithmetic over a ``[n_blocks, S]`` byte grid, every step is an identity:

  continuation mask   c_i   = byte_i >> 7
  terminator flag     end_i = 1 - c_i
  output index        out_idx_i = Σ_{k<i} end_k           (exclusive prefix sum)
  in-integer position pos_i = c_{i-1}(1 + c_{i-2}(1 + c_{i-3}(1 + c_{i-4})))
  contribution        contrib_i = (byte_i & 0x7F) << 7·pos_i   (mod 2^32)
  reassembly          out_j = Σ_{i: out_idx_i = j} contrib_i   (scatter-add)
  differential        out = base + inclusive_cumsum(out)  (mod 2^32)

Values travel as int32 tensors holding the uint32 bits (torch has no
usable uint32 arithmetic); the wrapping arithmetic runs in int64 masked
with ``& 0xFFFFFFFF``. Bytes at or past ``count`` are dropped (zero
padding bytes look like terminators of 0, so the mask is load-bearing),
and slots ``>= count`` are zero. Contributions are *added*, not OR-ed, so
overlong runs (more than 5 continuation bytes) decode exactly as the
reference's scatter-sum does. The CUDA kernel
(``repro_torch.kernels.vbyte_decode.kernel``) computes the same function.
"""
from __future__ import annotations

import torch

U32_MASK = 0xFFFFFFFF


def to_u32(x: torch.Tensor) -> torch.Tensor:
    """int32 tensor holding uint32 bits → int64 tensor of the uint32 values."""
    return x.to(torch.int64) & U32_MASK


def to_i32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 tensor (any value) → int32 tensor holding its low 32 bits."""
    x = x & U32_MASK
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def _shift_right(x: torch.Tensor, k: int) -> torch.Tensor:
    """x[..., i-k] along the last axis, zero filled at the row start."""
    out = torch.zeros_like(x)
    out[..., k:] = x[..., : x.shape[-1] - k]
    return out


def in_integer_positions(cont: torch.Tensor) -> torch.Tensor:
    """pos_i = number of consecutive continuation bytes just before i, capped
    at 4 by the closed form (VByte-32 spans ≤ 5 bytes)."""
    c1, c2, c3, c4 = (_shift_right(cont, k) for k in (1, 2, 3, 4))
    return c1 * (1 + c2 * (1 + c3 * (1 + c4)))


def decode_stream(data: torch.Tensor, n_max: int, *, nbytes: int | None = None,
                  differential: bool = False, base: int = 0
                  ) -> tuple[torch.Tensor, int]:
    """Decode one tight VByte stream (the port of ``repro/core/vbyte/
    masked.py::decode_stream``): ``data`` uint8 ``[S]``, zero-padded past
    ``nbytes`` (default: all of it); at most ``n_max`` integers. Returns
    ``(out, n_decoded)``: ``out`` int32 ``[n_max]`` holding the uint32
    bits, zero past ``n_decoded``; with ``differential`` the inclusive
    prefix sum from ``base``, mod 2^32. The checkpoint manager's host
    decoder for integer leaves."""
    S = data.shape[-1]
    dev = data.device
    b = data.reshape(-1).to(torch.int64)
    idx = torch.arange(S, device=dev)
    valid = (idx < (S if nbytes is None else int(nbytes))).to(torch.int64)
    cont = (b >> 7) * valid
    end = (1 - cont) * valid
    out_idx = torch.cumsum(end, dim=0) - end  # exclusive prefix sum
    pos = in_integer_positions(cont)
    contrib = ((b & 0x7F) << (7 * pos)) & U32_MASK
    n_decoded = min(int(end.sum()), n_max)
    if n_max == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev), 0
    keep = (valid > 0) & (out_idx < n_max)
    contrib = torch.where(keep, contrib, torch.zeros_like(contrib))
    ids = torch.where(keep, out_idx, torch.full_like(out_idx, n_max - 1))
    out = torch.zeros(n_max, dtype=torch.int64, device=dev)
    out.index_add_(0, ids, contrib)
    out = out & U32_MASK
    live = torch.arange(n_max, device=dev) < n_decoded
    zero = torch.zeros_like(out)
    out = torch.where(live, out, zero)
    if differential:
        out = torch.where(live, (base + torch.cumsum(out, dim=0)) & U32_MASK,
                          zero)
    return to_i32_bits(out), n_decoded


def decode_blocked(
    payload: torch.Tensor,
    counts: torch.Tensor,
    bases: torch.Tensor,
    *,
    block_size: int,
    differential: bool,
) -> torch.Tensor:
    """Decode the blocked layout to int32 ``[n_blocks, block_size]`` (uint32
    bits), zero-padded: block b slot j is valid iff j < counts[b].

    ``payload`` uint8 ``[n_blocks, S]``; ``counts`` and ``bases`` 1-D
    ``[n_blocks]`` (``bases`` int32 holding the uint32 carry-in bits).
    """
    nb, S = payload.shape
    B = block_size
    dev = payload.device
    b = payload.to(torch.int64)
    cont = b >> 7
    end = 1 - cont
    out_idx = torch.cumsum(end, dim=1) - end  # exclusive prefix sum
    pos = in_integer_positions(cont)
    contrib = ((b & 0x7F) << (7 * pos)) & U32_MASK

    # counts outside [0, B] are out of contract; clamping them drops every
    # byte routed past slot B-1, as the reference's Pallas kernel does
    cnt = counts.to(torch.int64).clamp(0, B).reshape(-1, 1)
    keep = out_idx < cnt
    contrib = torch.where(keep, contrib, torch.zeros_like(contrib))
    ids = torch.clamp(out_idx, max=B - 1)
    flat = (torch.arange(nb, device=dev, dtype=torch.int64)[:, None] * B + ids)
    out = torch.zeros(nb * B, dtype=torch.int64, device=dev)
    out.index_add_(0, flat.reshape(-1), contrib.reshape(-1))
    out = out.reshape(nb, B) & U32_MASK

    j = torch.arange(B, device=dev, dtype=torch.int64)[None, :]
    valid = j < cnt
    zero = torch.zeros_like(out)
    out = torch.where(valid, out, zero)
    if differential:
        out = to_u32(bases).reshape(-1, 1) + torch.cumsum(out, dim=1)
        out = torch.where(valid, out & U32_MASK, zero)
    return to_i32_bits(out)


def count_integers(data: torch.Tensor, nbytes: int | None = None
                   ) -> torch.Tensor:
    """The complete integers in a VByte stream: its terminator bytes
    (those below 0x80) among the first ``nbytes`` (default: all). An int32
    scalar on the stream's device."""
    S = data.shape[-1]
    valid = torch.arange(S, device=data.device) < (
        S if nbytes is None else int(nbytes))
    return ((data < 0x80) & valid).sum(dtype=torch.int32)
