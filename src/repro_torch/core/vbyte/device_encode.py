"""Device-side vectorized VByte *encoder* (torch ops on the values' device).

The port of ``repro/core/vbyte/device_encode.py``: the inverse of the
masked decoder, with the same branch-free structure — per-value byte
lengths from threshold compares, destination offsets from a prefix sum,
and one scatter of payload bytes into an ``[n_blocks, stride + 1]``
buffer whose last column catches the unused slots. The host path
(``encode.py``, numpy) remains the bulk-ingest tool.

Emits the blocked layout directly: ``payload`` uint8 ``[n_blocks,
stride]``, ``counts`` int32 and ``bases`` int32 holding the uint32 bits
(the port's convention). uint32 arithmetic runs in int64 masked to 32
bits, so gaps wrap mod 2^32 exactly like the reference's, across blocks
too (``bases = prev_last``).
"""
from __future__ import annotations

import numpy as np
import torch

from .masked import U32_MASK, to_i32_bits, to_u32

_THRESH = (1 << 7, 1 << 14, 1 << 21, 1 << 28)


def _u32_values(values) -> torch.Tensor:
    """``values`` as int64 uint32 values: an int32 tensor holds uint32
    bits, any other integer tensor is taken mod 2^32."""
    if values.dtype == torch.int32:
        return to_u32(values)
    return values.to(torch.int64) & U32_MASK


def vbyte_lengths_device(values: torch.Tensor) -> torch.Tensor:
    """Encoded byte count per value (1..5), int32, vectorized."""
    v = _u32_values(values)
    n = torch.ones(v.shape, dtype=torch.int32, device=v.device)
    for t in _THRESH:
        n += (v >= t).to(torch.int32)
    return n


def encode_blocked_device(
    values: torch.Tensor,  # uint32 values [n], n % block_size == 0
    *,
    block_size: int = 128,
    stride: int = 640,  # must fit the worst block: block_size * 5
    differential: bool = False,
) -> dict:
    """Encode to the blocked layout on ``values``' device.

    ``values`` is a 1-D integer tensor (int32 holding uint32 bits, or
    int64 / uint8 / ... values mod 2^32) whose length is a multiple of
    ``block_size`` (pad with zeros). Returns ``{"payload": uint8 [nb,
    stride], "counts": int32 [nb], "bases": int32 [nb]}`` — bit-compatible
    with the host encoder given the same stride, and round-trippable
    through every vbyte decoder of the package.
    """
    if isinstance(values, np.ndarray):
        raise TypeError("encode_blocked_device takes a tensor on the device "
                        "to encode on; use torch.as_tensor(values, "
                        "device=...)")
    n = values.shape[0]
    if n % block_size:
        raise ValueError(f"{n} values are not a multiple of block_size="
                         f"{block_size}; pad with zeros")
    nb = n // block_size
    dev = values.device
    v = _u32_values(values).reshape(nb, block_size)

    if differential:
        prev_last = torch.cat([v.new_zeros(1), v[:-1, -1]])
        gaps = torch.cat([v[:, :1] - prev_last[:, None],
                          v[:, 1:] - v[:, :-1]], dim=1)
        enc = gaps & U32_MASK  # wraps mod 2^32, the cross-block gap too
        bases = prev_last
    else:
        enc = v
        bases = torch.zeros(nb, dtype=torch.int64, device=dev)

    lengths = vbyte_lengths_device(enc).to(torch.int64)  # [nb, B]
    offs = torch.cumsum(lengths, dim=1) - lengths  # byte offset per value

    # payload byte k of value j: (enc >> 7k) & 0x7F, continuation bit if
    # k < len - 1
    k = torch.arange(5, dtype=torch.int64, device=dev)
    chunks = (enc[..., None] >> (7 * k)) & 0x7F  # [nb, B, 5]
    cont = (k < lengths[..., None] - 1).to(torch.int64) << 7
    data = (chunks | cont).to(torch.uint8)
    used = k < lengths[..., None]

    dst = torch.where(used, offs[..., None] + k, stride)  # unused: last col
    row = torch.arange(nb, dtype=torch.int64, device=dev)[:, None, None]
    flat = (row * (stride + 1) + dst.clamp(max=stride)).reshape(-1)
    payload = torch.zeros(nb * (stride + 1), dtype=torch.uint8, device=dev)
    payload[flat] = data.reshape(-1)
    payload = payload.reshape(nb, stride + 1)[:, :stride].contiguous()

    counts = torch.full((nb,), block_size, dtype=torch.int32, device=dev)
    return {"payload": payload, "counts": counts,
            "bases": to_i32_bits(bases)}
