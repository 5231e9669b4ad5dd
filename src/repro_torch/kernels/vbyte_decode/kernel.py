"""Kernel 1: blocked Masked-VByte decode (CUDA, ``csrc/vbyte_decode.cu``).

The port of ``repro/kernels/vbyte_decode/kernel.py::decode_blocked_pallas``.
:func:`vbyte_decode_blocked_cuda` launches the hand-written Hopper kernel
for tensors on the card; for tensors on the CPU it computes the same
function with :func:`decode_blocked_plain`, the vectorized torch-op
decoder. It never falls back from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.vbyte.masked import decode_blocked as decode_blocked_plain

from ._build import LaunchCounter, library

MAX_BLOCK_SIZE = 1024  # B slots of uint32 per warp in shared memory

launches = LaunchCounter()


def check_meta(byte_leaves, counts, bases) -> None:
    """The checks every decode kernel shares: ``counts``/``bases`` int32
    ``[n_blocks]``, every operand on one device, contiguous on the card."""
    nb = byte_leaves[0].shape[0]
    for name, t in (("counts", counts), ("bases", bases)):
        if t.dtype != torch.int32 or tuple(t.shape) != (nb,):
            raise ValueError(f"{name} must be int32 [{nb}], got {t.dtype} "
                             f"{tuple(t.shape)}")
    ts = (*byte_leaves, counts, bases)
    if len({t.device for t in ts}) != 1:
        raise ValueError("the format's leaves, counts and bases must be on "
                         "one device")
    if counts.is_cuda and not all(t.is_contiguous() for t in ts):
        raise ValueError("the CUDA kernel takes contiguous tensors")


def check_operands(payload, counts, bases, *, block_size: int) -> None:
    """Raise on anything the kernel does not take."""
    if block_size < 1 or block_size > MAX_BLOCK_SIZE:
        raise ValueError(f"block_size must be in [1, {MAX_BLOCK_SIZE}], "
                         f"got {block_size}")
    if payload.dtype != torch.uint8 or payload.dim() != 2:
        raise ValueError(f"payload must be uint8 [n_blocks, stride], got "
                         f"{payload.dtype} {tuple(payload.shape)}")
    if payload.shape[1] < 1:
        raise ValueError("payload stride must be ≥ 1")
    check_meta((payload,), counts, bases)


def vbyte_decode_blocked_cuda(payload: torch.Tensor, counts: torch.Tensor,
                              bases: torch.Tensor, *, block_size: int,
                              differential: bool) -> torch.Tensor:
    """Decode int32 ``[n_blocks, block_size]`` (uint32 bits), zero-padded.

    ``payload`` uint8 ``[n_blocks, S]``, ``counts``/``bases`` int32
    ``[n_blocks]`` (bases hold uint32 bits). On a CUDA tensor: one launch
    on the current stream, no synchronisation.
    """
    check_operands(payload, counts, bases, block_size=block_size)
    if not payload.is_cuda:
        return decode_blocked_plain(payload, counts, bases,
                                    block_size=block_size,
                                    differential=differential)
    nb, S = payload.shape
    out = torch.empty((nb, block_size), dtype=torch.int32, device=payload.device)
    if nb == 0:
        return out
    with torch.cuda.device(payload.device):
        stream = torch.cuda.current_stream().cuda_stream
        library("vbyte_decode").call(
            "vbyte_decode_blocked_launch", payload.data_ptr(),
            counts.data_ptr(), bases.data_ptr(), out.data_ptr(), nb, S,
            block_size, int(differential), stream)
    launches.bump()
    return out
