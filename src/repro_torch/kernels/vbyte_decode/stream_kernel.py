"""Kernel 3: blocked Stream-VByte decode (CUDA, ``csrc/stream_decode.cu``).

The port of ``repro/kernels/vbyte_decode/stream_kernel.py::
stream_decode_blocked_pallas``. :func:`stream_decode_blocked_cuda`
launches the hand-written Hopper kernel for tensors on the card; for
tensors on the CPU it computes the same function with
``core.vbyte.stream_masked.decode_blocked``, the vectorized torch-op
decoder. It never falls back from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.vbyte.stream_masked import decode_blocked as decode_plain

from ._build import LaunchCounter, library
from .kernel import MAX_BLOCK_SIZE, check_meta

launches = LaunchCounter()


def check_operands(control, data, counts, bases, *, block_size: int) -> None:
    """Raise on anything the kernel does not take."""
    if block_size < 4 or block_size > MAX_BLOCK_SIZE or block_size % 4:
        raise ValueError(f"block_size must be a multiple of 4 in "
                         f"[4, {MAX_BLOCK_SIZE}], got {block_size}")
    for name, t in (("control", control), ("data", data)):
        if t.dtype != torch.uint8 or t.dim() != 2:
            raise ValueError(f"{name} must be uint8 [n_blocks, width], got "
                             f"{t.dtype} {tuple(t.shape)}")
    nb, C = control.shape
    if C * 4 != block_size:
        raise ValueError(f"control width {C} != block_size/4 = "
                         f"{block_size // 4}")
    if data.shape[0] != nb or data.shape[1] < 1:
        raise ValueError(f"data must be uint8 [{nb}, stride ≥ 1], got "
                         f"{tuple(data.shape)}")
    check_meta((control, data), counts, bases)


def stream_decode_blocked_cuda(control: torch.Tensor, data: torch.Tensor,
                               counts: torch.Tensor, bases: torch.Tensor, *,
                               block_size: int,
                               differential: bool) -> torch.Tensor:
    """Decode int32 ``[n_blocks, block_size]`` (uint32 bits), zero-padded.

    ``control`` uint8 ``[n_blocks, block_size/4]``, ``data`` uint8
    ``[n_blocks, S]``, ``counts``/``bases`` int32 ``[n_blocks]``. On a CUDA
    tensor: one launch on the current stream, no synchronisation.
    """
    check_operands(control, data, counts, bases, block_size=block_size)
    if not data.is_cuda:
        return decode_plain(control, data, counts, bases,
                            block_size=block_size, differential=differential)
    nb, S = data.shape
    out = torch.empty((nb, block_size), dtype=torch.int32, device=data.device)
    if nb == 0:
        return out
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        library("stream_decode").call(
            "stream_decode_blocked_launch", control.data_ptr(),
            data.data_ptr(), counts.data_ptr(), bases.data_ptr(),
            out.data_ptr(), nb, S, block_size, int(differential), stream)
    launches.bump()
    return out
