"""Kernel 4: blocked binpack decode (CUDA, ``csrc/binpack_decode.cu``).

The port of ``repro/kernels/vbyte_decode/binpack_kernel.py::
binpack_decode_blocked_pallas``. :func:`binpack_decode_blocked_cuda`
launches the hand-written Hopper kernel for tensors on the card; for
tensors on the CPU it computes the same function with
``core.vbyte.binpack_masked.decode_blocked``, the vectorized torch-op
decoder. It never falls back from the card to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.core.vbyte.binpack_masked import decode_blocked as decode_plain

from ._build import LaunchCounter, library
from .kernel import MAX_BLOCK_SIZE, check_meta

launches = LaunchCounter()


def check_operands(widths, data, counts, bases, *, block_size: int) -> None:
    """Raise on anything the kernel does not take."""
    if block_size < 1 or block_size > MAX_BLOCK_SIZE:
        raise ValueError(f"block_size must be in [1, {MAX_BLOCK_SIZE}], "
                         f"got {block_size}")
    if data.dtype != torch.uint8 or data.dim() != 2 or data.shape[1] < 1:
        raise ValueError(f"data must be uint8 [n_blocks, stride ≥ 1], got "
                         f"{data.dtype} {tuple(data.shape)}")
    nb = data.shape[0]
    if widths.dtype != torch.uint8 or tuple(widths.shape) != (nb, 1):
        raise ValueError(f"widths must be uint8 [{nb}, 1], got "
                         f"{widths.dtype} {tuple(widths.shape)}")
    check_meta((widths, data), counts, bases)


def binpack_decode_blocked_cuda(widths: torch.Tensor, data: torch.Tensor,
                                counts: torch.Tensor, bases: torch.Tensor, *,
                                block_size: int,
                                differential: bool) -> torch.Tensor:
    """Decode int32 ``[n_blocks, block_size]`` (uint32 bits), zero-padded.

    ``widths`` uint8 ``[n_blocks, 1]``, ``data`` uint8 ``[n_blocks, S]``,
    ``counts``/``bases`` int32 ``[n_blocks]``. On a CUDA tensor: one launch
    on the current stream, no synchronisation.
    """
    check_operands(widths, data, counts, bases, block_size=block_size)
    if not data.is_cuda:
        return decode_plain(widths, data, counts, bases,
                            block_size=block_size, differential=differential)
    nb, S = data.shape
    out = torch.empty((nb, block_size), dtype=torch.int32, device=data.device)
    if nb == 0:
        return out
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        library("binpack_decode").call(
            "binpack_decode_blocked_launch", widths.data_ptr(),
            data.data_ptr(), counts.data_ptr(), bases.data_ptr(),
            out.data_ptr(), nb, S, block_size, int(differential), stream)
    launches.bump()
    return out
