"""Fixed-rate int8 gradient compression with error feedback.

The port of ``repro/train/grad_compress.py``: gradients quantized to int8
with a per-leaf scale, the residual carried into the next step. The
reference applies it inside the train step to model the wire format of
its data-parallel reduction; the port does the same on one card, so a
run with compression computes what the reference's does. Its
``compressed_psum`` (a ``shard_map`` collective) waits for the sharded
stack (ROADMAP queue 1 item 13). Gradients and states are dicts of
tensors keyed by path.
"""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: ``(q int8, scale float32)``; rounds half
    to even, as the reference."""
    xf = x.to(torch.float32)
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_grads_with_ef(grads: dict, ef_state: dict):
    """Quantize the gradients plus error feedback: ``(dequantized grads,
    new error-feedback state)``."""
    out, new_ef = {}, {}
    for k, g in grads.items():
        gf = g.to(torch.float32) + ef_state[k]
        deq = dequantize(*quantize(gf))
        out[k], new_ef[k] = deq, gf - deq
    return out, new_ef


def init_ef_state(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}
