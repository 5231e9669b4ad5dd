"""Fixed-rate int8 gradient compression with error feedback.

The port of ``repro/train/grad_compress.py``: gradients quantized to int8
with a per-leaf scale, the residual carried into the next step. The
reference applies it inside the train step to model the wire format of
its data-parallel reduction; so does the port, on one card and over a
mesh (a leaf split over the data axes takes the scale of the whole
leaf: the max of its shards' maxima, exact), so a run with compression
computes what the reference's does. Gradients and states are dicts
keyed by path of tensors or of placed leaves
(``repro_torch.distributed.sharding``). :func:`compressed_psum` is the
reference's ``shard_map`` collective over one mesh axis: an int8 sum
with a shared scale.
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


def _quantize_at(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.to(torch.float32) / scale), -127,
                       127).to(torch.int8)


def compress_grads_with_ef(grads: dict, ef_state: dict):
    """Quantize the gradients plus error feedback: ``(dequantized grads,
    new error-feedback state)``."""
    from repro_torch.distributed.sharding import map_pieces, pieces

    out, new_ef = {}, {}
    for k, g in grads.items():
        gf = map_pieces(lambda a, e: a.to(torch.float32) + e, g, ef_state[k])
        if isinstance(gf, torch.Tensor):
            deq = dequantize(*quantize(gf))
        else:  # the scale of the whole leaf: the max of its pieces' maxima
            ps = pieces(gf)
            peak = torch.max(torch.stack([torch.max(torch.abs(p)).to(
                ps[0].device) for p in ps]))
            scale = torch.clamp(peak, min=1e-12) / 127.0

            def deq_piece(p):
                s = scale.to(p.device)
                return dequantize(_quantize_at(p, s), s)

            deq = map_pieces(deq_piece, gf)
        out[k] = deq
        new_ef[k] = map_pieces(lambda a, b: a - b, gf, deq)
    return out, new_ef


def init_ef_state(params: dict) -> dict:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()}


def compressed_psum(x, axis_name: str):
    """int8-on-the-wire sum over the mesh axis ``axis_name``: ``x`` holds
    one tensor a position of that axis (a ``BlockSharded`` split on
    dimension 0 over ``(axis_name,)``, as the reference's ``shard_map``
    hands each shard its block); every position gets the same result, in
    the same layout. The shared scale is the max of the shards' scales
    (the reference's ``pmax``); the int8 values add as int32 (exact, in
    any order) and are dequantized with it."""
    from repro_torch.distributed.sharding import BlockSharded

    if not isinstance(x, BlockSharded) or x.axes != (axis_name,) or x.dim:
        raise ValueError("compressed_psum takes a BlockSharded split on "
                         f"dimension 0 over ({axis_name!r},)")
    home = x.shards[0].device
    scale = torch.max(torch.stack([quantize(s)[1].to(home)
                                   for s in x.shards]))
    acc = None
    for s in x.shards:
        q = _quantize_at(s, scale.to(s.device)).to(torch.int32).to(home)
        acc = q if acc is None else acc + q
    total = acc.to(torch.float32) * scale
    return x.map(lambda s: total.to(s.device, copy=True))
