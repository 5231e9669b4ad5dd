"""Codec decode-cost model: the prices of the block-partition DP's edges.

The codec part of ``repro/launch/cost_model.py``, at the reference's
values, so that the port's ``index.partition`` picks the same partitions
and codecs. These are modelled relative costs, not measurements of any
device: a per-integer term and a per-block term (the tile's fixed setup,
amortised over the block). vbyte pays the boundary recovery, streamvbyte
routes bytes through the control stream, binpack is a shift and mask.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    wire_bytes: float = 0.0

    def __add__(self, o):
        return Cost(self.flops + o.flops, self.bytes + o.bytes,
                    self.wire_bytes + o.wire_bytes)

    def scale(self, k: float):
        return Cost(self.flops * k, self.bytes * k, self.wire_bytes * k)


# Traffic per decoded int: ~2 B compressed read; an unfused decode also
# writes the uint32 stream and reads it back (8 B) — the round trip the
# fused epilogues remove.
DECODE_INT_OPS = 30
DECODE_READ_B = 2.0
DECODE_RT_B = 8.0  # unfused-only: u32 write + consumer re-read

CODEC_INT_OPS = {"vbyte": float(DECODE_INT_OPS), "streamvbyte": 18.0,
                 "binpack": 8.0}
CODEC_BLOCK_OPS = {"vbyte": 320.0, "streamvbyte": 256.0, "binpack": 96.0}


def codec_decode_cost(n_ints: float, *, format: str = "vbyte",
                      fused: bool = True, n_blocks: float = 0.0) -> Cost:
    """Per-codec decode cost (per-int + per-block tile terms), used by the
    index builder's block-partition DP to trade encoded bits against
    modelled decode work."""
    ops = (CODEC_INT_OPS.get(format, float(DECODE_INT_OPS)) * n_ints
           + CODEC_BLOCK_OPS.get(format, 0.0) * n_blocks)
    b = DECODE_READ_B + (0.0 if fused else DECODE_RT_B)
    return Cost(ops, b * n_ints)
