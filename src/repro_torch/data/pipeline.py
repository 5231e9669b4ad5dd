"""Compressed input pipeline: VByte token shards decoded on the device.

The port of ``repro/data/pipeline.py``. The LM data path stores token
streams VByte-compressed: one training step consumes one shard of
``B × (S+1)`` tokens, encoded on the host
(``CompressedIntArray.encode(block_size=128, differential=False)``),
shipped to the pipeline's device compressed, and decoded there into the
``[B, S+1]`` token batch. With ``plan="auto"`` on the card that decode is
kernel 1 (``csrc/vbyte_decode.cu``), one launch a step; the batch never
passes through the host decoded. The reference's deprecated
``use_kernel`` boolean is not carried over (the port's
``CompressedIntArray`` has none either): pass ``plan``.
"""
from __future__ import annotations

import numpy as np

from repro_torch._device import resolve_device
from repro_torch.core.compressed_array import CompressedIntArray


class CompressedTokenPipeline:
    def __init__(self, tokens: np.ndarray, batch: int, seq_len: int,
                 *, plan="auto", block_size: int = 128, device=None):
        self.tokens = np.asarray(tokens, dtype=np.uint64)
        self.batch = batch
        self.seq_len = seq_len
        self.step_tokens = batch * (seq_len + 1)
        self.n_steps = len(self.tokens) // self.step_tokens
        self.plan = plan  # repro_torch.kernels.vbyte_decode.dispatch
        self.block_size = block_size
        self.device = resolve_device(device)
        if self.n_steps == 0:
            raise ValueError("token stream shorter than one step")

    def shard(self, step: int) -> CompressedIntArray:
        """Shard ``step`` (mod ``n_steps``), encoded on the host and placed
        on the pipeline's device."""
        lo = (step % self.n_steps) * self.step_tokens
        return CompressedIntArray.encode(
            self.tokens[lo : lo + self.step_tokens],
            block_size=self.block_size, differential=False,
            device=self.device)

    def get_batch(self, step: int) -> dict:
        """Decode shard ``step`` on the device -> ``{"tokens": int32
        [B, S+1]}``. The shard's blocks are full but the last, so the
        decoded grid's first ``B·(S+1)`` slots are the stream's values in
        order (what the reference's host-side ``decode()[:n]`` gives)."""
        grid = self.shard(step).decode_blocked(plan=self.plan)
        flat = grid.reshape(-1)[: self.step_tokens]
        return {"tokens": flat.reshape(self.batch, self.seq_len + 1)}

    def compression_ratio(self) -> float:
        return self.shard(0).compression_ratio

    def __iter__(self):
        for s in range(self.n_steps):
            yield self.get_batch(s)
