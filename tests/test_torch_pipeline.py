"""``data/pipeline.py::CompressedTokenPipeline`` and
``data/synthetic.py::token_stream`` in the port against the reference's
on the CPU: the same Zipf stream from one seed, the same shards (bytes,
counts, compression ratio) and every step's ``[B, S+1]`` token batch
bit for bit, the reference decoding as its own tests run it here
(``plan="kernel"``, the Pallas kernel in interpret mode, on the first
step; ``plan="jnp"`` on the rest), the port through ``plan="auto"``
(kernel 1's plain version on a CPU tensor) and ``plan="torch"``."""
import numpy as np
import pytest
import torch

from repro.data.pipeline import CompressedTokenPipeline as RPipe
from repro.data.synthetic import token_stream as r_token_stream
from repro_torch.data.pipeline import CompressedTokenPipeline
from repro_torch.data.synthetic import token_stream

from torch_parity import CPU


@pytest.mark.parametrize("vocab,zipf_a", [(1000, 1.2), (32000, 1.2),
                                          (50304, 1.05)])
def test_token_stream_matches_reference(vocab, zipf_a):
    a = r_token_stream(np.random.default_rng(4), 20000, vocab, zipf_a)
    b = token_stream(np.random.default_rng(4), 20000, vocab, zipf_a)
    assert b.dtype == a.dtype == np.uint64
    np.testing.assert_array_equal(a, b)
    assert b.max() < vocab


@pytest.mark.parametrize("B,S,vocab,n_steps", [(4, 63, 1000, 3),
                                              (3, 100, 32000, 2),
                                              (2, 4096, 32000, 1)])
def test_batches_and_ratio_match_reference(B, S, vocab, n_steps):
    toks = token_stream(np.random.default_rng(0), B * (S + 1) * n_steps + 77,
                        vocab)
    ref = RPipe(toks, B, S, plan="jnp")
    ports = {p: CompressedTokenPipeline(toks, B, S, plan=p, device=CPU)
             for p in ("auto", "torch")}
    assert ports["auto"].n_steps == ref.n_steps == n_steps
    assert ports["auto"].compression_ratio() == ref.compression_ratio()
    for step in range(n_steps + 1):  # the last wraps to shard 0
        rs, ts = ref.shard(step), ports["auto"].shard(step)
        np.testing.assert_array_equal(np.asarray(rs.payload),
                                      ts.payload.numpy())
        np.testing.assert_array_equal(np.asarray(rs.counts),
                                      ts.counts.numpy())
        ref.plan = "kernel" if step == 0 and S < 4096 else "jnp"
        want = np.asarray(ref.get_batch(step)["tokens"])
        lo = (step % n_steps) * B * (S + 1)
        raw = toks[lo:lo + B * (S + 1)].astype(np.int32).reshape(B, S + 1)
        np.testing.assert_array_equal(want, raw)
        for plan, pipe in ports.items():
            got = pipe.get_batch(step)["tokens"]
            assert got.dtype == torch.int32 and got.device == CPU, plan
            np.testing.assert_array_equal(got.numpy(), want, err_msg=plan)
    assert [b["tokens"].shape for b in ports["torch"]] == [(B, S + 1)] * n_steps


def test_short_stream_raises():
    with pytest.raises(ValueError, match="shorter than one step"):
        CompressedTokenPipeline(np.arange(10, dtype=np.uint64), 2, 8,
                                device=CPU)
