"""The port's attention stack and layer norms against the reference on the
CPU, on the same numpy inputs: every case of ``tests/test_attention.py``
(window, banded, chunk sizes, GQA, RoPE, partial rotary, decode against
full, the cache slot), bidirectional attention, chunked-prefill offsets
and ``kv_valid``; ``layernorm``, ``rmsnorm`` and ``swiglu_ffn``; and the
card's route (``scaled_dot_product_attention`` on the pre-scaled ``q``)
against the plain version for each recsys model's head layout.

Tolerances. Float32 compute: ``ATOL_F32 = 1e-5`` (the same operations in
the same order; what is left is the summation order of XLA's and torch's
CPU products, measured at most 1e-6). bf16 compute: ``BF16_ATOL = 2^-5``
absolute on outputs below 4 in magnitude (two bf16 ulps there): the
reference on the CPU rounds its scores and ``p·v`` sums to bf16
(``accum_dtype()`` is ``None`` off the TPU), the port keeps them float32
as the TPU does (measured at most 2^-6). Layer norms round a float32
result once in both packages: within one bf16 ulp. The SDPA route
against the plain version at bf16: within ``SDPA_ULPS = 2`` bf16 ulps of
the output's largest magnitude (both sum in float32 in other orders and
round once; measured 1), as ``swiglu_ffn`` at bf16 against the reference
(silu and the products round to bf16 at other places). Ulps are counted
at the largest magnitude because a small output, the sum of terms that
cancel, moves by many of its own ulps when a term moves by one of its.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.nn import attention as RA
from repro.nn import layers as RL
from repro_torch.nn import attention as TA
from repro_torch.nn import layers as TL

from torch_parity import bf16_ulps

ATOL_F32 = 1e-5
BF16_ATOL = 2.0**-5
SDPA_ULPS = 2
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _qkv(seed, B=2, S=128, H=4, Hk=2, D=16, Skv=None):
    rng = np.random.default_rng(seed)
    Skv = S if Skv is None else Skv
    return (rng.standard_normal((B, S, H, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hk, D)).astype(np.float32),
            rng.standard_normal((B, Skv, Hk, D)).astype(np.float32))


def _close(ref, port, dt, what=""):
    r = np.asarray(jnp.asarray(ref, jnp.float32))
    p = port.float().numpy()
    assert r.shape == p.shape, what
    tol = ATOL_F32 if dt == "f32" else BF16_ATOL
    err = float(np.abs(r - p).max())
    assert err <= tol, f"{what}: {err} > {tol}"


def _ulps_at_scale(ref: torch.Tensor, got: torch.Tensor) -> float:
    """``max |ref - got|`` in bf16 ulps of ``max |ref|``."""
    ulp = 2.0 ** (int(np.floor(np.log2(float(ref.abs().max())))) - 7)
    return float((ref.float() - got.float()).abs().max()) / ulp


def _both(fn_r, fn_t, arrays, dt, **kw):
    rdt, tdt = DTYPES[dt]
    ref = fn_r(*map(jnp.asarray, arrays), dtype=rdt, **kw)
    port = fn_t(*map(torch.tensor, arrays), dtype=tdt, **kw)
    return ref, port


def naive_attention(q, k, v, causal=True, window=None):
    """The reference test's oracle, in float64 numpy."""
    B, S, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    qf = q.astype(np.float64).reshape(B, S, Hk, G, D)
    s = np.einsum("bqhgd,bkhd->bhgqk", qf, k.astype(np.float64)) * D ** -0.5
    i, j = np.arange(S)[:, None], np.arange(S)[None, :]
    m = np.ones((S, S), bool)
    if causal:
        m &= i >= j
    if window is not None:
        m &= (i - j) < window
    s = np.where(m[None, None, None], s, -1e30)
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    o = np.einsum("bhgqk,bkhd->bqhgd", p, v.astype(np.float64))
    return o.reshape(B, S, H, D)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("window,banded", [(None, False), (32, False),
                                           (32, True), (128, True)])
@pytest.mark.parametrize("qc,kc", [(32, 32), (64, 16), (128, 128)])
def test_flash_matches_reference(window, banded, qc, kc, dt):
    qkv = _qkv(0)
    kw = dict(causal=True, window=window, q_chunk=qc, kv_chunk=kc,
              banded=banded)
    ref, port = _both(RA.flash_attention, TA.flash_attention, qkv, dt, **kw)
    _close(ref, port, dt)
    if dt == "f32":  # and the reference test's oracle
        np.testing.assert_allclose(port.numpy(),
                                   naive_attention(*qkv, window=window),
                                   atol=2e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal,H,Hk", [(True, 4, 4), (False, 4, 4),
                                         (False, 4, 2), (False, 4, 1)])
def test_flash_mha_gqa_and_bidirectional(causal, H, Hk, dt):
    qkv = _qkv(1, H=H, Hk=Hk)
    ref, port = _both(RA.flash_attention, TA.flash_attention, qkv, dt,
                      causal=causal, q_chunk=32, kv_chunk=32)
    _close(ref, port, dt)
    if dt == "f32":
        np.testing.assert_allclose(port.numpy(),
                                   naive_attention(*qkv, causal=causal),
                                   atol=2e-5)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("q_offset,kv_offset,window,banded,valid", [
    (32, 0, None, False, False),   # a chunked-prefill tail over the cache
    (64, 32, 48, False, False),    # a window over a KV slice
    (64, 32, 48, True, False),
    (0, 0, None, False, True),     # missing cache slots
    (96, 0, 40, True, True),
])
def test_flash_offsets_and_kv_valid(q_offset, kv_offset, window, banded,
                                    valid, dt):
    qkv = _qkv(2, S=32, Skv=128)
    kv_valid = np.random.default_rng(3).random(128) < 0.8 if valid else None
    kw = dict(causal=True, window=window, q_chunk=16, kv_chunk=32,
              banded=banded, q_offset=q_offset, kv_offset=kv_offset)
    rdt, tdt = DTYPES[dt]
    ref = RA.flash_attention(
        *map(jnp.asarray, qkv), dtype=rdt,
        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid), **kw)
    port = TA.flash_attention(
        *map(torch.tensor, qkv), dtype=tdt,
        kv_valid=None if kv_valid is None else torch.tensor(kv_valid), **kw)
    _close(ref, port, dt)


def test_rope_matches_reference_and_keeps_norms():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 8, 2, 16)).astype(np.float32)
    pos = np.arange(8)[None]
    np.testing.assert_allclose(
        TA.rope_frequencies(16, 10000.0).numpy(),
        np.asarray(RA.rope_frequencies(16, 10000.0)), rtol=1e-6)
    y = TA.apply_rope(torch.tensor(x), torch.tensor(pos))
    np.testing.assert_allclose(
        y.numpy(), np.asarray(RA.apply_rope(jnp.asarray(x), jnp.asarray(pos))),
        atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(x, axis=-1),
                               np.linalg.norm(y.numpy(), axis=-1), rtol=1e-5)
    # the relative property: <R_m q, R_n k> depends only on n - m
    q = torch.tensor(rng.standard_normal((1, 1, 1, 16)).astype(np.float32))
    k = torch.tensor(rng.standard_normal((1, 1, 1, 16)).astype(np.float32))

    def dot_at(m, n):
        return float((TA.apply_rope(q, torch.tensor([[m]]))
                      * TA.apply_rope(k, torch.tensor([[n]]))).sum())
    assert abs(dot_at(3, 5) - dot_at(10, 12)) < 1e-4


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rope_partial_rotary(dtype):
    rdt, tdt = DTYPES[dtype]
    x = np.random.default_rng(5).standard_normal((1, 4, 2, 16)).astype(
        np.float32)
    pos = np.arange(4)[None]
    y = TA.apply_rope(torch.tensor(x).to(tdt), torch.tensor(pos),
                      rotary_dim=8)
    r = RA.apply_rope(jnp.asarray(x, rdt), jnp.asarray(pos), rotary_dim=8)
    assert y.dtype == tdt
    assert bf16_ulps(torch.tensor(np.asarray(r.astype(jnp.float32))),
                     y.float()) <= (0 if dtype == "bf16" else 1)
    assert torch.equal(y[..., 8:], torch.tensor(x).to(tdt)[..., 8:])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("batched_valid", [False, True])
def test_decode_attention_matches_reference_and_full(dt, batched_valid):
    B, S, H, Hk, D = 2, 16, 4, 2, 8
    q, k, v = _qkv(6, B, S, H, Hk, D)
    valid = np.arange(S) < S
    if batched_valid:
        valid = np.random.default_rng(7).random((B, S)) < 0.7
        valid[:, 0] = True
    rdt, tdt = DTYPES[dt]
    ref = RA.decode_attention(jnp.asarray(q[:, -1]), jnp.asarray(k),
                              jnp.asarray(v), jnp.asarray(valid), dtype=rdt)
    port = TA.decode_attention(torch.tensor(q[:, -1]), torch.tensor(k),
                               torch.tensor(v), torch.tensor(valid),
                               dtype=tdt)
    _close(ref, port, dt)
    if dt == "f32" and not batched_valid:
        full = naive_attention(q, k, v, causal=True)
        np.testing.assert_allclose(port.numpy(), full[:, -1], atol=2e-5)


@pytest.mark.parametrize("slot", [0, 3, 7])
def test_cache_update_slot(slot):
    cache = np.random.default_rng(8).standard_normal((2, 8, 2, 4)).astype(
        np.float32)
    new = np.ones((2, 2, 4), np.float32)
    ref = RA.cache_update(jnp.asarray(cache), jnp.asarray(new), jnp.int32(slot))
    port = TA.cache_update(torch.tensor(cache), torch.tensor(new), slot)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert float(port[:, slot].sum()) == 2 * 2 * 4
    assert np.array_equal(np.delete(port.numpy(), slot, axis=1),
                          np.delete(cache, slot, axis=1))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_norms_and_swiglu_match_reference(dt):
    rng = np.random.default_rng(9)
    rdt, tdt = DTYPES[dt]
    x = (rng.standard_normal((3, 5, 24)) * 3 + 1).astype(np.float32)
    scale = rng.standard_normal(24).astype(np.float32)
    bias = rng.standard_normal(24).astype(np.float32)
    ln = TL.LayerNorm(torch.tensor(scale), torch.tensor(bias))
    r = RL.layernorm({"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)},
                     jnp.asarray(x), dtype=rdt)
    t = TL.layernorm(ln, torch.tensor(x), dtype=tdt)
    assert t.dtype == tdt
    r = torch.tensor(np.asarray(r.astype(jnp.float32)))
    if dt == "f32":
        torch.testing.assert_close(t, r, rtol=0, atol=ATOL_F32)
    else:
        assert bf16_ulps(r, t.float()) <= 1
    rms = TL.RMSNorm(torch.tensor(scale))
    r = RL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), dtype=rdt)
    t = TL.rmsnorm(rms, torch.tensor(x), dtype=tdt)
    r = torch.tensor(np.asarray(r.astype(jnp.float32)))
    if dt == "f32":
        torch.testing.assert_close(t, r, rtol=0, atol=ATOL_F32)
    else:
        assert bf16_ulps(r, t.float()) <= 1
    # the layer inits' shapes and values are the reference's
    assert torch.equal(TL.layernorm_init(24).scale, torch.ones(24))
    assert torch.equal(TL.rmsnorm_init(24).scale, torch.ones(24))
    # swiglu: the reference's initial weights carried across
    rp = RL.swiglu_ffn_init(jax.random.PRNGKey(0), 24, 40)
    tp = TL.SwiGLU(*(torch.tensor(np.asarray(rp[k]["w"]))
                     for k in ("gate", "up", "down")))
    assert {k: tuple(v["w"].shape) for k, v in tp.tree().items()} == {
        k: tuple(v["w"].shape) for k, v in rp.items()}
    r = RL.swiglu_ffn(rp, jnp.asarray(x), dtype=rdt)
    t = TL.swiglu_ffn(tp, torch.tensor(x), dtype=tdt)
    r = torch.tensor(np.asarray(r.astype(jnp.float32)))
    if dt == "f32":
        torch.testing.assert_close(t, r, rtol=1e-5, atol=ATOL_F32)
    else:  # silu and the products round to bf16 at other places
        assert _ulps_at_scale(r, t) <= SDPA_ULPS
    g = torch.Generator().manual_seed(0)
    sw = TL.swiglu_ffn_init(24, 40, generator=g)
    assert [tuple(w.shape) for w in (sw.gate, sw.up, sw.down)] == [
        (24, 40), (24, 40), (40, 24)]


# (heads, head dim, sequence, causal) of SASRec, BERT4Rec and BST
MODEL_LAYOUTS = {"sasrec": (1, 50, 50, True), "bert4rec": (2, 32, 200, False),
                 "bst": (8, 4, 21, False)}


@pytest.mark.parametrize("model", list(MODEL_LAYOUTS))
def test_sdpa_route_matches_plain_for_each_model(model, monkeypatch):
    """The card's route (``scaled_dot_product_attention`` on the
    pre-scaled ``q``, ``scale=1``), run here on CPU tensors, against the
    plain version at bf16; the backend PyTorch picks is named."""
    H, D, L, causal = MODEL_LAYOUTS[model]
    q, k, v = (torch.tensor(a) for a in _qkv(10, B=16, S=L, H=H, Hk=H, D=D))
    plain = TA.flash_attention(q, k, v, causal=causal, q_chunk=L,
                               kv_chunk=L)
    o = TA._sdpa(q, k, v, causal=causal, dtype=torch.bfloat16)
    assert o.dtype == plain.dtype == torch.bfloat16
    assert _ulps_at_scale(plain, o) <= SDPA_ULPS
    # launches of at most SDPA_MAX_BATCH rows give the same rows
    monkeypatch.setattr(TA, "SDPA_MAX_BATCH", 5)
    assert torch.equal(TA._sdpa(q, k, v, causal=causal,
                                dtype=torch.bfloat16), o)
    assert isinstance(TA.sdpa_backend(q, k, v, causal=causal), str)
    # on the CPU the port itself runs the plain version, under either plan
    with TA.plan("plain"):
        assert torch.equal(TA.flash_attention(q, k, v, causal=causal,
                                              q_chunk=L, kv_chunk=L), plain)
    with pytest.raises(ValueError):
        with TA.plan("sdpa"):
            pass
