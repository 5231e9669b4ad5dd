"""Transformer LM family: dense + MoE, GQA, RoPE, sliding window.

The port of ``repro/models/lm.py``: one code path covers the five LM
architectures (olmoe, mixtral, h2o-danube, yi, glm4). Entry points:
``init_params``, ``forward``, ``loss_fn`` (train), ``prefill`` (the
prompt, returning the KV cache), ``prefill_chunked`` (the prompt in
sequence chunks) and ``decode_step`` (one token with the KV cache, a
ring buffer of ``window`` slots for sliding-window archs).

Parameters live in an :class:`LM` module whose layers are stacked on a
leading ``L`` axis (:class:`Layers`), as the reference's tree is, so
``tree()`` gives the reference's paths and shapes and a train state's
leaves are the module's own tensors. The reference iterates the stack
with ``lax.scan``; here each call unbinds it once into per-layer views
(one stack of the gradients in the backward pass, not one full-size
gradient per layer) and runs the layers in a Python loop. ``remat=True``
recomputes each layer in the backward pass (``torch.utils.checkpoint``);
``remat_policy="save_block_outputs"`` checkpoints the attention block and
the FFN block apart, so the backward pass keeps each block's output (the
next block's input) and recomputes the rest. The reference's
``constrain(...)`` calls place activations on its mesh; over the port's
mesh each replica already holds its own rows (``distributed/api.py``),
so they are not carried over.

``decode_step`` writes the new token's key and value into the caller's
cache in place (the reference's update is functional: one copy of the
layer's cache per token); the returned cache shares its tensors.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Any

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch._device import resolve_device
from repro_torch.nn import attention as attn
from repro_torch.nn import layers as nnl
from repro_torch.nn import moe as moe_lib

TP = "model"  # the reference's tensor-parallel mesh axis (cache_head_axes)


@dataclass(frozen=True)
class MoESettings:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert hidden dim
    capacity_factor: float = 1.25
    aux_loss_coef: float = 0.01
    ep_shard: bool = False  # expert-parallel iff E % model_axis == 0
    dispatch_groups: int = 1  # set to DP degree by the launcher (local dispatch)


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    rope_theta: float = 10000.0
    rotary_fraction: float = 1.0
    window: int | None = None  # sliding-window attention (Mistral-style)
    moe: MoESettings | None = None
    norm_eps: float = 1e-5
    remat: bool = True
    # "full": recompute each layer in the backward pass. "save_block_outputs":
    # keep the attention and FFN blocks' outputs, recompute the rest
    remat_policy: str = "full"
    q_chunk: int = 512
    kv_chunk: int = 1024
    banded_attention: bool = False  # SWA band slicing
    loss_chunk: int = 512
    microbatch: int = 1  # gradient-accumulation microbatches per train step
    extras: dict[str, Any] = field(default_factory=dict)

    @property
    def dh(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def rotary_dim(self) -> int:
        rd = int(self.dh * self.rotary_fraction)
        return rd - rd % 2

    def param_count(self) -> int:
        d, dh, v = self.d_model, self.dh, self.vocab
        att = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        if self.moe:
            ffn = self.moe.n_experts * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        else:
            ffn = 3 * d * self.d_ff
        per_layer = att + ffn + 2 * d
        return self.n_layers * per_layer + 2 * v * d + d

    def active_param_count(self) -> int:
        if not self.moe:
            return self.param_count()
        d = self.d_model
        att = d * self.dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        ffn = self.moe.top_k * 3 * d * self.moe.d_ff + d * self.moe.n_experts
        return self.n_layers * (att + ffn + 2 * d) + 2 * self.vocab * d + d


class Layers(nn.Module):
    """Every layer's parameters, stacked on a leading ``L`` axis, float32:
    ``attn_norm`` and ``ffn_norm`` (:class:`~repro_torch.nn.layers.RMSNorm`,
    ``[L, d]``), ``wq [L, d, H·dh]``, ``wk``, ``wv [L, d, Hk·dh]``, ``wo
    [L, H·dh, d]``, and ``ffn`` (a SwiGLU, ``[L, d, f]`` / ``[L, f, d]``)
    or ``moe`` (:class:`~repro_torch.nn.moe.MoE`, ``[L, ...]``)."""

    def __init__(self, attn_norm: nnl.RMSNorm, wq, wk, wv, wo,
                 ffn_norm: nnl.RMSNorm, ffn: nnl.SwiGLU | None = None,
                 moe: moe_lib.MoE | None = None):
        super().__init__()
        self.attn_norm, self.ffn_norm = attn_norm, ffn_norm
        for name, t in (("wq", wq), ("wk", wk), ("wv", wv), ("wo", wo)):
            setattr(self, name, nnl._param(t))
        self.ffn, self.moe = ffn, moe

    def tree(self) -> dict:
        t = {"attn_norm": self.attn_norm.tree(),
             "attn": {k: {"w": getattr(self, k)}
                      for k in ("wq", "wk", "wv", "wo")},
             "ffn_norm": self.ffn_norm.tree()}
        if self.moe is not None:
            t["moe"] = self.moe.tree()
        else:
            t["ffn"] = self.ffn.tree()
        return t

    def unbind(self) -> list[SimpleNamespace]:
        """Per-layer views: ``attn_norm.scale``, ``wq`` .. ``wo``,
        ``ffn_norm.scale`` and ``ffn.{gate,up,down}`` or
        ``moe.{router,gate,up,down}``."""
        def views(**ts):
            return {k: torch.unbind(t, 0) for k, t in ts.items()}

        top = views(an=self.attn_norm.scale, fn=self.ffn_norm.scale,
                    wq=self.wq, wk=self.wk, wv=self.wv, wo=self.wo)
        if self.moe is not None:
            m = self.moe
            ff = views(router=m.router, gate=m.gate, up=m.up, down=m.down)
        else:
            f = self.ffn
            ff = views(gate=f.gate, up=f.up, down=f.down)
        out = []
        for i in range(self.wq.shape[0]):
            block = SimpleNamespace(**{k: v[i] for k, v in ff.items()})
            out.append(SimpleNamespace(
                attn_norm=SimpleNamespace(scale=top["an"][i]),
                ffn_norm=SimpleNamespace(scale=top["fn"][i]),
                wq=top["wq"][i], wk=top["wk"][i], wv=top["wv"][i],
                wo=top["wo"][i],
                moe=block if self.moe is not None else None,
                ffn=None if self.moe is not None else block))
        return out


class LM(nn.Module):
    """``embed [V, d]``, the stacked :class:`Layers`, ``final_norm`` and
    ``lm_head [d, V]``; float32."""

    def __init__(self, embed, layers: Layers, final_norm: nnl.RMSNorm,
                 lm_head):
        super().__init__()
        self.embed = nnl._param(embed)
        self.layers = layers
        self.final_norm = final_norm
        self.lm_head = nnl._param(lm_head)

    def tree(self) -> dict:
        return {"embed": {"emb": self.embed}, "layers": self.layers.tree(),
                "final_norm": self.final_norm.tree(),
                "lm_head": {"w": self.lm_head}}


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------
def init_params(cfg: LMConfig, *, generator: torch.Generator | None = None,
                seed: int = 0, device=None) -> LM:
    """Random parameters on ``device`` (default: the card), drawn from
    ``generator`` (default: one on ``device`` seeded with ``seed``), from
    the reference's distributions (dense ``w [in, out]``: stddev
    ``1/√in``; embeddings 0.02; norms ones)."""
    if generator is None:
        generator = torch.Generator(device=resolve_device(device))
        generator.manual_seed(seed)
    g, dev = generator, generator.device
    L, d, dh = cfg.n_layers, cfg.d_model, cfg.dh

    def stacked(in_dim, out_dim):
        return nnl.truncated_normal_init((L, in_dim, out_dim), in_dim ** -0.5,
                                         generator=g)

    embed = nnl.embedding_init(cfg.vocab, d, generator=g)
    wq = stacked(d, cfg.n_heads * dh)
    wk = stacked(d, cfg.n_kv_heads * dh)
    wv = stacked(d, cfg.n_kv_heads * dh)
    wo = stacked(cfg.n_heads * dh, d)
    if cfg.moe:
        ffn, moe = None, moe_lib.moe_init(d, cfg.moe.d_ff, cfg.moe.n_experts,
                                          generator=g, layers=(L,))
    else:
        ffn = nnl.SwiGLU(stacked(d, cfg.d_ff), stacked(d, cfg.d_ff),
                         stacked(cfg.d_ff, d))
        moe = None
    layers = Layers(nnl.RMSNorm(torch.ones(L, d, device=dev)), wq, wk, wv,
                    wo, nnl.RMSNorm(torch.ones(L, d, device=dev)), ffn, moe)
    return LM(embed, layers, nnl.rmsnorm_init(d, device=dev),
              nnl.dense_init(d, cfg.vocab, generator=g))


# ----------------------------------------------------------------------------
# forward (train / prefill)
# ----------------------------------------------------------------------------
def _qkv(layer, x, positions, cfg: LMConfig, dtype):
    B, S, _ = x.shape
    h = nnl.rmsnorm(layer.attn_norm, x, eps=cfg.norm_eps, dtype=dtype)
    q = nnl.dense(layer.wq, h, dtype=dtype).reshape(B, S, cfg.n_heads, cfg.dh)
    k = nnl.dense(layer.wk, h, dtype=dtype).reshape(B, S, cfg.n_kv_heads, cfg.dh)
    v = nnl.dense(layer.wv, h, dtype=dtype).reshape(B, S, cfg.n_kv_heads, cfg.dh)
    q = attn.apply_rope(q, positions, cfg.rope_theta, cfg.rotary_dim)
    k = attn.apply_rope(k, positions, cfg.rope_theta, cfg.rotary_dim)
    return q, k, v


def _attention_block(layer, x, positions, cfg: LMConfig, dtype):
    B, S, _ = x.shape
    q, k, v = _qkv(layer, x, positions, cfg, dtype)
    o = attn.flash_attention(
        q, k, v, causal=True, window=cfg.window,
        q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        banded=cfg.banded_attention, dtype=dtype)
    o = nnl.dense(layer.wo, o.reshape(B, S, cfg.n_heads * cfg.dh), dtype=dtype)
    return x + o, (k, v)


def _ffn_block(layer, x, cfg: LMConfig, dtype):
    B, S, d = x.shape
    h = nnl.rmsnorm(layer.ffn_norm, x, eps=cfg.norm_eps, dtype=dtype)
    if cfg.moe:
        out, aux = moe_lib.moe_apply(
            layer.moe, h.reshape(B * S, d),
            top_k=cfg.moe.top_k, capacity_factor=cfg.moe.capacity_factor,
            dispatch_groups=cfg.moe.dispatch_groups, dtype=dtype)
        return x + out.reshape(B, S, d), aux
    h = nnl.swiglu_ffn(layer.ffn, h, dtype=dtype)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + h, {"moe_aux_loss": zero, "moe_drop_frac": zero}


def _layer(layer, x, positions, cfg: LMConfig, dtype):
    x, kv = _attention_block(layer, x, positions, cfg, dtype)
    x, aux = _ffn_block(layer, x, cfg, dtype)
    return x, aux, kv


def _remat_layer(layer, x, positions, cfg: LMConfig, dtype):
    """One layer recomputed in the backward pass, as ``cfg.remat_policy``
    says (see the module docstring)."""
    if cfg.remat_policy == "save_block_outputs":
        x, kv = checkpoint(lambda y: _attention_block(layer, y, positions,
                                                      cfg, dtype),
                           x, use_reentrant=False)
        x, aux = checkpoint(lambda y: _ffn_block(layer, y, cfg, dtype), x,
                            use_reentrant=False)
        return x, aux, kv
    return checkpoint(lambda y: _layer(layer, y, positions, cfg, dtype), x,
                      use_reentrant=False)


def forward(params: LM, tokens, cfg: LMConfig, *, collect_cache: bool = False,
            dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    """tokens ``[B, S]`` -> ``(hidden [B, S, d], aux, kv)``: ``aux`` the
    layers' mean ``moe_aux_loss`` and ``moe_drop_frac``; ``kv`` the keys
    and values ``([L, B, S, Hk, dh], [L, B, S, Hk, dh])`` if
    ``collect_cache``, else ``None``."""
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None]
    x = nnl.embedding_lookup(params.embed, tokens, dtype=dtype)
    remat = cfg.remat and torch.is_grad_enabled()
    auxs, ks, vs = [], [], []
    for layer in params.layers.unbind():
        if remat:
            x, aux, (k, v) = _remat_layer(layer, x, positions, cfg, dtype)
        else:
            x, aux, (k, v) = _layer(layer, x, positions, cfg, dtype)
        auxs.append(aux)
        if collect_cache:
            ks.append(k)
            vs.append(v)
    x = nnl.rmsnorm(params.final_norm, x, eps=cfg.norm_eps, dtype=dtype)
    aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    kv = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, aux, kv


def loss_fn(params: LM, batch, cfg: LMConfig, *,
            dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    """batch: ``{"tokens": [B, S+1] int32}``. Mean next-token
    cross-entropy (plus the MoE load-balance term): the head and a float32
    logsumexp over ``loss_chunk`` positions at a time, the chunks' sums
    added in order, as the reference's scan adds them."""
    tokens = batch["tokens"]
    inputs, targets = tokens[:, :-1], tokens[:, 1:].to(torch.int64)
    hidden, aux, _ = forward(params, inputs, cfg, dtype=dtype)
    B, S, d = hidden.shape

    n_chunks = max(1, S // cfg.loss_chunk) if S % cfg.loss_chunk == 0 else 1
    c = S // n_chunks
    head = params.lm_head.to(dtype)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(n_chunks):
        h, t = hidden[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c]
        logits = (h.to(dtype) @ head).to(torch.float32)  # [B, c, V]
        lse = torch.logsumexp(logits, dim=-1)
        true = torch.gather(logits, -1, t[..., None])[..., 0]
        total = total + torch.sum(lse - true)
    loss = total / (B * S)
    if cfg.moe:
        loss = loss + cfg.moe.aux_loss_coef * aux["moe_aux_loss"]
    return loss, aux


# ----------------------------------------------------------------------------
# inference: prefill + single-token decode (KV cache)
# ----------------------------------------------------------------------------
def cache_size(cfg: LMConfig, seq_len: int) -> int:
    """Ring buffer of `window` slots for SWA archs, else full length."""
    return min(seq_len, cfg.window) if cfg.window else seq_len


def init_cache(cfg: LMConfig, batch: int, seq_len: int, dtype=torch.bfloat16,
               device=None) -> dict:
    """Zero keys and values ``[L, batch, cache_size, Hk, dh]`` on
    ``device`` (default: the card); ``index`` (the absolute position of
    the next token) 0."""
    dev = resolve_device(device)
    sc = cache_size(cfg, seq_len)
    shape = (cfg.n_layers, batch, sc, cfg.n_kv_heads, cfg.dh)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev),
            "index": 0}


def cache_head_axes(cfg: LMConfig, tp: int = 16):
    """(Hk axis, dh axis) sharding of the KV cache over a model axis of
    ``tp`` shards: heads when divisible, else head-dim, else neither."""
    if cfg.n_kv_heads % tp == 0:
        return (TP, None)
    if cfg.dh % 8 == 0 or cfg.dh % 16 == 0:
        return (None, TP)
    return (None, None)


def _ring(ks, vs, S: int, sc: int):
    """The last ``sc`` positions of ``[L, B, n, ...]`` keys and values
    (ending at absolute position ``S``), rolled so slot = position % sc."""
    ks, vs = ks[:, :, ks.shape[2] - sc:], vs[:, :, vs.shape[2] - sc:]
    shift = S % sc  # slot of position S-sc is (S-sc)%sc = S%sc
    return torch.roll(ks, shift, dims=2), torch.roll(vs, shift, dims=2)


def prefill(params: LM, tokens, cfg: LMConfig, *,
            cache_capacity: int | None = None,
            dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    """Run the prompt; return (last-token logits [B, V] float32, cache)."""
    B, S = tokens.shape
    hidden, _, (ks, vs) = forward(params, tokens, cfg, collect_cache=True,
                                  dtype=dtype)
    sc = cache_size(cfg, cache_capacity or S)
    if sc < S:  # SWA ring: keep last `sc` positions, aligned to slot = pos % sc
        ks, vs = _ring(ks, vs, S, sc)
    elif sc > S:
        pad = (0, 0, 0, 0, 0, sc - S)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    logits = nnl.dense(params.lm_head, hidden[:, -1], dtype=dtype)
    return logits.to(torch.float32), {"k": ks, "v": vs, "index": S}


def prefill_chunked(params: LM, tokens, cfg: LMConfig, *, chunk: int = 4096,
                    dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    """Sarathi-style chunked prefill: the prompt runs through the model in
    sequence chunks, each attending to the KV cache filled so far.
    Activation and MoE-dispatch memory scale with ``chunk``, not the
    prompt length. With a window ≤ ``chunk`` (``swa_local``) chunk ci only
    needs chunk ci-1's keys and values: the carry is one chunk a layer,
    and the final ring cache is the last window of the prompt.

    Returns (last-token logits [B, V], cache) — the contract of
    :func:`prefill`."""
    B, S = tokens.shape
    if S % chunk:
        raise ValueError(f"prompt length {S} is not a multiple of chunk "
                         f"{chunk}")
    nc = S // chunk
    Hk, dh, dev = cfg.n_kv_heads, cfg.dh, tokens.device
    swa_local = bool(cfg.window) and cfg.window <= chunk
    kv_len = chunk if swa_local else S
    layers = params.layers.unbind()
    kcs = [torch.zeros((B, kv_len, Hk, dh), dtype=dtype, device=dev)
           for _ in layers]
    vcs = [torch.zeros_like(kcs[0]) for _ in layers]
    ones = torch.ones(chunk, dtype=torch.bool, device=dev)

    for ci in range(nc):
        offset = ci * chunk
        x = nnl.embedding_lookup(params.embed, tokens[:, offset:offset + chunk],
                                 dtype=dtype)
        positions = offset + torch.arange(chunk, dtype=torch.int32,
                                          device=dev)[None]
        kv_valid = torch.cat([ones if ci > 0 else ~ones, ones])
        for i, layer in enumerate(layers):
            q, k, v = _qkv(layer, x, positions, cfg, dtype)
            k, v = k.to(dtype), v.to(dtype)
            if swa_local:
                o = attn.flash_attention(
                    q, torch.cat([kcs[i], k], dim=1),
                    torch.cat([vcs[i], v], dim=1), causal=True,
                    window=cfg.window, q_chunk=min(cfg.q_chunk, chunk),
                    kv_chunk=cfg.kv_chunk, q_offset=offset,
                    kv_offset=offset - chunk, kv_valid=kv_valid, dtype=dtype)
                kcs[i], vcs[i] = k, v  # next chunk sees this one
            else:
                kcs[i][:, offset:offset + chunk] = k
                vcs[i][:, offset:offset + chunk] = v
                o = attn.flash_attention(
                    q, kcs[i], vcs[i], causal=True, window=cfg.window,
                    q_chunk=min(cfg.q_chunk, chunk), kv_chunk=cfg.kv_chunk,
                    banded=cfg.banded_attention, q_offset=offset, dtype=dtype)
            x = x + nnl.dense(layer.wo, o.reshape(B, chunk, cfg.n_heads * dh),
                              dtype=dtype)
            x, _ = _ffn_block(layer, x, cfg, dtype)
        x = nnl.rmsnorm(params.final_norm, x, eps=cfg.norm_eps, dtype=dtype)
        logits = nnl.dense(params.lm_head, x[:, -1], dtype=dtype)

    ks, vs = torch.stack(kcs), torch.stack(vcs)
    sc = cache_size(cfg, S)
    if swa_local or sc < S:  # the carry ends at position S: ring conversion
        ks, vs = _ring(ks, vs, S, sc)
    return logits.to(torch.float32), {"k": ks, "v": vs, "index": S}


def decode_step(params: LM, cache: dict, tokens, cfg: LMConfig, *,
                dtype=nnl.DEFAULT_COMPUTE_DTYPE):
    """One serve step: tokens ``[B]`` -> (logits ``[B, V]`` float32, cache
    at the next position). The token's keys and values go into
    ``cache["k"]`` and ``cache["v"]`` in place, at slot ``index % sc`` for
    a sliding window (the ring), else ``index`` (clamped to the last
    slot, as ``dynamic_update_slice`` clamps)."""
    B = tokens.shape[0]
    dh, Hk = cfg.dh, cfg.n_kv_heads
    pos = int(cache["index"])  # absolute position of the new token
    sc = cache["k"].shape[2]
    slot = pos % sc if cfg.window else pos
    dev = cache["k"].device
    valid = torch.arange(sc, device=dev) < min(pos + 1, sc)

    x = nnl.embedding_lookup(params.embed, tokens, dtype=dtype)  # [B, d]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=dev)
    for i, layer in enumerate(params.layers.unbind()):
        q, k, v = _qkv(layer, x[:, None], posv, cfg, dtype)
        kc = attn.cache_update_(cache["k"][i], k[:, 0], slot)
        vc = attn.cache_update_(cache["v"][i], v[:, 0], slot)
        o = attn.decode_attention(q[:, 0], kc, vc, valid, dtype=dtype)
        x = x + nnl.dense(layer.wo, o.reshape(B, cfg.n_heads * dh),
                          dtype=dtype)
        x2, _ = _ffn_block(layer, x[:, None], cfg, dtype)
        x = x2[:, 0]
    x = nnl.rmsnorm(params.final_norm, x, eps=cfg.norm_eps, dtype=dtype)
    logits = nnl.dense(params.lm_head, x, dtype=dtype)
    return logits.to(torch.float32), {"k": cache["k"], "v": cache["v"],
                                      "index": pos + 1}
