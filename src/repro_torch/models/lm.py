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
next block's input) and recomputes the rest.

Over a mesh, the reference's ``constrain(...)`` calls on the data axes
are not carried over: each data position already holds its own rows
(``distributed/api.py``). Over its ``model`` axis every entry point
takes a :class:`~repro_torch.distributed.tensor_parallel.ModelParallel`
(one data position's compute copy, built by ``train.jit_train_step`` and
``registry.run_cell``) and computes the reference's GSPMD partition:
the embedding by vocabulary rows, attention by head ranges (``wq``
column-parallel, ``wk`` / ``wv`` split by K/V heads where the rule
splits them, else each position reads the K/V heads its query heads map
to), ``wo`` and the FFN's ``down`` row-parallel, MoE experts or their
hidden units (``nn/moe.py::moe_apply_mp``), ``lm_head`` by columns with
the logsumexp across the positions. Prefill returns the cache split
along the sequence over ``model`` and the logits over the vocabulary,
the layouts the reference's ``constrain`` fixes there; decode reads the
cache in the cell's layout (``cache_head_axes``: split by K/V heads, or
by head dimension, whose partial scores are added in position order,
GSPMD's psum) and writes the new token in each position's slice.

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
from repro_torch.distributed import tensor_parallel as tp
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
    if isinstance(params, tp.ModelParallel):
        return _mp_forward(params, tokens, cfg, collect_cache=collect_cache,
                           dtype=dtype)
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
    added in order, as the reference's scan adds them.

    ``params`` may be a ``data_parallel.RowSplit`` with ``batch`` its
    positions' parts (one device's batch is the one-position case): each
    position's forward over its rows (an MoE config's dispatch groups
    divided among them, as its batch-sharded groups lie), each chunk's
    token terms joined at home in position order and summed as one device
    sums them; the MoE terms from every position's routing
    (``moe.aux_of``)."""
    import dataclasses

    from repro_torch.distributed.data_parallel import RowSplit

    split, parts = ((params, batch) if isinstance(params, RowSplit) else
                    (RowSplit.one(params, batch), [batch]))
    n = split.n
    B = sum(b["tokens"].shape[0] for b in parts)
    S = parts[0]["tokens"].shape[1] - 1
    if cfg.moe:
        G = cfg.moe.dispatch_groups if (B * S) % cfg.moe.dispatch_groups \
            == 0 else 1
        if G % n:
            raise ValueError(f"{G} MoE dispatch groups do not split over "
                             f"{n} positions")
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=G // n))
    terms, routes = [], []
    for params, b in zip(split.replicas, parts):
        tokens = b["tokens"]
        with moe_lib.record_routes() as seen:
            hidden, aux, _ = forward(params, tokens[:, :-1], cfg, dtype=dtype)
        terms.append(_token_terms(params, hidden, tokens[:, 1:].to(
            torch.int64), cfg, dtype))
        routes.append(seen)
    total = torch.zeros((), dtype=torch.float32, device=split.home)
    for chunk in zip(*terms):
        total = total + torch.sum(split.gather(list(chunk)))
    loss = total / (B * S)
    if cfg.moe:  # a dense model's are zeros (the last position's)
        layers = [moe_lib.aux_of(list(r), top_k=cfg.moe.top_k,
                                 home=split.home) for r in zip(*routes)]
        aux = {k: torch.stack([a[k] for a in layers]).mean()
               for k in layers[0]}
        loss = loss + cfg.moe.aux_loss_coef * aux["moe_aux_loss"]
    return loss, aux


def _token_terms(params, hidden, targets, cfg: LMConfig, dtype) -> list:
    """``logsumexp − target logit`` (float32 ``[B, c]``) of each
    ``loss_chunk`` of the sequence, in order."""
    B, S, _ = hidden.shape
    n_chunks = max(1, S // cfg.loss_chunk) if S % cfg.loss_chunk == 0 else 1
    c = S // n_chunks
    mp = isinstance(params, tp.ModelParallel)
    if mp:  # the head's columns a position, the logsumexp across them
        heads = [w.to(dtype) for w in params.view("lm_head/w").parts]
    else:
        head = params.lm_head.to(dtype)
    out = []
    for i in range(n_chunks):
        h, t = hidden[:, i * c:(i + 1) * c], targets[:, i * c:(i + 1) * c]
        if mp:
            hd = h.to(dtype)
            lse, true = tp.vocab_logsumexp(
                [(hd.to(w.device) @ w).to(torch.float32) for w in heads], t,
                home=params.home)
        else:
            logits = (h.to(dtype) @ head).to(torch.float32)  # [B, c, V]
            lse = torch.logsumexp(logits, dim=-1)
            true = torch.gather(logits, -1, t[..., None])[..., 0]
        out.append(lse - true)
    return out


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
    if isinstance(params, tp.ModelParallel):
        return _mp_prefill_out(params, hidden, ks, vs, S, cfg,
                               cache_capacity=cache_capacity, dtype=dtype)
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
    if isinstance(params, tp.ModelParallel):
        return _mp_prefill_chunked(params, tokens, cfg, chunk=chunk,
                                   dtype=dtype)
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
    if isinstance(params, tp.ModelParallel):
        return _mp_decode_step(params, cache, tokens, cfg, dtype=dtype)
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


# ----------------------------------------------------------------------------
# over a mesh's ``model`` axis (one data position's ModelParallel)
# ----------------------------------------------------------------------------
_LAYER_LEAVES = {"an": "layers/attn_norm/scale", "fn": "layers/ffn_norm/scale",
                 "wq": "layers/attn/wq/w", "wk": "layers/attn/wk/w",
                 "wv": "layers/attn/wv/w", "wo": "layers/attn/wo/w"}
_FFN_LEAVES = ("gate", "up", "down")


def _mp_layers(mp: tp.ModelParallel) -> list[SimpleNamespace]:
    """Per-layer views of ``mp``'s stacked leaves, shaped as
    :meth:`Layers.unbind`'s: a tensor at home or ``tp.Slices``."""
    top = {k: mp.unbind(p) for k, p in _LAYER_LEAVES.items()}
    is_moe = "layers/moe/router/w" in mp.leaves
    ff = {k: mp.unbind(f"layers/{'moe' if is_moe else 'ffn'}/{k}/w")
          for k in _FFN_LEAVES + (("router",) if is_moe else ())}
    out = []
    for i in range(len(top["wq"])):
        block = SimpleNamespace(**{k: v[i] for k, v in ff.items()})
        out.append(SimpleNamespace(
            attn_norm=SimpleNamespace(scale=top["an"][i]),
            ffn_norm=SimpleNamespace(scale=top["fn"][i]),
            wq=top["wq"][i], wk=top["wk"][i], wv=top["wv"][i],
            wo=top["wo"][i], moe=block if is_moe else None,
            ffn=None if is_moe else block))
    return out


def _mp_qkv(mp, layer, x, positions, cfg: LMConfig, dtype):
    """Each position's queries (its head range, RoPE applied) and the K/V
    heads they read: ``(qs, ks, vs, kv)``, the lists a position each;
    ``kv`` the whole keys and values at home, or ``None`` where the rule
    splits ``wk`` / ``wv`` (each position made its own heads)."""
    B, S, _ = x.shape
    dh = cfg.dh
    ranges = attn.head_ranges(cfg.n_heads, cfg.n_kv_heads, mp.k)
    h = nnl.rmsnorm(layer.attn_norm, x, eps=cfg.norm_eps, dtype=dtype)
    qs = [attn.apply_rope(q.reshape(B, S, -1, dh), positions.to(q.device),
                          cfg.rope_theta, cfg.rotary_dim)
          for q in tp.column_dense(h, layer.wq, dtype=dtype)]
    if isinstance(layer.wk, tp.Slices):  # the rule splits the K/V heads
        ks = [attn.apply_rope(k.reshape(B, S, -1, dh),
                              positions.to(k.device), cfg.rope_theta,
                              cfg.rotary_dim)
              for k in tp.column_dense(h, layer.wk, dtype=dtype)]
        vs = [v.reshape(B, S, -1, dh)
              for v in tp.column_dense(h, layer.wv, dtype=dtype)]
        if any(k.shape[2] != hi - lo for k, (*_, lo, hi) in zip(ks, ranges)):
            raise ValueError("the K/V heads a position holds are not those "
                             "its query heads read")
        return qs, ks, vs, None
    k = nnl.dense(layer.wk, h, dtype=dtype).reshape(B, S, cfg.n_kv_heads, dh)
    v = nnl.dense(layer.wv, h, dtype=dtype).reshape(B, S, cfg.n_kv_heads, dh)
    k = attn.apply_rope(k, positions, cfg.rope_theta, cfg.rotary_dim)
    ks = [k[:, :, lo:hi].to(d) for (*_, lo, hi), d in zip(ranges, mp.devices)]
    vs = [v[:, :, lo:hi].to(d) for (*_, lo, hi), d in zip(ranges, mp.devices)]
    return qs, ks, vs, (k, v)


def _mp_whole_kv(mp, ks, vs, kv):
    """The whole keys and values at home: ``kv``, or the positions' heads
    joined (each K/V head once)."""
    if kv is not None:
        return kv
    return tp.gather(ks, 2, mp.home), tp.gather(vs, 2, mp.home)


def _mp_attention_block(mp, layer, x, positions, cfg: LMConfig, dtype,
                        collect: bool = False):
    B, S, _ = x.shape
    qs, ks, vs, kv = _mp_qkv(mp, layer, x, positions, cfg, dtype)
    os = [attn.flash_attention(
        q, k, v, causal=True, window=cfg.window, q_chunk=cfg.q_chunk,
        kv_chunk=cfg.kv_chunk, banded=cfg.banded_attention, dtype=dtype)
        for q, k, v in zip(qs, ks, vs)]
    o = tp.row_dense([o.reshape(B, S, -1) for o in os], layer.wo,
                     home=mp.home, dtype=dtype)
    kv = _mp_whole_kv(mp, ks, vs, kv) if collect else None
    return x + o, kv


def _mp_ffn_block(mp, layer, x, cfg: LMConfig, dtype):
    B, S, d = x.shape
    h = nnl.rmsnorm(layer.ffn_norm, x, eps=cfg.norm_eps, dtype=dtype)
    if cfg.moe:
        out, aux = moe_lib.moe_apply_mp(
            layer.moe, h.reshape(B * S, d), top_k=cfg.moe.top_k,
            home=mp.home, capacity_factor=cfg.moe.capacity_factor,
            dispatch_groups=cfg.moe.dispatch_groups, dtype=dtype)
        return x + out.reshape(B, S, d), aux
    f = layer.ffn
    hs = [torch.nn.functional.silu(g) * u for g, u in zip(
        tp.column_dense(h, f.gate, dtype=dtype),
        tp.column_dense(h, f.up, dtype=dtype))]
    out = tp.row_dense(hs, f.down, home=mp.home, dtype=dtype)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    return x + out, {"moe_aux_loss": zero, "moe_drop_frac": zero}


def _mp_layer(mp, layer, x, positions, cfg: LMConfig, dtype, collect=False):
    x, kv = _mp_attention_block(mp, layer, x, positions, cfg, dtype, collect)
    x, aux = _mp_ffn_block(mp, layer, x, cfg, dtype)
    return x, aux, kv


def _mp_remat_layer(mp, layer, x, positions, cfg: LMConfig, dtype):
    """:func:`_remat_layer` over the positions: ``(x, aux)``."""
    if cfg.remat_policy == "save_block_outputs":
        x, _ = checkpoint(lambda y: _mp_attention_block(
            mp, layer, y, positions, cfg, dtype), x, use_reentrant=False)
        return checkpoint(lambda y: _mp_ffn_block(mp, layer, y, cfg, dtype),
                          x, use_reentrant=False)
    x, aux, _ = checkpoint(lambda y: _mp_layer(mp, layer, y, positions, cfg,
                                               dtype), x, use_reentrant=False)
    return x, aux


def _mp_forward(mp, tokens, cfg: LMConfig, *, collect_cache: bool, dtype):
    B, S = tokens.shape
    home = mp.home
    tokens = tokens.to(home)
    positions = torch.arange(S, dtype=torch.int32, device=home)[None]
    x = tp.vocab_embedding(mp.view("embed/emb"), tokens, home=home,
                           dtype=dtype)
    remat = cfg.remat and torch.is_grad_enabled() and not collect_cache
    auxs, ks, vs = [], [], []
    for layer in _mp_layers(mp):
        if remat:
            x, aux = _mp_remat_layer(mp, layer, x, positions, cfg, dtype)
        else:
            x, aux, kv = _mp_layer(mp, layer, x, positions, cfg, dtype,
                                   collect_cache)
            if collect_cache:
                ks.append(kv[0])
                vs.append(kv[1])
        auxs.append(aux)
    x = nnl.rmsnorm(SimpleNamespace(scale=mp.view("final_norm/scale")), x,
                    eps=cfg.norm_eps,                     dtype=dtype)
    aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    kv = (torch.stack(ks), torch.stack(vs)) if collect_cache else None
    return x, aux, kv


def _mp_logits(mp, x, dtype):
    """The last position's logits split over the vocabulary (``lm_head``'s
    columns a position), float32: a ``BlockSharded`` over ``model``."""
    from repro_torch.distributed.sharding import BlockSharded

    parts = [p.to(torch.float32) for p in tp.column_dense(
        x, mp.view("lm_head/w"), dtype=dtype)]
    return BlockSharded(mp.mesh, (tp.MODEL,), tuple(parts), x.dim() - 1)


def _mp_prefill_out(mp, hidden, ks, vs, S: int, cfg: LMConfig, *,
                    cache_capacity, dtype):
    """:func:`prefill`'s ring or padding, then its outputs in the
    reference's boundary layouts: the cache split along the sequence over
    ``model`` and the logits over the vocabulary."""
    sc = cache_size(cfg, cache_capacity or S)
    if sc < S:
        ks, vs = _ring(ks, vs, S, sc)
    elif sc > S:
        pad = (0, 0, 0, 0, 0, sc - S)
        ks = torch.nn.functional.pad(ks, pad)
        vs = torch.nn.functional.pad(vs, pad)
    logits = _mp_logits(mp, hidden[:, -1], dtype)
    return logits, {"k": mp.split(ks, 2), "v": mp.split(vs, 2), "index": S}


def _mp_prefill_chunked(mp, tokens, cfg: LMConfig, *, chunk: int, dtype):
    """:func:`prefill_chunked` over the positions: each keeps the K/V heads
    its query heads read, chunk by chunk."""
    B, S = tokens.shape
    if S % chunk:
        raise ValueError(f"prompt length {S} is not a multiple of chunk "
                         f"{chunk}")
    home = mp.home
    tokens = tokens.to(home)
    nc, dh = S // chunk, cfg.dh
    swa_local = bool(cfg.window) and cfg.window <= chunk
    kv_len = chunk if swa_local else S
    ranges = attn.head_ranges(cfg.n_heads, cfg.n_kv_heads, mp.k)
    layers = _mp_layers(mp)
    kcs = [[torch.zeros((B, kv_len, hi - lo, dh), dtype=dtype, device=d)
            for (*_, lo, hi), d in zip(ranges, mp.devices)] for _ in layers]
    vcs = [[torch.zeros_like(k) for k in row] for row in kcs]
    whole = [None] * len(layers)  # (k, v) at home where wk is replicated
    ones = torch.ones(chunk, dtype=torch.bool, device=home)

    for ci in range(nc):
        offset = ci * chunk
        x = tp.vocab_embedding(mp.view("embed/emb"),
                               tokens[:, offset:offset + chunk], home=home,
                               dtype=dtype)
        positions = offset + torch.arange(chunk, dtype=torch.int32,
                                          device=home)[None]
        kv_valid = torch.cat([ones if ci > 0 else ~ones, ones])
        for i, layer in enumerate(layers):
            qs, ks, vs, kv = _mp_qkv(mp, layer, x, positions, cfg, dtype)
            os = []
            for p, (q, k, v) in enumerate(zip(qs, ks, vs)):
                k, v = k.to(dtype), v.to(dtype)
                if swa_local:
                    os.append(attn.flash_attention(
                        q, torch.cat([kcs[i][p], k], dim=1),
                        torch.cat([vcs[i][p], v], dim=1), causal=True,
                        window=cfg.window, q_chunk=min(cfg.q_chunk, chunk),
                        kv_chunk=cfg.kv_chunk, q_offset=offset,
                        kv_offset=offset - chunk,
                        kv_valid=kv_valid.to(q.device), dtype=dtype))
                    kcs[i][p], vcs[i][p] = k, v
                else:
                    kcs[i][p][:, offset:offset + chunk] = k
                    vcs[i][p][:, offset:offset + chunk] = v
                    os.append(attn.flash_attention(
                        q, kcs[i][p], vcs[i][p], causal=True,
                        window=cfg.window, q_chunk=min(cfg.q_chunk, chunk),
                        kv_chunk=cfg.kv_chunk, banded=cfg.banded_attention,
                        q_offset=offset, dtype=dtype))
            if kv is not None:  # the whole carry at home, as one device's
                k, v = (t.to(dtype) for t in kv)
                if swa_local:
                    whole[i] = (k, v)
                else:
                    if whole[i] is None:
                        whole[i] = tuple(torch.zeros((B, kv_len) + k.shape[2:],
                                                     dtype=dtype, device=home)
                                         for _ in range(2))
                    whole[i][0][:, offset:offset + chunk] = k
                    whole[i][1][:, offset:offset + chunk] = v
            x = x + tp.row_dense([o.reshape(B, chunk, -1) for o in os],
                                 layer.wo, home=home, dtype=dtype)
            x, _ = _mp_ffn_block(mp, layer, x, cfg, dtype)
        x = nnl.rmsnorm(SimpleNamespace(scale=mp.view("final_norm/scale")), x,
                    eps=cfg.norm_eps,                         dtype=dtype)
        logits = _mp_logits(mp, x[:, -1], dtype)

    ks = torch.stack([w[0] if w is not None else tp.gather(kc, 2, home)
                      for w, kc in zip(whole, kcs)])
    vs = torch.stack([w[1] if w is not None else tp.gather(vc, 2, home)
                      for w, vc in zip(whole, vcs)])
    sc = cache_size(cfg, S)
    if swa_local or sc < S:
        ks, vs = _ring(ks, vs, S, sc)
    return logits, {"k": mp.split(ks, 2), "v": mp.split(vs, 2), "index": S}


def _mp_decode_step(mp, cache: dict, tokens, cfg: LMConfig, *, dtype):
    """:func:`decode_step` over the positions, the cache in the cell's
    layout: ``cache["k"]`` / ``["v"]`` split over ``model`` by K/V heads
    (dimension 3) or by head dimension (dimension 4), a slice on each
    position's device, written in place."""
    from repro_torch.distributed.sharding import BlockSharded

    ck, cv = cache["k"], cache["v"]
    if not isinstance(ck, BlockSharded) or ck.dim not in (3, 4):
        raise ValueError("a decode over the model axis reads a cache split "
                         "over it by K/V heads or by head dimension")
    home = mp.home
    B = tokens.shape[0]
    tokens = tokens.to(home)
    dh = cfg.dh
    pos = int(cache["index"])
    sc = ck.shape[2]
    slot = pos % sc if cfg.window else pos
    valid = torch.arange(sc, device=home) < min(pos + 1, sc)
    ranges = attn.head_ranges(cfg.n_heads, cfg.n_kv_heads, mp.k)
    by_heads = ck.dim == 3
    if by_heads and [s.shape[3] for s in ck.shards] != [
            hi - lo for *_, lo, hi in ranges]:
        raise ValueError("the cache's K/V heads a position are not those its "
                         "query heads read")
    kl = [torch.unbind(s, 0) for s in ck.shards]
    vl = [torch.unbind(s, 0) for s in cv.shards]

    x = tp.vocab_embedding(mp.view("embed/emb"), tokens, home=home,
                           dtype=dtype)  # [B, d]
    posv = torch.full((B, 1), pos, dtype=torch.int32, device=home)
    for i, layer in enumerate(_mp_layers(mp)):
        qs, ks, vs, kv = _mp_qkv(mp, layer, x[:, None], posv, cfg, dtype)
        kc = [t[i] for t in kl]
        vc = [t[i] for t in vl]
        if by_heads:
            for p in range(mp.k):
                attn.cache_update_(kc[p], ks[p][:, 0], slot)
                attn.cache_update_(vc[p], vs[p][:, 0], slot)
            os = [attn.decode_attention(q[:, 0], k, v, valid.to(q.device),
                                        dtype=dtype).reshape(B, -1)
                  for q, k, v in zip(qs, kc, vc)]
        else:  # head dimension: partial scores summed in position order
            k, v = _mp_whole_kv(mp, ks, vs, kv)
            for kp, vp, nk, nv in zip(kc, vc, tp.scatter(k[:, 0], mp.devices,
                                                          2),
                                      tp.scatter(v[:, 0], mp.devices, 2)):
                attn.cache_update_(kp, nk, slot)
                attn.cache_update_(vp, nv, slot)
            q = tp.gather([q[:, 0] for q in qs], 1, home)  # [B, H, dh]
            o = attn.decode_attention_dh(q, kc, vc, valid, home=home,
                                         dtype=dtype)
            os = [t.reshape(B, -1) for t in tp.scatter(o, mp.devices, 1)]
        x = x + tp.row_dense(os, layer.wo, home=home, dtype=dtype)
        x2, _ = _mp_ffn_block(mp, layer, x[:, None], cfg, dtype)
        x = x2[:, 0]
    x = nnl.rmsnorm(SimpleNamespace(scale=mp.view("final_norm/scale")), x,
                    eps=cfg.norm_eps,                     dtype=dtype)
    return _mp_logits(mp, x, dtype), {"k": ck, "v": cv, "index": pos + 1}
