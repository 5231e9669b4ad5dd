"""Attention: GQA + RoPE + sliding window, flash-style chunked softmax.

The port of ``repro/nn/attention.py``. Layouts are the reference's: ``q``
``[B, Sq, H, D]``, ``k`` and ``v`` ``[B, Skv, Hk, D]``, query head ``h``
reading KV head ``h // (H // Hk)``.

``flash_attention``'s plain version is the reference's online softmax,
chunk by chunk in the same order: ``q`` scaled in the compute dtype
(the scale rounded to it first, as a weakly typed constant is), scores
and the running sums in float32 (:func:`repro_torch.nn.layers.accum_matmul`),
``NEG_INF`` where masked, ``p`` cast to the compute dtype before ``p·v``,
the sum divided by ``max(l, 1e-30)``. It has no ``pallas_call`` in the
reference, and no kernel of its own here.

On the card (``PLAN = "auto"``) every call goes through
``torch.nn.functional.scaled_dot_product_attention`` on the pre-scaled
``q`` with ``scale=1``: the same function (float32 scores and softmax,
``p`` rounded to the compute dtype before ``p·v``, float32 sums), summed
in another order.

* Where the call is plain causal or bidirectional attention over the
  whole sequence (no offsets, no ``kv_valid``; causal only with ``Sq ==
  Skv``), SDPA takes it with ``is_causal`` and no mask. A ``window`` does
  not stop that when it cannot bite: causal, ``Sq == Skv``, no offsets
  and ``window >= Skv`` make the band ``q − k < window`` true everywhere
  inside the causal mask (an LM's training at ``S <= window``).
* Everything else (a window that bites, chunked prefill's offsets and
  ``kv_valid``) goes with the boolean ``[Sq, Skv]`` mask the plain
  version applies (:func:`attention_mask`). No query row of the LM's
  calls is masked whole (each sees its own position), where the plain
  version would average ``v`` and SDPA gives no such value.

:func:`sdpa_backend` names the backend PyTorch picks for a call.
``PLAN = "plain"`` (or the :func:`plan` context manager) keeps the plain
version on the card too; on the CPU it runs always.

:func:`head_ranges` gives the query and K/V heads each position of a
``model`` axis holds (attention by head ranges); :func:`decode_attention_dh`
is decode attention over a cache split along the head dimension.

:func:`cache_update` writes a decode step's key or value into a copy of
the cache, as the reference's functional update does;
:func:`cache_update_` writes it in place, for a caller that owns the
cache (``models/lm.py::decode_step``).
"""
from __future__ import annotations

import contextlib
import functools

import torch

from .layers import DEFAULT_COMPUTE_DTYPE, accum_matmul

NEG_INF = -1e30

PLAN = "auto"  # "auto": SDPA on the card where it applies | "plain"
SDPA_MAX_BATCH = 1 << 15  # batch rows one scaled_dot_product_attention takes


@contextlib.contextmanager
def plan(name: str):
    """Run the block with ``PLAN = name`` (``"auto"`` or ``"plain"``)."""
    global PLAN
    if name not in ("auto", "plain"):
        raise ValueError(f"unknown attention plan {name!r}")
    old, PLAN = PLAN, name
    try:
        yield
    finally:
        PLAN = old


# ----------------------------------------------------------------------------
# RoPE
# ----------------------------------------------------------------------------
@functools.lru_cache(maxsize=64)
def rope_frequencies(head_dim: int, theta: float, *,
                     device=None) -> torch.Tensor:
    """``1 / theta^(2i / head_dim)``, float32, made once per (head_dim,
    theta, device): a constant made on the device costs a host-to-device
    copy, which waits for the stream (a decode step made two a layer).
    A normal tensor, also when first asked for under inference mode."""
    with torch.inference_mode(False):
        exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
        return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32,
                                            device=device), exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0,
               rotary_dim: int | None = None) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    d = x.shape[-1]
    rd = rotary_dim or d
    inv_freq = rope_frequencies(rd, theta, device=x.device)  # [rd/2]
    angles = positions[..., None].to(torch.float32) * inv_freq
    cos = torch.cos(angles)[..., None, :]  # [..., S, 1, rd/2]
    sin = torch.sin(angles)[..., None, :]
    xr = x[..., :rd].to(torch.float32)
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = torch.cat([rotated, x[..., rd:].to(torch.float32)], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# Flash-style training / prefill attention
# ----------------------------------------------------------------------------
def _band_mask(q_pos, k_pos, *, causal: bool, window: int | None):
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= (q_pos[:, None] - k_pos[None, :]) < window
    return m


def _scaled_q(q, D: int, dtype):
    # the reference multiplies by a weakly typed python float: the scale
    # is rounded to the compute dtype first (then exact in the float32 the
    # product is taken in); a Python number, not a tensor made on the
    # device, which would be a host-to-device copy that waits for the stream
    scale = torch.tensor(D ** -0.5, dtype=dtype).item()
    return q.to(dtype) * scale


def _window_bites(q, k, *, causal, window) -> bool:
    return window is not None and not (causal and q.shape[1] == k.shape[1]
                                       and window >= k.shape[1])


def _sdpa_applies(q, k, *, causal, window, q_offset, kv_offset, kv_valid):
    """SDPA without a mask: see the module docstring."""
    return (PLAN == "auto" and q.device.type == "cuda"
            and not _window_bites(q, k, causal=causal, window=window)
            and kv_valid is None and q_offset == 0 and kv_offset == 0
            and (not causal or q.shape[1] == k.shape[1]))


def attention_mask(Sq: int, Skv: int, *, causal: bool, window: int | None,
                   q_offset: int = 0, kv_offset: int = 0, kv_valid=None,
                   device=None) -> torch.Tensor:
    """The boolean ``[Sq, Skv]`` mask of a call: which key each query
    reads (the plain version's band mask and ``kv_valid``)."""
    q_pos = q_offset + torch.arange(Sq, device=device)
    k_pos = kv_offset + torch.arange(Skv, device=device)
    m = _band_mask(q_pos, k_pos, causal=causal, window=window)
    if kv_valid is not None:
        m &= kv_valid.to(torch.bool)[None]
    return m


def _sdpa_inputs(q, k, v, dtype):
    B, Sq, H, D = q.shape
    G = H // k.shape[2]
    qh = _scaled_q(q, D, dtype).transpose(1, 2)  # [B, H, Sq, D]
    kh = k.to(dtype).transpose(1, 2)
    vh = v.to(dtype).transpose(1, 2)
    if G > 1:
        kh = kh.repeat_interleave(G, dim=1)
        vh = vh.repeat_interleave(G, dim=1)
    return qh, kh, vh


def _sdpa(q, k, v, *, causal: bool, dtype, mask=None) -> torch.Tensor:
    """The card's route: ``scaled_dot_product_attention`` on the
    pre-scaled ``q`` (``scale=1``), ``[B, Sq, H, D]`` in ``dtype``, with
    ``is_causal`` or the boolean ``mask``. Rows are independent: a launch
    takes at most ``SDPA_MAX_BATCH`` of them (the backends put the batch
    on a grid axis of at most 65,535)."""
    B, Sq, H, D = q.shape
    qh, kh, vh = _sdpa_inputs(q, k, v, dtype)
    parts = [torch.nn.functional.scaled_dot_product_attention(
        qh[s:s + SDPA_MAX_BATCH], kh[s:s + SDPA_MAX_BATCH],
        vh[s:s + SDPA_MAX_BATCH], attn_mask=mask,
        is_causal=causal and mask is None, scale=1.0)
        for s in range(0, B, SDPA_MAX_BATCH)]
    o = parts[0] if len(parts) == 1 else torch.cat(parts)
    return o.transpose(1, 2).reshape(B, Sq, H, D)


def sdpa_backend(q, k, v, *, causal: bool, dtype=DEFAULT_COMPUTE_DTYPE,
                 mask=None) -> str:
    """The name of the backend ``scaled_dot_product_attention`` picks for
    ``flash_attention(q, k, v, causal=causal, dtype=dtype)`` on these
    tensors, or with the boolean ``mask`` where the call has one
    (``FLASH_ATTENTION``, ``EFFICIENT_ATTENTION``, ``CUDNN_ATTENTION``,
    ``MATH``, ...)."""
    from torch.nn.attention import SDPBackend

    qh, kh, vh = _sdpa_inputs(q, k, v, dtype)
    code = torch._fused_sdp_choice(qh, kh, vh, mask, 0.0,
                                   causal and mask is None, scale=1.0)
    for name, b in SDPBackend.__members__.items():
        if int(b) == int(code):
            return name
    return f"backend {int(code)}"


def flash_attention(
    q: torch.Tensor,  # [B, Sq, H, D]
    k: torch.Tensor,  # [B, Skv, Hk, D]
    v: torch.Tensor,  # [B, Skv, Hk, D]
    *,
    causal: bool = True,
    window: int | None = None,
    q_chunk: int = 512,
    kv_chunk: int = 1024,
    banded: bool = False,
    q_offset: int = 0,
    kv_offset: int = 0,  # absolute position of k[0] (chunked-prefill windows)
    kv_valid: torch.Tensor | None = None,  # bool [Skv]: which kv slots exist
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> torch.Tensor:
    """Online-softmax chunked attention. Returns [B, Sq, H, D] in
    ``dtype``."""
    B, Sq, H, D = q.shape
    _, Skv, Hk, _ = k.shape
    G = H // Hk
    if _sdpa_applies(q, k, causal=causal, window=window, q_offset=q_offset,
                     kv_offset=kv_offset, kv_valid=kv_valid):
        return _sdpa(q, k, v, causal=causal, dtype=dtype)
    if PLAN == "auto" and q.device.type == "cuda":
        mask = attention_mask(Sq, Skv, causal=causal, window=window,
                              q_offset=q_offset, kv_offset=kv_offset,
                              kv_valid=kv_valid, device=q.device)
        return _sdpa(q, k, v, causal=causal, dtype=dtype, mask=mask)

    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    assert Sq % q_chunk == 0 and Skv % kv_chunk == 0, (Sq, q_chunk, Skv,
                                                       kv_chunk)
    nq = Sq // q_chunk
    dev = q.device

    # [B, Hk, G, S, D] layout: grouped query heads over shared KV heads
    qg = _scaled_q(q, D, dtype).reshape(B, Sq, Hk, G, D).permute(0, 2, 3, 1, 4)
    kg = k.to(dtype).permute(0, 2, 1, 3)  # [B, Hk, Skv, D]
    vg = v.to(dtype).permute(0, 2, 1, 3)

    if banded and window is not None:
        # each q chunk reads a static-length KV band
        band = min(Skv, ((window + q_chunk + kv_chunk - 1) // kv_chunk)
                   * kv_chunk)
    else:
        band = Skv
    nk = band // kv_chunk

    outs = []
    for qi in range(nq):
        q_start = qi * q_chunk
        q_pos = q_offset + q_start + torch.arange(q_chunk, device=dev)
        qc = qg[:, :, :, q_start:q_start + q_chunk]  # [B, Hk, G, qc, D]
        band_start = 0
        if band < Skv:
            band_start = int(min(max(q_offset + q_start + q_chunk - band
                                     - kv_offset, 0), Skv - band))
        m = torch.full((B, Hk, G, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, Hk, G, q_chunk), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, Hk, G, q_chunk, D), dtype=torch.float32,
                          device=dev)
        for ki in range(nk):
            k_start = band_start + ki * kv_chunk
            kc = kg[:, :, k_start:k_start + kv_chunk]
            vc = vg[:, :, k_start:k_start + kv_chunk]
            k_pos = kv_offset + k_start + torch.arange(kv_chunk, device=dev)
            s = accum_matmul("bhgqd,bhkd->bhgqk", qc, kc)
            mask = _band_mask(q_pos, k_pos, causal=causal, window=window)
            if kv_valid is not None:
                mask = mask & kv_valid[k_start:k_start + kv_chunk][None]
            s = torch.where(mask[None, None, None], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * alpha + p.sum(dim=-1)
            pv = accum_matmul("bhgqk,bhkd->bhgqd", p.to(dtype), vc)
            acc = acc * alpha[..., None] + pv
            m = m_new
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(dtype))
    out = torch.cat(outs, dim=3)  # [B, Hk, G, Sq, D]
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, D)


# ----------------------------------------------------------------------------
# Single-token decode with KV cache
# ----------------------------------------------------------------------------
def decode_attention(
    q: torch.Tensor,  # [B, H, D]: the current token's queries (RoPE applied)
    k_cache: torch.Tensor,  # [B, Sc, Hk, D]
    v_cache: torch.Tensor,  # [B, Sc, Hk, D]
    valid: torch.Tensor,  # bool [Sc] or [B, Sc]: which cache slots take part
    *,
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> torch.Tensor:
    B, H, D = q.shape
    Hk = k_cache.shape[2]
    G = H // Hk
    qg = _scaled_q(q, D, dtype).reshape(B, Hk, G, D)
    s = accum_matmul("bhgd,bshd->bhgs", qg, k_cache.to(dtype))
    if valid.dim() == 1:
        valid = valid[None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(dtype)
    out = accum_matmul("bhgs,bshd->bhgd", p, v_cache.to(dtype))
    return out.reshape(B, H, D).to(dtype)


def cache_update(cache: torch.Tensor, new: torch.Tensor,
                 slot) -> torch.Tensor:
    """Write ``new [B, Hk, D]`` into ``cache [B, Sc, Hk, D]`` at time slot
    ``slot`` (a copy: the reference's update is functional). An
    out-of-range slot is clamped, as ``dynamic_update_slice`` clamps it."""
    return cache_update_(cache.clone(), new, slot)


def cache_update_(cache: torch.Tensor, new: torch.Tensor,
                  slot) -> torch.Tensor:
    """:func:`cache_update` in place: writes ``cache[:, slot]`` and
    returns ``cache``."""
    slot = min(max(int(slot), 0), cache.shape[1] - 1)
    cache[:, slot] = new.to(cache.dtype)
    return cache


# ----------------------------------------------------------------------------
# attention by head ranges over a ``model`` axis
# ----------------------------------------------------------------------------
def head_ranges(n_heads: int, n_kv_heads: int, k: int) -> list[tuple]:
    """``(q_lo, q_hi, kv_lo, kv_hi)`` for each of ``k`` positions: the
    query heads ``[p·H/k, (p+1)·H/k)`` position ``p`` holds, and the K/V
    heads they read under GQA (query head ``h`` reads ``h // (H/Hk)``).
    With ``Hk < k`` several positions share one K/V head. Raises where a
    position's query heads do not read whole K/V groups of their own
    (or one head whole)."""
    if n_heads % k:
        raise ValueError(f"{n_heads} query heads do not split over {k} "
                         "positions")
    hq, G = n_heads // k, n_heads // n_kv_heads
    if hq % G and G % hq:
        raise ValueError(f"{hq} query heads a position do not align with "
                         f"GQA groups of {G}")
    out = []
    for p in range(k):
        lo = p * hq
        out.append((lo, lo + hq, lo // G, (lo + hq - 1) // G + 1))
    return out


def decode_attention_dh(
    q: torch.Tensor,  # [B, H, D] at home: every query head, RoPE applied
    k_parts: list,  # per position [B, Sc, Hk, D/k]: its head-dim slice
    v_parts: list,
    valid: torch.Tensor,  # bool [Sc] or [B, Sc]
    *,
    home,
    dtype=DEFAULT_COMPUTE_DTYPE,
) -> torch.Tensor:
    """:func:`decode_attention` over a cache split along the head
    dimension: each position scores its slice of ``q`` against its slice
    of the keys (float32), the partial scores are added at ``home`` in
    position order, the softmax runs there, and each position forms its
    slice of the output, joined at ``home``: ``[B, H, D]`` in ``dtype``."""
    from repro_torch.distributed.tensor_parallel import reduce_sum

    B, H, D = q.shape
    Hk = k_parts[0].shape[2]
    G = H // Hk
    qg = _scaled_q(q, D, dtype).reshape(B, Hk, G, D)
    parts, lo = [], 0
    for kc in k_parts:
        w = kc.shape[-1]
        qs = qg[..., lo:lo + w].to(kc.device)
        parts.append(accum_matmul("bhgd,bshd->bhgs", qs, kc.to(dtype)))
        lo += w
    s = reduce_sum(parts, home)
    if valid.dim() == 1:
        valid = valid[None]
    s = torch.where(valid.to(home)[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1).to(dtype)
    outs = [accum_matmul("bhgs,bshd->bhgd", p.to(vc.device), vc.to(dtype))
            for vc in v_parts]
    out = torch.cat([o.to(home) for o in outs], dim=-1)
    return out.reshape(B, H, D).to(dtype)
