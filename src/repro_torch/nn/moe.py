"""Mixture-of-Experts FFN: top-k routing, capacity-based sort dispatch.

The port of ``repro/nn/moe.py``. Per-(token, k) expert slots are ranked
with a stable sort, written into an ``[E, C, d]`` buffer, processed with
stacked per-expert products, and combined with the router's gates.
Tokens past an expert's capacity ``C = max(1, int(Tg·K·capacity_factor /
E))`` are dropped, exactly the rows the reference drops
(``moe_drop_frac``): at olmoe's decode batch of 4 (T = 4, K = 8, E = 64)
``C`` is 1.

Ranking and capacity run inside ``dispatch_groups`` groups of ``T / G``
tokens (1 on one card; the reference sets it to the data-parallel degree
so the sort stays shard-local). The router's top-k orders equal
probabilities by lower expert index, as ``lax.top_k`` does
(:func:`repro_torch.models.recsys.topk_lower_index`). The expert products
are ``torch.einsum`` with float32 products and sums
(:func:`repro_torch.nn.layers.accum_matmul`), rounded to the compute
dtype after each, as the reference's ``preferred_element_type`` asks;
they are plain products outside any Pallas kernel there. The top-k
probabilities are renormalised (the reference's default, which every
caller keeps).

Over a mesh's ``model`` axis (:func:`moe_apply_mp`, the reference's
GSPMD partition of the same function) the router, the dispatch and the
combine run once a data position, at home, on the whole ``x``: the
choice of expert, the capacity drops and ``moe_aux_loss`` /
``moe_drop_frac`` are the single-device ones for the same ``x``. Only
the expert products are split, as the leaves' layout says: by experts
(the config's ``ep_shard``, ``gate`` / ``up`` / ``down`` split along
``E``: each position runs its experts on their rows of the dispatch
buffer, and the combine reads the gathered outputs), or by each expert's
hidden units (``gate`` and ``up`` column-parallel, ``down`` row-parallel:
float32 partials added in position order, rounded once).

A microbatch whose rows a mesh's data positions split
(``distributed/data_parallel.py``) runs each position's dispatch groups
there; ``moe_aux_loss`` and ``moe_drop_frac`` read every token of the
microbatch, so each call's routing terms are recorded
(:func:`record_routes`) and :func:`aux_of` computes them from the
positions' terms joined in position order: the single device's values.
"""
from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn

from repro_torch.models.recsys import topk_lower_index

from .layers import (DEFAULT_COMPUTE_DTYPE, _param, accum_matmul,
                     truncated_normal_init)


class MoE(nn.Module):
    """``router [d, E]``, ``gate`` and ``up [E, d, f]``, ``down [E, f, d]``,
    float32 (stacked ``[L, ...]`` inside a model's layers)."""

    def __init__(self, router, gate, up, down):
        super().__init__()
        self.router, self.gate = _param(router), _param(gate)
        self.up, self.down = _param(up), _param(down)

    def tree(self) -> dict:
        return {"router": {"w": self.router}, "gate": {"w": self.gate},
                "up": {"w": self.up}, "down": {"w": self.down}}


def moe_init(d_model: int, d_ff: int, n_experts: int, *,
             generator: torch.Generator, layers: tuple[int, ...] = ()) -> MoE:
    """The reference's distributions (router, gate, up: stddev
    ``d_model^-1/2``; down: ``d_ff^-1/2``); ``layers`` prepends stacked
    dims."""
    se, sf = d_model ** -0.5, d_ff ** -0.5
    g, L = generator, tuple(layers)
    return MoE(truncated_normal_init(L + (d_model, n_experts), se, generator=g),
               truncated_normal_init(L + (n_experts, d_model, d_ff), se, generator=g),
               truncated_normal_init(L + (n_experts, d_model, d_ff), se, generator=g),
               truncated_normal_init(L + (n_experts, d_ff, d_model), sf, generator=g))


def _positions_within_expert(flat_e: torch.Tensor, n_experts: int) -> torch.Tensor:
    """Rank of each dispatch row within its expert (token order), by a
    stable sort along the last dim (a leading group dim is allowed)."""
    n = flat_e.shape[-1]
    sorted_e, order = torch.sort(flat_e, dim=-1, stable=True)
    idx = torch.arange(n, dtype=torch.int64, device=flat_e.device).expand_as(order)
    is_start = torch.ones_like(sorted_e, dtype=torch.bool)
    is_start[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    seg_start = torch.cummax(torch.where(is_start, idx, 0), dim=-1).values
    pos = torch.zeros_like(idx)
    return pos.scatter_(-1, order, idx - seg_start).to(torch.int32)


def _dispatch_group(x, top_e, top_p, *, n_experts: int, capacity: int,
                    dtype):
    """Every dispatch group at once (the reference's per-group function
    under a leading group dim): ``x [G, Tg, d]``, ``top_e``, ``top_p [G,
    Tg, K]`` -> ``(buf [G, E*C, d]`` in ``dtype``, ``dst [G, Tg*K]``: each
    dispatch row's buffer slot, ``E*C`` (the drop bin) for a dropped row;
    ``gates [G, Tg*K]`` in ``dtype``, 0 where dropped; ``keep [G,
    Tg*K])``.

    A slot no kept row fills reads the zero row. The kept rows' slots are
    distinct; the dropped rows all land in one extra slot past ``E*C``
    that is cut off, so they leave no trace, as the reference's
    ``.at[dst].set(..., mode="drop")`` (and no host sync is needed to
    pick the kept rows out)."""
    G, Tg, d = x.shape
    K = top_e.shape[-1]
    E, C = n_experts, capacity
    dev = x.device
    flat_e = top_e.reshape(G, Tg * K).to(torch.int64)
    pos = _positions_within_expert(flat_e, E).to(torch.int64)
    keep = pos < C
    dst = torch.where(keep, flat_e * C + pos, E * C)

    token_of_row = torch.arange(Tg, device=dev).repeat_interleave(K)
    inv = torch.full((G, E * C + 1), Tg, dtype=torch.int64, device=dev)
    inv.scatter_(1, dst, token_of_row.expand(G, Tg * K))
    inv = inv[:, : E * C]
    # one flat table of the groups' rows, each group followed by a zero row
    x_pad = torch.cat([x, x.new_zeros(G, 1, d)], dim=1).reshape(-1, d)
    rows = inv + (Tg + 1) * torch.arange(G, device=dev)[:, None]
    buf = torch.nn.functional.embedding(rows, x_pad).to(dtype)
    gates = torch.where(keep, top_p.reshape(G, Tg * K), 0.0).to(dtype)
    return buf, dst, gates, keep


def _route(params, x, *, top_k: int, capacity_factor: float,
           dispatch_groups: int, dtype):
    """The router, top-k and dispatch of :func:`moe_apply`: ``(buf [G, E,
    C, d], dst, gates, keep, probs, top_e)``."""
    T, d = x.shape
    E = params.router.shape[-1]
    K = top_k
    G = dispatch_groups if T % dispatch_groups == 0 else 1
    Tg = T // G
    C = max(1, int(Tg * K * capacity_factor / E))

    logits = x.to(torch.float32) @ params.router.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)  # [T, E]
    top_p, top_e = topk_lower_index(probs, K)  # [T, K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    buf, dst, gates, keep = _dispatch_group(
        x.reshape(G, Tg, d), top_e.reshape(G, Tg, K),
        top_p.reshape(G, Tg, K), n_experts=E, capacity=C, dtype=dtype)
    return buf.reshape(G, E, C, d), dst, gates, keep, probs, top_e


def _experts(buf, gate, up, down, dtype, *, round_out: bool = True):
    """The stacked per-expert SwiGLU over ``buf [G, E', C, d]``; float32
    products and sums, rounded to ``dtype`` after each product (the last
    one left in float32 without ``round_out``)."""
    g = accum_matmul("gecd,edf->gecf", buf, gate.to(dtype)).to(dtype)
    u = accum_matmul("gecd,edf->gecf", buf, up.to(dtype)).to(dtype)
    h = torch.nn.functional.silu(g) * u
    y = accum_matmul("gecf,efd->gecd", h, down.to(dtype))
    return y.to(dtype) if round_out else y


def _combine(y, dst, gates, *, T: int, K: int):
    """Each dispatch row's expert output (``y [G, E·C, d]``) weighted by
    its gate, summed over the token's ``K`` rows: ``[T, d]``."""
    G, EC, d = y.shape
    y_pad = torch.cat([y, y.new_zeros(G, 1, d)], dim=1).reshape(-1, d)
    rows = torch.nn.functional.embedding(  # the drop bin reads zeros
        dst + (EC + 1) * torch.arange(G, device=y.device)[:, None], y_pad)
    return (rows * gates[..., None]).reshape(G, T // G, K, d).sum(
        dim=2).reshape(T, d)


_recording = threading.local()


@contextlib.contextmanager
def record_routes():
    """While active, every :func:`moe_apply` / :func:`moe_apply_mp` call
    appends its routing terms ``(probs, top_e, keep)`` (those its aux reads)
    to the list this yields, in call order."""
    prev = getattr(_recording, "routes", None)
    _recording.routes = routes = []
    try:
        yield routes
    finally:
        _recording.routes = prev


def _record(probs, top_e, keep) -> None:
    routes = getattr(_recording, "routes", None)
    if routes is not None:
        routes.append((probs, top_e, keep))


def aux_of(routes: list, *, top_k: int, home) -> dict:
    """``moe_aux_loss`` and ``moe_drop_frac`` of one layer over the
    positions' routing terms (``routes[p]``, in position order), joined at
    ``home``."""
    probs, top_e, keep = (torch.cat([r[i].to(home) for r in routes])
                          for i in range(3))
    return _aux(probs, top_e, keep, T=probs.shape[0], K=top_k)


def _aux(probs, top_e, keep, *, T: int, K: int) -> dict:
    """The switch-style load-balance loss and the share of dispatch rows
    dropped (float32 0-d tensors)."""
    E = probs.shape[-1]
    frac = torch.bincount(top_e.reshape(-1), minlength=E).to(torch.float32) \
        / (T * K)
    mean_p = probs.mean(dim=0)
    aux_loss = E * torch.sum(frac * mean_p)
    # the mean as the reference computes it: the count times 1/n rounded
    # to float32 (a Python number: no host-to-device copy)
    inv_n = torch.tensor(1.0 / keep.numel(), dtype=torch.float32).item()
    dropped = 1.0 - keep.to(torch.float32).sum() * inv_n
    return {"moe_aux_loss": aux_loss, "moe_drop_frac": dropped}


def moe_apply(params: MoE, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, dispatch_groups: int = 1,
              dtype=DEFAULT_COMPUTE_DTYPE):
    """``x [T, d]`` -> ``(out [T, d]`` in ``dtype``, ``{"moe_aux_loss",
    "moe_drop_frac"}``): the switch-style load-balance loss and the share of
    dispatch rows dropped, float32 0-d tensors). ``params`` holds
    ``router``, ``gate``, ``up`` and ``down`` (a :class:`MoE`, or one
    layer's views of a stacked one)."""
    T, d = x.shape
    buf, dst, gates, keep, probs, top_e = _route(
        params, x, top_k=top_k, capacity_factor=capacity_factor,
        dispatch_groups=dispatch_groups, dtype=dtype)
    G, E, C, _ = buf.shape
    _record(probs, top_e, keep)
    y = _experts(buf, params.gate, params.up, params.down, dtype)
    out = _combine(y.reshape(G, E * C, d), dst, gates, T=T, K=top_k)
    return out, _aux(probs, top_e, keep, T=T, K=top_k)


def moe_apply_mp(params, x: torch.Tensor, *, top_k: int, home,
                 capacity_factor: float = 1.25, dispatch_groups: int = 1,
                 dtype=DEFAULT_COMPUTE_DTYPE):
    """:func:`moe_apply` over a ``model`` axis: ``x`` whole at ``home``;
    ``params.router`` a tensor there, ``gate`` / ``up`` / ``down``
    :class:`~repro_torch.distributed.tensor_parallel.Slices` split along
    the experts (``[E/k, d, f]``: expert parallelism) or along each
    expert's hidden units (``[E, d, f/k]`` and ``[E, f/k, d]``)."""
    from repro_torch.distributed.tensor_parallel import gather, reduce_sum

    T, d = x.shape
    buf, dst, gates, keep, probs, top_e = _route(
        params, x, top_k=top_k, capacity_factor=capacity_factor,
        dispatch_groups=dispatch_groups, dtype=dtype)
    G, E, C, _ = buf.shape
    _record(probs, top_e, keep)
    gate, up, down = params.gate, params.up, params.down
    if gate.dim == 0:  # expert parallel: each position its experts' rows
        ys, lo = [], 0
        for g, u, dn in zip(gate.parts, up.parts, down.parts):
            n = g.shape[0]
            ys.append(_experts(buf[:, lo:lo + n].to(g.device), g, u, dn,
                               dtype))
            lo += n
        y = gather(ys, 1, home)
    elif gate.dim == 2 and down.dim == 1:  # each expert's hidden units
        y = reduce_sum([
            _experts(buf.to(g.device), g, u, dn, dtype, round_out=False)
            for g, u, dn in zip(gate.parts, up.parts, down.parts)],
            home).to(dtype)
    else:
        raise ValueError(f"MoE leaves split along gate {gate.dim} / down "
                         f"{down.dim}: neither experts nor hidden units")
    out = _combine(y.reshape(G, E * C, d), dst, gates, T=T, K=top_k)
    return out, _aux(probs, top_e, keep, T=T, K=top_k)
