"""The layer functions the two-tower and GIN models use.

The port of the parts of ``repro/nn/layers.py`` these models reach:
``dense``, ``embedding_lookup`` and ``mlp``, with their ``*_init``
functions drawing from the reference's distributions. Parameters are
stored float32 (the master copy) and cast to the compute dtype at use;
the compute dtype is bf16 by default. Initialisers take an explicit
``torch.Generator`` and draw on its device, so a full-width table is made
where it lives. (They give other numbers than ``jax.random`` from the
same seed: tests carry the reference's parameters across with
``repro_torch.convert`` instead.)

Layer norms, attention and the LM layers wait for the model stack
(ROADMAP queue 1 item 14).
"""
from __future__ import annotations

import math

import torch
from torch import nn

DEFAULT_COMPUTE_DTYPE = torch.bfloat16


def truncated_normal_init(shape, stddev: float, *, generator: torch.Generator,
                          dtype=torch.float32) -> torch.Tensor:
    """``stddev`` × a standard normal truncated to [-2, 2] (the reference's
    ``jax.random.truncated_normal(key, -2, 2)``, not rescaled), by inverse
    CDF sampling on the generator's device."""
    lo, hi = (math.erf(x / math.sqrt(2.0)) for x in (-2.0, 2.0))
    t = torch.empty(shape, dtype=dtype, device=generator.device)
    t.uniform_(lo, hi, generator=generator).erfinv_()
    return t.mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0).mul_(stddev)


def dense_init(in_dim: int, out_dim: int, *, generator: torch.Generator,
               stddev: float | None = None) -> torch.Tensor:
    """``w [in_dim, out_dim]``, stddev ``1/√in_dim`` unless given."""
    stddev = stddev if stddev is not None else 1.0 / math.sqrt(in_dim)
    return truncated_normal_init((in_dim, out_dim), stddev,
                                 generator=generator)


def dense(w: torch.Tensor, x: torch.Tensor, *,
          dtype=DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    return x.to(dtype) @ w.to(dtype)


def embedding_init(vocab: int, dim: int, *, generator: torch.Generator,
                   stddev: float = 0.02) -> torch.Tensor:
    return truncated_normal_init((vocab, dim), stddev, generator=generator)


def embedding_lookup(emb: torch.Tensor, ids: torch.Tensor, *,
                     dtype=DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    """``emb[ids]`` in ``dtype``. Gathers before it casts (the reference
    casts the whole table, then gathers): the same values, without a copy
    of a multi-GB table per call."""
    return emb[ids.to(torch.int64)].to(dtype)


def _param(t: torch.Tensor) -> nn.Parameter:
    # no gradients are tracked until a train state takes the parameters
    # (repro_torch.train.init_train_state)
    return nn.Parameter(t, requires_grad=False)


class MLP(nn.Module):
    """Plain MLP tower (recsys): layer i holds ``w [d_i, d_{i+1}]`` and a
    bias ``b [d_{i+1}]``, float32."""

    def __init__(self, weights: list[tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.w = nn.ParameterList([_param(w) for w, _ in weights])
        self.b = nn.ParameterList([_param(b) for _, b in weights])

    def forward(self, x, *, act=torch.relu, final_act: bool = False,
                dtype=DEFAULT_COMPUTE_DTYPE):
        return mlp(self, x, act=act, final_act=final_act, dtype=dtype)


def mlp_init(dims: tuple[int, ...], *, generator: torch.Generator) -> MLP:
    """``dims = (in, h1, ..., out)``; zero-initialised biases."""
    return MLP([(dense_init(a, b, generator=generator),
                 torch.zeros(b, device=generator.device))
                for a, b in zip(dims[:-1], dims[1:])])


def mlp(params: MLP, x, *, act=torch.relu, final_act: bool = False,
        dtype=DEFAULT_COMPUTE_DTYPE):
    n = len(params.w)
    for i in range(n):
        x = x.to(dtype) @ params.w[i].to(dtype) + params.b[i].to(dtype)
        if i < n - 1 or final_act:
            x = act(x)
    return x
