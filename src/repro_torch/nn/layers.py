"""The layer library: the port of ``repro/nn/layers.py``.

``dense``, ``embedding_lookup``, ``mlp``, ``layernorm``, ``rmsnorm`` and
``swiglu_ffn``, with their ``*_init`` functions drawing from the
reference's distributions. Parameters are stored float32 (the master
copy) and cast to the compute dtype at use; the compute dtype is bf16 by
default. Initialisers take an explicit ``torch.Generator`` and draw on
its device, so a full-width table is made where it lives. (They give
other numbers than ``jax.random`` from the same seed: tests carry the
reference's parameters across with ``repro_torch.convert`` instead.)

``accum_dtype()`` is float32 everywhere: the reference's TPU meaning (its
CPU fallback, ``None``, gives bf16 products there). Where the reference
asks ``preferred_element_type=accum_dtype()`` of bf16 operands, the port
widens the operands to float32 and multiplies in float32
(:func:`accum_matmul`): every product of two bf16 values is exact in
float32, and the sums are float32, as the TPU's are. (A bf16
``torch.matmul`` would round its result to bf16.)
"""
from __future__ import annotations

import math

import torch
from torch import nn

DEFAULT_COMPUTE_DTYPE = torch.bfloat16


def accum_dtype() -> torch.dtype:
    """The accumulation dtype of products of compute-dtype operands."""
    return torch.float32


def accum_matmul(equation: str, *operands) -> torch.Tensor:
    """``torch.einsum(equation, *operands)`` with float32 products and sums
    (``preferred_element_type=accum_dtype()``): the operands widened."""
    return torch.einsum(equation, *(x.to(accum_dtype()) for x in operands))


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
    of a multi-GB table per call. Through ``F.embedding``: its backward
    sums each row's gradients by sorted segments, split where a row
    repeats, so an id in every row of a batch (BERT4Rec's ``[MASK]``,
    ~2M times in 65,536 rows) is not one serial sum (advanced indexing's
    backward took 1.38 s of a 2.3 s step there), in the same order on
    every run."""
    return torch.nn.functional.embedding(ids.to(torch.int64), emb).to(dtype)


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

    def tree(self) -> dict:
        return {f"layer_{i}": {"w": w, "b": b}
                for i, (w, b) in enumerate(zip(self.w, self.b))}


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


class LayerNorm(nn.Module):
    """``scale`` (ones) and ``bias`` (zeros), float32 ``[dim]``."""

    def __init__(self, scale: torch.Tensor, bias: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)
        self.bias = _param(bias)

    def tree(self) -> dict:
        return {"scale": self.scale, "bias": self.bias}


def layernorm_init(dim: int, *, device=None) -> LayerNorm:
    return LayerNorm(torch.ones(dim, device=device),
                     torch.zeros(dim, device=device))


def layernorm(params: LayerNorm, x: torch.Tensor, *, eps: float = 1e-6,
              dtype=DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    """Normalised in float32 (population variance, ``eps`` 1e-6 as the
    reference's), scale and bias applied in float32, then cast."""
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = torch.square(xf - mean).mean(dim=-1, keepdim=True)
    normed = (xf - mean) * torch.rsqrt(var + eps)
    return (normed * params.scale + params.bias).to(dtype)


class RMSNorm(nn.Module):
    """``scale`` (ones), float32 ``[dim]``."""

    def __init__(self, scale: torch.Tensor):
        super().__init__()
        self.scale = _param(scale)

    def tree(self) -> dict:
        return {"scale": self.scale}


def rmsnorm_init(dim: int, *, device=None) -> RMSNorm:
    return RMSNorm(torch.ones(dim, device=device))


def rmsnorm(params: RMSNorm, x: torch.Tensor, *, eps: float = 1e-5,
            dtype=DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.square(xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * params.scale).to(dtype)


class SwiGLU(nn.Module):
    """``gate``, ``up`` ``[d_model, d_ff]`` and ``down`` ``[d_ff,
    d_model]``, float32."""

    def __init__(self, gate: torch.Tensor, up: torch.Tensor,
                 down: torch.Tensor):
        super().__init__()
        self.gate = _param(gate)
        self.up = _param(up)
        self.down = _param(down)

    def tree(self) -> dict:
        return {"gate": {"w": self.gate}, "up": {"w": self.up},
                "down": {"w": self.down}}


def swiglu_ffn_init(d_model: int, d_ff: int, *,
                    generator: torch.Generator) -> SwiGLU:
    return SwiGLU(dense_init(d_model, d_ff, generator=generator),
                  dense_init(d_model, d_ff, generator=generator),
                  dense_init(d_ff, d_model, generator=generator))


def swiglu_ffn(params: SwiGLU, x: torch.Tensor, *,
               dtype=DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    g = dense(params.gate, x, dtype=dtype)
    u = dense(params.up, x, dtype=dtype)
    return dense(params.down, torch.nn.functional.silu(g) * u, dtype=dtype)
