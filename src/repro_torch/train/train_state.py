"""Train state and the train-step factory.

The port of ``repro/train/train_state.py`` for one card. A state is a
dict: ``params`` (a model whose ``tree()`` gives its parameters under the
reference's paths, or a nested dict of tensors), ``opt`` (``m``, ``v``:
float32 moments per leaf; ``step``: int32) and, with gradient
compression, ``ef`` (the error feedback per leaf). ``train_step`` updates
the state in place and returns it (the reference returns a new one):
copy it (``copy.deepcopy``) to keep a step's input. The reference's ZeRO
hooks (``compute_cast``, ``grad_transform``) and ``jit_train_step`` place
state on a device mesh; one card has no counterpart (ROADMAP queue 1 item
13).
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch import nn

from repro_torch.tree import flatten

from .grad_compress import compress_grads_with_ef, init_ef_state
from .optimizer import OptimizerConfig, adamw_update, init_opt_state


def param_leaves(params) -> dict[str, torch.Tensor]:
    """The parameters keyed by path, in the reference's leaf order: a
    model's ``tree()``, or a nested dict of tensors."""
    return dict(flatten(params.tree() if isinstance(params, nn.Module)
                        else params))


def init_train_state(params, *, grad_compression: bool = False) -> dict:
    """The state of a run from ``params``, which from here on require
    grad."""
    leaves = param_leaves(params)
    for p in leaves.values():
        p.requires_grad_(True)
    state = {"params": params, "opt": init_opt_state(leaves)}
    if grad_compression:
        state["ef"] = init_ef_state(leaves)
    return state


def _split(batch: dict, microbatch: int) -> list[dict]:
    """The batch's ``microbatch`` parts along dim 0; a 1-D tensor whose
    length ``microbatch`` does not divide is a shared side input, given
    whole to every part (the reference's rule)."""
    shared = {}
    for k, x in batch.items():
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            raise ValueError(f"batch[{k!r}] ({type(x).__name__}) cannot be "
                             "split into microbatches")
        shared[k] = x.dim() == 1 and x.shape[0] % microbatch != 0
        if not shared[k] and x.shape[0] % microbatch:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             "microbatch")
    return [{k: x if shared[k] else x.reshape(
                microbatch, x.shape[0] // microbatch, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(microbatch)]


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig, *,
                    grad_compression: bool = False, microbatch: int = 1):
    """``loss_fn(params, batch) -> (loss, aux)``; returns
    ``train_step(state, batch) -> (state, metrics)``.

    ``microbatch > 1`` splits the batch's leading dim (:func:`_split`) and
    sums float32 gradients over the parts in order, then scales by
    1/``microbatch``, as the reference's scan does; loss and aux are
    averaged the same way."""

    def value_and_grad(params, leaves, batch):
        loss, aux = loss_fn(params, batch)
        gs = torch.autograd.grad(loss, list(leaves.values()),
                                 allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), gs)}
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def grads_of(params, leaves, batch):
        if microbatch <= 1:
            return value_and_grad(params, leaves, batch)
        gsum = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in leaves.items()}
        lsum = auxsum = None
        for part in _split(batch, microbatch):
            loss, aux, g = value_and_grad(params, leaves, part)
            gsum = {k: a + g[k].to(torch.float32) for k, a in gsum.items()}
            if lsum is None:
                lsum = torch.zeros((), dtype=torch.float32,
                                   device=loss.device)
                auxsum = {k: torch.zeros((), dtype=torch.float32,
                                         device=loss.device) for k in aux}
            lsum = lsum + loss
            auxsum = {k: a + aux[k] for k, a in auxsum.items()}
        inv = 1.0 / microbatch
        return (lsum * inv, {k: a * inv for k, a in auxsum.items()},
                {k: g * inv for k, g in gsum.items()})

    def train_step(state: dict, batch: Any) -> tuple[dict, dict]:
        leaves = param_leaves(state["params"])
        loss, aux, grads = grads_of(state["params"], leaves, batch)
        if grad_compression:
            grads, state["ef"] = compress_grads_with_ef(grads, state["ef"])
        _, state["opt"], opt_metrics = adamw_update(leaves, grads,
                                                    state["opt"], opt_cfg)
        return state, {"loss": loss, **opt_metrics, **aux}

    return train_step
