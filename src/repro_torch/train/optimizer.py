"""AdamW + global-norm clipping + warm-up cosine schedule, from scratch.

The port of ``repro/train/optimizer.py``: float32 master weights and
moments, the update math in float32, clipping by the global norm of all
gradients, weight decay inside the step, every operation in the
reference's order so each rounds where the reference's does.
``torch.optim.AdamW`` clips nowhere and folds the decay in another order,
so it is not this function. Parameters and gradients are dicts of tensors
keyed by path (:func:`repro_torch.train.param_leaves`), in the
reference's leaf order. The update is in place (the reference returns new
arrays).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def lr_schedule(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up to ``peak_lr``, then cosine down to ``min_lr_frac``
    of it at ``total_steps``: a float32 0-d tensor."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.peak_lr * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: dict) -> dict:
    """Zero float32 moments ``m``, ``v`` per leaf and ``step`` 0 (int32)."""
    some = next(iter(params.values()), None)
    dev = some.device if some is not None else None
    return {"m": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()},
            "v": {k: torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: dict, whole=None) -> torch.Tensor:
    """√(Σ over leaves of Σ x²), in float32, leaf sums in dict order.
    ``whole(x)`` gives a leaf as one tensor (a sharded leaf gathered, one
    at a time), so each leaf's sum is the one its whole tensor gives."""
    sums = [torch.sum(torch.square(
        (x if whole is None else whole(x)).to(torch.float32)))
        for x in tree.values()]
    return torch.sqrt(torch.sum(torch.stack(sums)))


GROUP_ELEMS = 1 << 27  # leaves a multi-tensor group takes, in elements


def _groups(keys: list, params: dict) -> list[list]:
    """``keys`` in runs of at most ``GROUP_ELEMS`` elements (a larger leaf
    alone), so the update's float32 temporaries never outgrow a few
    copies of its largest group."""
    out, cur, n = [], [], 0
    for k in keys:
        size = params[k].numel()
        if cur and n + size > GROUP_ELEMS:
            out.append(cur)
            cur, n = [], 0
        cur.append(k)
        n += size
    return out + ([cur] if cur else [])


@torch.no_grad()
def adamw_update(params: dict, grads: dict, opt_state: dict,
                 cfg: OptimizerConfig, *, gnorm: torch.Tensor | None = None):
    """One AdamW step, in place on ``params`` and the moments: returns
    ``(params, opt_state, metrics)`` with ``opt_state["step"]`` advanced
    and ``metrics`` the global norm before clipping (``grad_norm``; given
    as ``gnorm`` where ``grads`` hold slices of the leaves) and the step's
    ``lr``. Multi-tensor (``torch._foreach_*``) over groups of
    leaves (:func:`_groups`): a few launches a group, each operation
    rounded where the reference's is (elementwise, so the grouping
    changes no bit), each temporary freed as soon as it is used."""
    step = opt_state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    for keys in _groups(list(params), params):
        m = [opt_state["m"][k] for k in keys]
        v = [opt_state["v"][k] for k in keys]
        g = torch._foreach_mul([grads[k].to(torch.float32) for k in keys],
                               scale)
        torch._foreach_mul_(m, b1)  # m = b1·m + (1 − b1)·g
        torch._foreach_add_(m, torch._foreach_mul(g, 1 - b1))
        sq = torch._foreach_mul(g, g)  # v = b2·v + (1 − b2)·g²
        del g
        torch._foreach_mul_(sq, 1 - b2)
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, sq)
        del sq
        denom = torch._foreach_div(v, bc2)  # √(v / bc2) + eps
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.eps)
        step_dir = torch._foreach_div(torch._foreach_div(m, bc1), denom)
        del denom
        pf = [params[k].to(torch.float32) for k in keys]
        upd = torch._foreach_mul(pf, cfg.weight_decay)  # lr·(dir + wd·p)
        torch._foreach_add_(upd, step_dir)
        del step_dir
        torch._foreach_mul_(upd, lr)
        torch._foreach_copy_([params[k] for k in keys],
                             torch._foreach_sub(pf, upd))
        del upd, pf
    opt_state["step"] = step
    return params, opt_state, {"grad_norm": gnorm, "lr": lr}
