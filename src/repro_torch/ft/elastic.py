"""Elastic re-meshing (the port's copy of ``repro/ft/elastic.py``; plain
Python): recompute the mesh for a degraded chip count and plan
checkpoint resharding old-grid -> new-grid.

Recovery flow on real hardware: detector flags dead hosts -> coordinator
picks the largest usable chip count -> ``plan_mesh`` factorizes it ->
``reshard_plan`` maps every new shard to slices of checkpointed old shards ->
hosts restore only the bytes they own. Tested by simulation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def n_chips(self) -> int:
        return math.prod(self.shape)


def plan_mesh(n_chips: int, *, model_parallel: int = 16,
              multi_pod_size: int = 256) -> MeshPlan:
    """Largest (pod, data, model) factorization fitting n_chips.

    Keeps the model axis fixed (sharding-rule compatible) and shrinks
    data/pod: the elastic dimension is data parallelism, as in production
    systems — TP degree is baked into layout, DP is not.
    """
    if n_chips < model_parallel:
        raise ValueError(f"need at least {model_parallel} chips for TP")
    usable_data = n_chips // model_parallel
    if usable_data * model_parallel > multi_pod_size:
        pods = (usable_data * model_parallel) // multi_pod_size
        data = multi_pod_size // model_parallel
        return MeshPlan((pods, data, model_parallel), ("pod", "data", "model"))
    return MeshPlan((usable_data, model_parallel), ("data", "model"))


def shard_intervals(dim: int, parts: int) -> list[tuple[int, int]]:
    """GSPMD-style equal chunks (dim divisible or padded)."""
    chunk = -(-dim // parts)
    return [(i * chunk, min((i + 1) * chunk, dim)) for i in range(parts)]


def reshard_plan(dim: int, old_parts: int, new_parts: int) -> list[list[tuple[int, int, int]]]:
    """For each new shard: [(old_shard, old_lo, old_hi)] source slices.

    Offsets are relative to the old shard's local array. Coverage of the new
    shard is complete and non-overlapping (asserted in tests).
    """
    old = shard_intervals(dim, old_parts)
    plan = []
    for lo, hi in shard_intervals(dim, new_parts):
        srcs = []
        for s, (olo, ohi) in enumerate(old):
            a, b = max(lo, olo), min(hi, ohi)
            if a < b:
                srcs.append((s, a - olo, b - olo))
        plan.append(srcs)
    return plan
