"""Dispatch for the blocked decode: one entry point, :func:`decode`.

A :class:`DecodePlan` names one concrete path:

* ``path="cuda"``  — the hand-written kernels: the format's decode kernel
  for the ``stream`` epilogue (kernel 1 ``vbyte``, kernel 3
  ``streamvbyte``, kernel 4 ``binpack``), kernel 2
  (``epilogues.fused_decode``, the same format's core) for every other
  epilogue when ``fused=True``. On CPU tensors the wrappers compute the
  same function with their plain versions.
* ``path="torch"`` — the format's vectorized torch-op decoder
  (``core.vbyte.masked``, ``stream_masked``, ``binpack_masked``) followed
  by the torch epilogue body, on whatever device the operands live.
* ``path="ref"``   — the gather-lowered vbyte decoder (``ref.py``),
  unfused; the other formats raise, as in the reference.
* ``fused=False``  — two steps: decode the int32 ``[n_blocks, B]`` grid,
  then apply the epilogue body to it (the decode kernel, then torch ops,
  on the card).

``plan="auto"`` (the default) resolves to ``DecodePlan("cuda", fused=True)``
for operands on the card and ``DecodePlan("torch", fused=True)`` on the
CPU. There is no measured autotune cache yet (ROADMAP queue 1 item 5).
``chunk`` and ``block_tile`` stay in the plan for API parity with the
reference; the CUDA core has one routing for every chunk width, so they
change nothing here.

Telemetry (``repro_torch.obs``): every :func:`decode` call bumps
``decode_calls_total{plan, format, epilogue}`` once and runs inside one
``decode`` span (``format``, ``plan`` — the plan's :attr:`DecodePlan.label`
— ``epilogue``, ``blocks``, ``chunk``, ``sharded``), a call that kernel
2's limits split across launches included. With nothing installed each
costs one global read.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from repro_torch.obs import counter_inc as _obs_counter_inc
from repro_torch.obs import trace as _obs_trace

from . import epilogues as eplib
from .binpack_kernel import binpack_decode_blocked_cuda
from .kernel import vbyte_decode_blocked_cuda
from .ops import normalize_block_meta, normalize_counts_bases
from .ref import vbyte_decode_blocked_ref
from .stream_kernel import stream_decode_blocked_cuda

PATHS = ("cuda", "torch", "ref")


@dataclass(frozen=True)
class DecodePlan:
    """One concrete decode execution plan (see module docstring)."""

    path: str  # "cuda" | "torch" | "ref"
    fused: bool = True
    block_tile: int = 8
    chunk: int | None = None

    def __post_init__(self):
        if self.path not in PATHS:
            raise ValueError(f"unknown plan path {self.path!r}")
        if self.chunk is not None and (self.chunk <= 0 or self.chunk % 8):
            raise ValueError(
                f"plan chunk width must be a positive multiple of 8 or "
                f"None; got {self.chunk!r}")

    @functools.cached_property
    def label(self) -> str:
        """The plan's name in metrics and spans, in the reference's form:
        ``cuda_fused``, ``torch_unfused``, ``..._w<chunk>``."""
        return f"{self.path}{'_fused' if self.fused else '_unfused'}" \
               + (f"_w{self.chunk}" if self.chunk is not None else "")


# the named plans, one object each: every decode call names its plan in
# a counter and a span, and the label is worked out once per object
_DEFAULT_PLANS = {"cuda": DecodePlan("cuda", fused=True),
                  "torch": DecodePlan("torch", fused=True)}


def default_plan(device: torch.device) -> DecodePlan:
    """The kernels on the card, the torch decoder elsewhere."""
    return _DEFAULT_PLANS["cuda" if device.type == "cuda" else "torch"]


def resolve_plan(plan, *, device: torch.device) -> DecodePlan:
    if isinstance(plan, DecodePlan):
        return plan
    if plan in (None, "auto"):
        return default_plan(device)
    if plan in ("cuda", "kernel"):
        return _DEFAULT_PLANS["cuda"]
    if plan == "torch":
        return _DEFAULT_PLANS["torch"]
    if plan == "ref":
        return DecodePlan("ref", fused=False)
    if plan in ("fused", "unfused"):
        return DecodePlan(default_plan(device).path, fused=plan == "fused")
    raise ValueError(
        f"unknown plan {plan!r}; expected a DecodePlan or one of "
        "'auto', 'cuda', 'kernel', 'torch', 'ref', 'fused', 'unfused'")


CUDA_DECODERS = {"vbyte": vbyte_decode_blocked_cuda,
                 "streamvbyte": stream_decode_blocked_cuda,
                 "binpack": binpack_decode_blocked_cuda}


def _decode_grid(operands: dict, *, format: str, block_size: int,
                 differential: bool, plan: DecodePlan) -> torch.Tensor:
    """Step-1 decode to the int32 (uint32 bits) [n_blocks, block_size] grid."""
    if plan.path == "ref":
        if format != "vbyte":
            raise ValueError(
                "plan path 'ref' (the gather-lowered decoder) only exists "
                f"for format='vbyte'; got {format!r} — stream_masked is "
                "already gather-based, use path 'torch'")
        dec = vbyte_decode_blocked_ref
    elif plan.path == "cuda":
        dec = CUDA_DECODERS[format]
    else:
        dec = eplib.PLAIN_DECODERS[format]
    leaves = [operands[k] for k in eplib.FORMAT_OPERANDS[format]]
    return dec(*leaves, operands["counts"], operands["bases"],
               block_size=block_size, differential=differential)


def decode(
    operands,  # CompressedIntArray, or device_operands()-style dict
    *,
    format: str | None = None,
    block_size: int | None = None,
    differential: bool | None = None,
    epilogue: str = "stream",
    epilogue_operands: dict | None = None,
    plan: DecodePlan | str | None = "auto",
):
    """Decode a blocked compressed stream, optionally fused into a consumer.

    ``operands`` is either a ``CompressedIntArray`` (format/block_size/
    differential come from it) or the raw operand dict (``payload`` |
    ``control``/``data`` | ``widths``/``data``, + ``counts``/``bases``), in
    which case the three metadata kwargs are required. Returns the
    epilogue's output: the int32 (uint32 bits) ``[n_blocks, block_size]``
    grid for ``epilogue="stream"`` and ``"adjacency_rebase"``, the
    ``(grid, checksum column)`` pair for ``"checksum"``, ``[n_blocks, P]``
    or ``[n_blocks, 1]`` for the probe epilogues, ``[n_blocks, d]`` in the
    table's dtype for ``"bag_sum"`` and the ``(ids, float32 scores)`` pair
    for ``"dot_score"``. Every plan returns the same structure. Results
    stay on the operands' device; nothing here synchronises.
    """
    from repro_torch.core.compressed_array import CompressedIntArray

    if isinstance(operands, CompressedIntArray):
        arr = operands
        operands = arr.device_operands()
        format = arr.format if format is None else format
        block_size = arr.block_size if block_size is None else block_size
        differential = (arr.differential if differential is None
                        else differential)
    if format is None or block_size is None or differential is None:
        raise ValueError(
            "format=/block_size=/differential= are required when operands "
            "are a raw dict (pass a CompressedIntArray to omit them)")
    if format not in eplib.FORMAT_OPERANDS:
        raise ValueError(f"unknown format {format!r}; expected one of "
                         f"{tuple(eplib.FORMAT_OPERANDS)}")
    ep = eplib.get_epilogue(epilogue)
    extras = dict(epilogue_operands or {})
    ep.check(differential, extras)

    fmt_keys = eplib.FORMAT_OPERANDS[format] + ("counts", "bases")
    missing = [k for k in fmt_keys if k not in operands]
    if missing:
        raise ValueError(f"format {format!r} operands missing {missing}")
    nb = operands[fmt_keys[0]].shape[0]
    counts, bases = normalize_counts_bases(operands["counts"],
                                           operands["bases"], nb)
    operands = {k: operands[k].contiguous() for k in fmt_keys[:-2]}
    if format == "binpack":  # the width column, as [n_blocks] or [n_blocks, 1]
        operands["widths"] = normalize_block_meta(
            "widths", operands["widths"], nb).reshape(nb, 1)
    operands.update(counts=counts, bases=bases)
    p = resolve_plan(plan, device=counts.device)
    kw = dict(format=format, block_size=block_size, differential=differential)

    _obs_counter_inc("decode_calls_total", plan=p.label, format=format,
                     epilogue=epilogue)
    with _obs_trace("decode", format=format, plan=p.label, epilogue=epilogue,
                    blocks=int(nb), chunk=p.chunk, sharded=False):
        if epilogue == "stream":
            return _decode_grid(operands, plan=p, **kw)
        if p.fused and p.path == "cuda":
            return _fused_within_limits(operands, extras, epilogue=epilogue,
                                        plan=p, **kw)
        # torch fused (one torch pass on the device) or unfused: grid, then
        # the epilogue body
        grid = _decode_grid(operands, plan=p, **kw)
        return eplib.apply_grid(epilogue, grid, operands["counts"], extras)


def _query_elems(table: torch.Tensor, d: int) -> int:
    """A dot_score query row's elements in kernel 2's shared memory: ``d``
    rounded up to whole 16-byte chunks of the table's type."""
    chunk = 8 if table.dtype == torch.bfloat16 else 4
    return -(-d // chunk) * chunk


def _fused_within_limits(operands: dict, extras: dict, *, epilogue: str,
                         plan: DecodePlan, format: str, block_size: int,
                         differential: bool):
    """Kernel 2 for every input the reference serves. Kernel 2 holds a
    broadcast probe set of at most ``MAX_PROBE_WIDTH`` and a ``dot_score``
    query of at most ``MAX_QUERY_ELEMS`` in shared memory; past those the
    work is split across launches, chosen from the shapes alone:

    * broadcast probes: contiguous column slices of the probe set (each
      still sorted), outputs concatenated along the probe axis — every
      output column depends on its own probe only;
    * ``dot_score``: groups of query rows that fit, ids taken from the
      first launch and the f32 scores stacked along the query axis;
    * a single query row too wide for the kernel: the unfused plan (the
      format's decode kernel, then the torch body), as the reference does
      past its VMEM budget.
    """
    kw = dict(format=format, block_size=block_size, differential=differential)
    ep = eplib.get_epilogue(epilogue)
    probe = extras.get("probe")
    if (probe is not None and "probe" not in ep.tiled_extras
            and probe.shape[-1] > eplib.MAX_PROBE_WIDTH):
        W = eplib.MAX_PROBE_WIDTH
        probe = probe.reshape(1, -1)
        return torch.cat([
            eplib.fused_decode(operands, {**extras,
                                          "probe": probe[:, s:s + W]
                                          .contiguous()},
                               epilogue=epilogue, **kw)
            for s in range(0, probe.shape[-1], W)], dim=1)
    if epilogue == "dot_score":
        table, query = extras["table"], extras["query"]
        d = query.shape[-1]
        rows = query.reshape(-1, d)
        per_row = _query_elems(table, d)
        if per_row > eplib.MAX_QUERY_ELEMS:
            grid = _decode_grid(operands, plan=plan, **kw)
            return eplib.apply_grid(epilogue, grid, operands["counts"],
                                    extras)
        fit = eplib.MAX_QUERY_ELEMS // per_row
        if rows.shape[0] > fit:
            outs = [eplib.fused_decode(operands,
                                       {"table": table,
                                        "query": rows[s:s + fit]},
                                       epilogue=epilogue, **kw)
                    for s in range(0, rows.shape[0], fit)]
            scores = [s if s.dim() == 3 else s[..., None] for _, s in outs]
            return outs[0][0], torch.cat(scores, dim=2)
    return eplib.fused_decode(operands, extras, epilogue=epilogue, **kw)
