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

``plan="auto"`` (the default) is ``DecodePlan("cuda", fused=True)`` for
operands on the card: the kernels, whatever any cache holds. On the CPU
it consults the port's measured autotune cache,
``experiments/autotune_torch.json`` (``REPRO_TORCH_AUTOTUNE_CACHE``
overrides; :func:`autotune` writes it), keyed by format, epilogue, block
size and device (``cpu`` or the card's name, so an entry measured on a
card never picks a plan for CPU operands), and falls back to
``DecodePlan("torch", fused=True)``. On the card :func:`autotune` records
every candidate's time, but each entry's plan is the kernels. The port
never reads or writes the reference's ``experiments/autotune.json``.
``chunk`` and ``block_tile`` stay in the plan for API parity with the
reference; the CUDA core has one routing for every chunk width, so they
change nothing here.

**Sharded block-parallel decode.** Every block decodes independently
(per-block ``counts``/``bases`` carry all cross-block state), so a stream
whose block dimension is split over a mesh axis
(``CompressedIntArray.shard(mesh, axis="data")``: one
``repro_torch.distributed.BlockSharded`` a leaf) decodes where it lives:
:func:`decode` runs the single-device body :func:`_execute` once per
shard on the shard's device, issued back to back with no host sync, and
returns block-sharded outputs — bit-exact with the single-device path by
construction. Kernel 2's limits apply per shard. ``plan="sharded"``
forces the path (raises on unsharded operands); otherwise sharded
operands select it. The reference runs the same body under
``shard_map``; neither moves decode bytes between devices.

Telemetry (``repro_torch.obs``): every :func:`decode` call bumps
``decode_calls_total{plan, format, epilogue}`` once and runs inside one
``decode`` span (``format``, ``plan`` — the plan's :attr:`DecodePlan.label`
— ``epilogue``, ``blocks``, ``chunk``, ``sharded``), a call that kernel
2's limits split across launches, or a mesh across shards, included. The
span is the call's only record: the counter is added from it when the
registry is read (``obs.counted_trace``), the same counts as the
reference's bump per call. A call with ``plan="auto"`` on CPU operands
also counts ``plan_cache_total{result=hit|miss}`` once, folded into the
same record (a direct :func:`resolve_plan` call counts it itself, as the
reference's does); on the card no cache is read and none is counted. With nothing installed it costs one global read.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from repro_torch._device import resolve_device
from repro_torch.distributed.sharding import BlockSharded, Replicated
from repro_torch.obs import counted_trace as _obs_counted_trace
from repro_torch.obs import counter_inc as _obs_counter_inc

from . import epilogues as eplib
from .binpack_kernel import binpack_decode_blocked_cuda
from .kernel import vbyte_decode_blocked_cuda
from .ops import normalize_block_meta, normalize_counts_bases
from .ref import vbyte_decode_blocked_ref
from .stream_kernel import stream_decode_blocked_cuda

PATHS = ("cuda", "torch", "ref")
_DECODE_COUNT = ("decode_calls_total", ("plan", "format", "epilogue"))
# the same record with the auto plan's cache lookup: see counted_trace
_DECODE_COUNT_CACHE = {
    hit: (*_DECODE_COUNT, ("plan_cache_total",
                           {"result": "hit" if hit else "miss"}))
    for hit in (True, False)}


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
    """The kernels on the card, the torch decoder elsewhere: ``auto``'s
    plan on the card, and on the CPU where the cache has no entry."""
    return _DEFAULT_PLANS["cuda" if device.type == "cuda" else "torch"]


# ---------------------------------------------------------------------------
# the measured autotune cache
# ---------------------------------------------------------------------------
# <repo>/experiments/autotune_torch.json, resolved from this file (library
# call sites run from anywhere); cwd-relative outside the source tree
_SRC_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))))
DEFAULT_CACHE_PATH = (
    os.path.join(os.path.dirname(_SRC_DIR), "experiments",
                 "autotune_torch.json")
    if os.path.basename(_SRC_DIR) == "src"
    else os.path.join("experiments", "autotune_torch.json"))

# The reference's schema version: an entry of another version or none, or
# one whose plan names no path of the port (a reference entry: "jnp",
# "pallas"), is dropped on load and ``auto`` falls back to the default.
CACHE_SCHEMA = 2

_CACHE: dict | None = None
_CACHE_FILE: str | None = None
# auto's resolution of the loaded cache, (device, format, epilogue,
# block_size) -> (plan, hit): emptied whenever the cache is (re)loaded
_AUTO: dict = {}


def cache_path() -> str:
    return os.environ.get("REPRO_TORCH_AUTOTUNE_CACHE", DEFAULT_CACHE_PATH)


def device_name(device=None) -> str:
    """A cache key's device part: the card's name
    (``torch.cuda.get_device_name``), or the device type (``cpu``)."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else dev.type


def cache_key(format: str, epilogue: str, block_size: int,
              device=None) -> str:
    """``<device>/<format>/<epilogue>/bs<block_size>``; ``device``
    defaults to the card."""
    return f"{device_name(device)}/{format}/{epilogue}/bs{block_size}"


def _entry_plan(entry) -> DecodePlan | None:
    """An entry's plan, or ``None`` where it names none the port runs."""
    p = entry.get("plan") if isinstance(entry, dict) else None
    if not isinstance(p, dict):
        return None
    try:
        return DecodePlan(p["path"], bool(p["fused"]),
                          p.get("block_tile", 8), p.get("chunk"))
    except (KeyError, TypeError, ValueError):
        return None


def _migrate_cache(raw) -> dict:
    """Drop entries of another (or no) schema version, and junk."""
    if not isinstance(raw, dict):
        return {}
    return {k: v for k, v in raw.items()
            if isinstance(v, dict) and v.get("schema") == CACHE_SCHEMA
            and _entry_plan(v) is not None}


def load_cache(path: str | None = None, *, reload: bool = False) -> dict:
    """The cache at ``path`` (default :func:`cache_path`), read once and
    kept until another path or ``reload`` asks for a new read; a missing
    or unreadable file is an empty cache."""
    global _CACHE, _CACHE_FILE
    path = path or cache_path()
    if _CACHE is None or _CACHE_FILE != path or reload:
        _CACHE_FILE = path
        try:
            with open(path) as f:
                _CACHE = _migrate_cache(json.load(f))
        except (OSError, ValueError):
            _CACHE = {}
        _AUTO.clear()
    return _CACHE


def _auto_plan(device: torch.device, format: str, epilogue: str,
               block_size: int) -> tuple[DecodePlan, bool]:
    """``(plan, hit)``: the cache's measured plan for the workload, or
    :func:`default_plan` on a miss."""
    cache = load_cache()
    k = (device, format, epilogue, block_size)
    got = _AUTO.get(k)
    if got is None:
        plan = _entry_plan(cache.get(cache_key(format, epilogue, block_size,
                                               device)))
        got = _AUTO[k] = ((plan, True) if plan is not None
                          else (default_plan(device), False))
    return got


def _resolve(plan, *, format: str, epilogue: str, block_size: int,
             device: torch.device) -> tuple[DecodePlan, bool | None]:
    """``(plan, hit)``; ``hit`` is ``None`` unless the cache was read
    (``auto`` on CPU operands)."""
    if isinstance(plan, DecodePlan):
        return plan, None
    if plan in (None, "auto"):
        if device.type == "cuda":
            return _DEFAULT_PLANS["cuda"], None
        return _auto_plan(device, format, epilogue, block_size)
    if plan in ("cuda", "kernel"):
        return _DEFAULT_PLANS["cuda"], None
    if plan == "torch":
        return _DEFAULT_PLANS["torch"], None
    if plan == "ref":
        return DecodePlan("ref", fused=False), None
    if plan in ("fused", "unfused"):
        return DecodePlan(default_plan(device).path,
                          fused=plan == "fused"), None
    raise ValueError(
        f"unknown plan {plan!r}; expected a DecodePlan or one of "
        "'auto', 'cuda', 'kernel', 'torch', 'ref', 'fused', 'unfused'")


def resolve_plan(plan, *, format: str, epilogue: str, block_size: int,
                 device: torch.device) -> DecodePlan:
    """The concrete plan ``plan`` names for this workload on ``device``.
    ``"auto"`` (or ``None``) on the CPU reads the measured cache and
    counts ``plan_cache_total{result=hit|miss}``; on the card it is the
    kernels."""
    p, hit = _resolve(plan, format=format, epilogue=epilogue,
                      block_size=block_size, device=device)
    if hit is not None:
        _obs_counter_inc("plan_cache_total", result="hit" if hit else "miss")
    return p


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


def _normalize(operands: dict, format: str) -> dict:
    """One device's operands as the kernels take them: contiguous byte
    leaves, binpack's width column ``[n_blocks, 1]``, int32 ``[n_blocks]``
    counts and bases."""
    fmt_keys = eplib.FORMAT_OPERANDS[format]
    nb = operands[fmt_keys[0]].shape[0]
    counts, bases = normalize_counts_bases(operands["counts"],
                                           operands["bases"], nb)
    out = {k: operands[k].contiguous() for k in fmt_keys}
    if format == "binpack":  # the width column, as [n_blocks] or [n_blocks, 1]
        out["widths"] = normalize_block_meta(
            "widths", operands["widths"], nb).reshape(nb, 1)
    out.update(counts=counts, bases=bases)
    return out


def _execute(operands: dict, extras: dict, *, format: str, epilogue: str,
             block_size: int, differential: bool, plan: DecodePlan):
    """Run one resolved plan on one device's normalized operands.

    This is the single-device body; the sharded path runs exactly this
    function once per shard, which makes the sharded decode bit-exact with
    the single-device one by construction."""
    kw = dict(format=format, block_size=block_size, differential=differential)
    if epilogue == "stream":
        return _decode_grid(operands, plan=plan, **kw)
    if plan.fused and plan.path == "cuda":
        return _fused_within_limits(operands, extras, epilogue=epilogue,
                                    plan=plan, **kw)
    # torch fused (one torch pass on the device) or unfused: grid, then the
    # epilogue body
    grid = _decode_grid(operands, plan=plan, **kw)
    return eplib.apply_grid(epilogue, grid, operands["counts"], extras)


def operand_mesh_axes(operands: dict):
    """``(mesh, axes)`` when every operand is block-sharded on the same
    mesh and axes with more than one shard; ``None`` otherwise."""
    first = next(iter(operands.values()))
    if not isinstance(first, BlockSharded) or len(first.shards) < 2:
        return None
    if not all(first.same_layout(v) for v in operands.values()):
        return None
    return first.mesh, first.axes


def _run_sharded(operands: dict, extras: dict, *, epilogue: str, **kw):
    """:func:`_execute` once per shard on its own device, with no host sync
    between shards. Tiled extras (one row per block) are split by the same
    block ranges; replicated ones take the :class:`Replicated` copy of
    the shard's device, or one copy a distinct device made for this call.
    The outputs stay block-sharded: one ``BlockSharded`` (two for
    ``dot_score`` and ``checksum``)."""
    first = next(iter(operands.values()))
    n = len(first.shards)
    tiled = eplib.get_epilogue(epilogue).tiled_extras
    copies = {}

    def extra_for(k, v, i, dev):
        if isinstance(v, BlockSharded):
            if k not in tiled or not first.same_layout(v):
                raise ValueError(f"epilogue operand {k!r} is sharded unlike "
                                 "the compressed operands")
            return v.shards[i]
        if k in tiled:  # split a whole tensor by the shards' block ranges
            if v.shape[0] != first.shape[0]:
                raise ValueError(
                    f"tiled epilogue operand {k!r} has {v.shape[0]} rows; "
                    f"the sharded operands have {first.shape[0]} blocks")
            per = v.shape[0] // n
            return v[i * per:(i + 1) * per].to(dev)
        if isinstance(v, Replicated):
            return v.on(dev)
        if (k, dev) not in copies:
            copies[k, dev] = v if v.device == dev else v.to(dev)
        return copies[k, dev]

    outs = []
    for i in range(n):
        dev = first.shards[i].device
        ops = _normalize({k: v.shards[i] for k, v in operands.items()},
                         kw["format"])
        ex = {k: extra_for(k, v, i, dev) for k, v in extras.items()}
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            outs.append(_execute(ops, ex, epilogue=epilogue, **kw))
    mesh, axes = first.mesh, first.axes
    if isinstance(outs[0], tuple):
        return tuple(BlockSharded(mesh, axes, part) for part in zip(*outs))
    return BlockSharded(mesh, axes, tuple(outs))


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

    Block-sharded operands (``CompressedIntArray.shard``, more than one
    shard) run the resolved plan once per shard on the shard's device and
    return ``BlockSharded`` outputs. ``plan="sharded"`` forces that path
    (the default plan for the shards' device) and raises ``ValueError`` on
    unsharded operands.
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
    operands = {k: operands[k] for k in fmt_keys}
    mesh_axes = operand_mesh_axes(operands)
    if mesh_axes is None:
        if plan == "sharded":
            raise ValueError(
                "plan='sharded' requires operands whose block dimension is "
                "sharded over more than one shard of a mesh — use "
                "CompressedIntArray.shard(mesh, axis=...) first")
        if any(isinstance(v, BlockSharded) for v in operands.values()):
            raise ValueError("the compressed operands are sharded "
                             "inconsistently (mixed meshes, axes or shards)")
        operands = _normalize(operands, format)
    nb = operands[fmt_keys[0]].shape[0]
    p, hit = _resolve("auto" if plan == "sharded" else plan, format=format,
                      epilogue=epilogue, block_size=block_size,
                      device=operands["counts"].device)
    kw = dict(format=format, epilogue=epilogue, block_size=block_size,
              differential=differential, plan=p)

    # one record a call: the span is also decode_calls_total's increment,
    # and plan_cache_total's where the cache was read
    count = _DECODE_COUNT if hit is None else _DECODE_COUNT_CACHE[hit]
    with _obs_counted_trace("decode", count, format=format,
                            plan=p.label, epilogue=epilogue, blocks=int(nb),
                            chunk=p.chunk, sharded=mesh_axes is not None):
        if mesh_axes is not None:
            return _run_sharded(operands, extras, **kw)
        return _execute(operands, extras, **kw)


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


# ---------------------------------------------------------------------------
# measured autotune
# ---------------------------------------------------------------------------
def _time_call(fn, *, reps: int, warmup: int, device: torch.device) -> float:
    """Seconds a call by wall clock, the card synchronised after each call
    (the reference blocks on each call's result)."""
    sync = (torch.cuda.synchronize if device.type == "cuda"
            else (lambda: None))
    for _ in range(warmup):
        fn()
        sync()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        sync()
    return (time.perf_counter() - t0) / reps


def _synthetic_workload(format: str, *, n_blocks: int, block_size: int,
                        vocab: int, d: int, seed: int, device):
    """``(operands, extras by epilogue, bits_per_int)``: the reference's
    workload, its numpy draws in its order, encoded by the port's
    ``CompressedIntArray`` and placed on ``device``."""
    from repro_torch.core.compressed_array import CompressedIntArray

    dev = resolve_device(device)

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    rng = np.random.default_rng(seed)
    n = n_blocks * block_size
    values = np.sort(rng.integers(0, vocab, size=n)).astype(np.uint64)
    arr = CompressedIntArray.encode(values, format=format,
                                    block_size=block_size, differential=True,
                                    device=dev)
    operands = arr.device_operands()
    nb = arr.n_blocks
    probe = t(np.sort(rng.choice(vocab, size=min(128, vocab), replace=False))
              .astype(np.int32)[None, :])
    # aligned per-posting weight stream (quantized impacts): the main
    # array's block layout, non-differential, values < 2^8
    impacts = rng.integers(1, 256, size=n).astype(np.uint64)
    imp_arr = CompressedIntArray.encode(impacts, format=format,
                                        block_size=block_size,
                                        differential=False, device=dev)
    w_ops = {f"w_{k}": v for k, v in imp_arr.device_operands().items()
             if k in ("payload", "control", "data", "widths")}
    impact = torch.tensor([[7]], dtype=torch.int32, device=dev)
    extras = {
        "bag_sum": {"table": t(
            rng.standard_normal((vocab, d)).astype(np.float32))},
        "dot_score": {"table": t(
            rng.standard_normal((vocab, d)).astype(np.float32)),
            "query": t(rng.standard_normal((1, d)).astype(np.float32))},
        "adjacency_rebase": {"edge_base": t(
            rng.integers(0, vocab, (nb, block_size)).astype(np.int32))},
        "membership": {"probe": probe},
        "bm25_accum": {"probe": probe, "impact": impact},
        "membership_rows": {"probe": t(
            rng.integers(0, vocab, (nb, 1)).astype(np.int32))},
        "bm25_accum_rows": {"probe": t(
            rng.integers(0, vocab, (nb, 1)).astype(np.int32)),
            "impact": impact},
        "bm25_weighted": {"probe": probe, **w_ops},
        "bm25_weighted_rows": {"probe": t(
            rng.integers(0, vocab, (nb, 1)).astype(np.int32)), **w_ops},
        "stream": {},
        "checksum": {},
    }
    return operands, extras, arr.bits_per_int


def _candidates(format: str, epilogue: str, device: torch.device) -> list:
    """The plans :func:`autotune` times on ``device``, one program each,
    the default first. The torch decoder's fused and unfused forms run the
    same ops, so only the fused one is timed; with no consumer
    (``stream``) fused and unfused are one program for the kernels too,
    and ``ref`` joins for ``vbyte``. On the card the kernels are timed,
    kernel 2 and the decode kernel then torch ops; on the CPU they would
    time their plain versions, so they are left out. ``chunk`` and
    ``block_tile`` are no candidates: the CUDA core ignores them."""
    out = [DecodePlan("torch", True)]
    if epilogue == "stream" and format == "vbyte":
        out.append(DecodePlan("ref", False))
    if device.type != "cuda":
        return out
    cuda = [DecodePlan("cuda", True)]
    if epilogue != "stream":
        cuda.append(DecodePlan("cuda", False))
    return cuda + out


def autotune(
    *,
    formats=("vbyte", "streamvbyte", "binpack"),
    epilogue_names=("stream", "bag_sum", "dot_score", "adjacency_rebase",
                    "membership", "bm25_accum", "membership_rows",
                    "bm25_accum_rows", "bm25_weighted",
                    "bm25_weighted_rows", "checksum"),
    block_size: int = 128,
    n_blocks: int = 64,
    vocab: int = 4096,
    d: int = 64,
    reps: int = 5,
    warmup: int = 2,
    cache_file: str | None = None,
    seed: int = 0,
    device=None,
) -> dict:
    """Time the candidate plans of each (format, epilogue) on ``device``
    (default: the card) and persist them in the cache.

    Each entry keeps the reference's fields: ``schema``, ``plan``,
    ``candidates_ms`` (ms a call by label), ``device`` (the key's device
    part), ``workload`` and ``measured_at``. On the CPU ``plan`` is the
    fastest candidate, which ``auto`` then runs; on the card it is the
    kernels whatever the times (``auto`` there reads no cache), and
    ``candidates_ms`` is the record. The file is ``cache_file`` (default
    :func:`cache_path`); its other entries are kept. Returns the cache.
    """
    dev = resolve_device(device)
    cache_file = cache_file or cache_path()
    cache = dict(load_cache(cache_file))

    for fmt in formats:
        operands, extras_by_ep, bits = _synthetic_workload(
            fmt, n_blocks=n_blocks, block_size=block_size, vocab=vocab, d=d,
            seed=seed, device=dev)
        for ep_name in epilogue_names:
            candidates = _candidates(fmt, ep_name, dev)
            timings = {}
            for cand in candidates:
                fn = functools.partial(
                    decode, operands, format=fmt, block_size=block_size,
                    differential=True, epilogue=ep_name,
                    epilogue_operands=extras_by_ep[ep_name], plan=cand)
                timings[cand.label] = round(_time_call(
                    fn, reps=reps, warmup=warmup, device=dev) * 1e3, 4)
            best = (default_plan(dev) if dev.type == "cuda"
                    else min(candidates, key=lambda c: timings[c.label]))
            cache[cache_key(fmt, ep_name, block_size, dev)] = {
                "schema": CACHE_SCHEMA,
                "plan": asdict(best),
                "candidates_ms": timings,
                "device": device_name(dev),
                "workload": {"n_blocks": n_blocks, "block_size": block_size,
                             "vocab": vocab, "d": d,
                             "bits_per_int": round(bits, 2)},
                "measured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
            }

    os.makedirs(os.path.dirname(cache_file) or ".", exist_ok=True)
    with open(cache_file, "w") as f:
        json.dump(cache, f, indent=1, sort_keys=True)
    load_cache(cache_file, reload=True)
    return cache
