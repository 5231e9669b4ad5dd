"""Fused decode→consume epilogues, and kernel 2 (``csrc/fused_decode.cu``).

The port of ``repro/kernels/vbyte_decode/epilogues.py``. An
:class:`Epilogue` is a function over the decode contract

    ``(vals int32 [T, B] (uint32 bits), valid bool [T, B], **extras) -> out``

Its torch ``apply`` body, run on a whole decoded grid by :func:`apply_grid`,
is the plain version of the fused kernel: :func:`fused_decode` launches the
CUDA kernel for operands on the card and runs decode + ``apply`` for
operands on the CPU. All 11 of the reference's epilogues are ported:

* ``stream``     — the decoded integers;
* ``checksum``   — the integers plus ``cs[t] = Σ_j vals[t,j]·(2j+1) mod 2^32``;
* ``membership`` — ``[T, P]`` hit bitmap against a sorted probe set padded
  with -1; ``bm25_accum`` multiplies it by the term's int32 impact;
* ``bm25_weighted`` — ``Σ_j hit·w`` where ``w`` is the aligned per-posting
  impact stream, decoded in the same pass with the main tile's counts. Its
  format is picked by which operands arrive, in the reference's order:
  ``w_widths`` + ``w_data`` (binpack), ``w_payload`` (vbyte), ``w_control``
  + ``w_data`` (streamvbyte);
* ``*_rows`` — the block-aligned variants: ``probe`` is a tiled
  ``[T, 1]`` extra, block t compared against its own probe only;
* ``bag_sum``    — ``[T, d]`` Σ over valid slots of ``table[clip(id)]``,
  in the table's dtype (the embedding-bag consumer);
* ``dot_score``  — ``(ids [T, B], scores)``: ``ids`` are the decoded
  values (0 in pad slots) and ``scores`` f32 ``table[clip(id)] · query``,
  ``[T, B]`` for a one-row query, ``[T, B, nq]`` otherwise. Pad slots
  score row 0 (the retrieval consumer masks id 0);
* ``adjacency_rebase`` — differential only: ``vals − edge_base`` mod 2^32
  per slot, 0 in pad slots (the GNN consumer's per-edge list rebase).

Masked slots compare as -1 and only probes ``>= 0`` count. Sums wrap mod
2^32 exactly like the reference's int32 arithmetic. The main stream may be
any of the three formats (the kernel's decode core is a template
parameter).

The float epilogues gather with ``mode="clip"`` (ids clamped to
``[0, V-1]``) and sum in float32, rounded once to the result dtype:
the table's for ``bag_sum``, the promoted type of table and query for
``dot_score`` (bf16 only when both are bf16), then cast to float32. That
is what the reference's bf16 ``sum`` and ``einsum`` compute on the CPU.
The kernel sums in another order than these plain versions, so the two
agree within one bf16 ulp (bf16) or float32 rounding (f32), not bit for
bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.vbyte import binpack_masked, masked, stream_masked
from repro_torch.core.vbyte.masked import to_i32_bits, to_u32

from . import binpack_kernel, kernel, stream_kernel
from ._build import LaunchCounter, library
from .ops import normalize_counts_bases

FORMAT_OPERANDS = {
    "vbyte": ("payload",),
    "streamvbyte": ("control", "data"),
    "binpack": ("widths", "data"),
}
# per format: the plain decoder, the kernel's operand check, and the id of
# the format in csrc/fused_decode.cu
PLAIN_DECODERS = {"vbyte": masked.decode_blocked,
                  "streamvbyte": stream_masked.decode_blocked,
                  "binpack": binpack_masked.decode_blocked}
CHECK_OPERANDS = {"vbyte": kernel.check_operands,
                  "streamvbyte": stream_kernel.check_operands,
                  "binpack": binpack_kernel.check_operands}
FORMAT_IDS = {"vbyte": 0, "streamvbyte": 1, "binpack": 2}
WEIGHT_OPERANDS = ("w_payload", "w_control", "w_data", "w_widths")
MAX_PROBE_WIDTH = 4096  # broadcast probe set held in shared memory per CTA
MAX_QUERY_ELEMS = 8192  # dot_score's f32 query matrix in shared memory per CTA
TABLE_DTYPES = (torch.float32, torch.bfloat16)

launches = LaunchCounter()

# broadcast epilogues compare [rows, B, P]; chunk rows to bound the memory
_CHUNK_ELEMS = 1 << 24


# ---------------------------------------------------------------------------
# epilogue bodies — torch ops on the decode contract (the plain versions)
# ---------------------------------------------------------------------------
def _stream_apply(vals, valid):
    return vals


def _gather_rows(table, ids):
    """``table[clip(ids)]``: the reference's ``take(..., mode="clip")``."""
    idx = ids.reshape(-1).clamp(0, table.shape[0] - 1).to(torch.int64)
    return table.index_select(0, idx).reshape(*ids.shape, table.shape[1])


def _bag_sum_apply(vals, valid, *, table):
    vecs = _gather_rows(table, torch.where(valid, vals, 0)).float()
    vecs = vecs.masked_fill_(~valid[:, :, None], 0)  # masked slots add 0
    return vecs.sum(dim=1).to(table.dtype)  # [T, d]


def _dot_score_apply(vals, valid, *, table, query):
    T, B = vals.shape
    ids = torch.where(valid, vals, 0)  # pad slots score id 0 (the pad row)
    q = query.reshape(-1, query.shape[-1])  # [n_queries, d]
    vecs = _gather_rows(table, ids).reshape(T * B, -1)
    scores = vecs.float() @ q.float().T  # [T·B, n_queries], f32 sums
    scores = scores.to(torch.promote_types(table.dtype, query.dtype)).float()
    if q.shape[0] == 1:  # single query: scores [T, B]
        return ids, scores.reshape(T, B)
    return ids, scores.reshape(T, B, q.shape[0])  # [T, B, n_queries]


def _adjacency_rebase_apply(vals, valid, *, edge_base):
    # uint32 wrap-around subtraction, as the reference's int32 one
    return torch.where(valid, to_i32_bits(vals.to(torch.int64)
                                          - edge_base.to(torch.int64)), 0)


def _checksum_apply(vals, valid):
    # cs[t] = Σ_j valid · vals[t,j] · (2j+1)  (mod 2^32): products < 2^40,
    # so the int64 row sum is exact before the final wrap
    B = vals.shape[-1]
    w = 2 * torch.arange(B, device=vals.device, dtype=torch.int64) + 1
    cs = torch.where(valid, to_u32(vals) * w, 0).sum(dim=1)
    return vals, to_i32_bits(cs)[:, None]


def _probe_hits(vals, valid, probe):
    """Yield ``(row slice, hit bool [rows, B, P])`` in row chunks."""
    p = probe.reshape(-1)
    v = torch.where(valid, vals, -1)  # masked slots never match
    T, B = vals.shape
    step = max(1, _CHUNK_ELEMS // max(B * p.numel(), 1))
    for s in range(0, T, step):
        hit = (v[s:s + step, :, None] == p[None, None, :]) & (p >= 0)
        yield slice(s, s + step), hit


def _membership_apply(vals, valid, *, probe):
    out = torch.zeros((vals.shape[0], probe.numel()), dtype=torch.int32,
                      device=vals.device)
    for rows, hit in _probe_hits(vals, valid, probe):
        out[rows] = hit.any(dim=1).to(torch.int32)
    return out  # [T, P] match bitmap


def _bm25_accum_apply(vals, valid, *, probe, impact):
    # a docid lives in at most one block, so summing the [n_blocks, P]
    # output over blocks accumulates each candidate's exact int32 score
    return _membership_apply(vals, valid, probe=probe) * impact.reshape(())


def _membership_rows_apply(vals, valid, *, probe):
    v = torch.where(valid, vals, -1)
    hit = (v == probe) & (probe >= 0)  # [T, B], probe [T, 1] broadcasts
    return hit.any(dim=1, keepdim=True).to(torch.int32)  # [T, 1]


def _bm25_accum_rows_apply(vals, valid, *, probe, impact):
    return _membership_rows_apply(vals, valid, probe=probe) * impact.reshape(())


def weight_format(w_payload=None, w_control=None, w_data=None,
                  w_widths=None) -> tuple[str, tuple]:
    """``(format, leaves)`` of the aligned weight stream, picked by which
    operands arrived, in the reference's order: binpack, vbyte,
    streamvbyte."""
    if w_widths is not None and w_data is not None:
        return "binpack", (w_widths, w_data)
    if w_payload is not None:
        return "vbyte", (w_payload,)
    if w_control is not None and w_data is not None:
        return "streamvbyte", (w_control, w_data)
    raise ValueError("weighted epilogue needs w_payload (vbyte), "
                     "w_control + w_data (streamvbyte), or "
                     "w_widths + w_data (binpack) extras")


def _decode_weight_tile(valid, **weights):
    """Decode the aligned per-posting weight tile (dense, non-differential).
    Its blocks align 1:1 with the main stream, so the main tile's ``valid``
    mask is the weight tile's count vector."""
    fmt, leaves = weight_format(**weights)
    counts = valid.sum(dim=1).to(torch.int32)
    w = PLAIN_DECODERS[fmt](*leaves, counts, torch.zeros_like(counts),
                            block_size=valid.shape[-1], differential=False)
    return torch.where(valid, w, 0)


def _bm25_weighted_apply(vals, valid, *, probe, **weights):
    w = to_u32(_decode_weight_tile(valid, **weights))
    out = torch.zeros((vals.shape[0], probe.numel()), dtype=torch.int32,
                      device=vals.device)
    for rows, hit in _probe_hits(vals, valid, probe):
        out[rows] = to_i32_bits((hit * w[rows, :, None]).sum(dim=1))
    return out  # [T, P]


def _bm25_weighted_rows_apply(vals, valid, *, probe, **weights):
    w = to_u32(_decode_weight_tile(valid, **weights))
    v = torch.where(valid, vals, -1)
    hit = (v == probe) & (probe >= 0)  # [T, B]
    return to_i32_bits((hit * w).sum(dim=1, keepdim=True))  # [T, 1]


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class Epilogue:
    """One fused decode→consume epilogue (see module docstring)."""

    name: str
    apply: Callable[..., Any]
    cuda_id: int  # the epilogue's template id in csrc/fused_decode.cu
    extras: tuple[str, ...] = ()
    optional_extras: tuple[str, ...] = ()  # format-tagged weight operands
    tiled_extras: tuple[str, ...] = ()  # extras with one row per block
    requires_differential: bool | None = None  # None = either

    def check_extras(self, extras: dict) -> None:
        missing = [k for k in self.extras if k not in extras]
        allowed = set(self.extras) | set(self.optional_extras)
        extra = [k for k in extras if k not in allowed]
        if missing or extra:
            raise ValueError(
                f"epilogue {self.name!r} takes operands {self.extras} "
                f"(+ optional {self.optional_extras}); "
                f"missing {missing}, unexpected {extra}")

    def check(self, differential: bool, extras: dict) -> None:
        self.check_extras(extras)
        if (self.requires_differential is not None
                and differential != self.requires_differential):
            raise ValueError(
                f"epilogue {self.name!r} requires "
                f"differential={self.requires_differential}")


EPILOGUES = {
    "stream": Epilogue("stream", _stream_apply, 0),
    "checksum": Epilogue("checksum", _checksum_apply, 1),
    "membership": Epilogue("membership", _membership_apply, 2,
                           extras=("probe",)),
    "membership_rows": Epilogue("membership_rows", _membership_rows_apply, 3,
                                extras=("probe",), tiled_extras=("probe",)),
    "bm25_accum": Epilogue("bm25_accum", _bm25_accum_apply, 4,
                           extras=("probe", "impact")),
    "bm25_accum_rows": Epilogue("bm25_accum_rows", _bm25_accum_rows_apply, 5,
                                extras=("probe", "impact"),
                                tiled_extras=("probe",)),
    "bm25_weighted": Epilogue("bm25_weighted", _bm25_weighted_apply, 6,
                              extras=("probe",),
                              optional_extras=WEIGHT_OPERANDS,
                              tiled_extras=WEIGHT_OPERANDS),
    "bm25_weighted_rows": Epilogue("bm25_weighted_rows",
                                   _bm25_weighted_rows_apply, 7,
                                   extras=("probe",),
                                   optional_extras=WEIGHT_OPERANDS,
                                   tiled_extras=("probe",) + WEIGHT_OPERANDS),
    "bag_sum": Epilogue("bag_sum", _bag_sum_apply, 8, extras=("table",)),
    "dot_score": Epilogue("dot_score", _dot_score_apply, 9,
                          extras=("table", "query")),
    "adjacency_rebase": Epilogue("adjacency_rebase", _adjacency_rebase_apply,
                                 10, extras=("edge_base",),
                                 tiled_extras=("edge_base",),
                                 requires_differential=True),
}


def get_epilogue(name: str) -> Epilogue:
    if name not in EPILOGUES:
        raise ValueError(f"unknown epilogue {name!r}; "
                         f"expected one of {tuple(EPILOGUES)}")
    return EPILOGUES[name]


# ---------------------------------------------------------------------------
# grid path: the plain version (and the second step of an unfused plan)
# ---------------------------------------------------------------------------
def apply_grid(epilogue: str, grid: torch.Tensor, counts: torch.Tensor,
               extras: dict | None = None):
    """Apply an epilogue to an already-decoded int32 ``[n_blocks, B]`` grid
    (uint32 bits) — the decode→consume reference the fused kernel matches."""
    ep = get_epilogue(epilogue)
    extras = extras or {}
    ep.check_extras(extras)
    B = grid.shape[1]
    valid = (torch.arange(B, device=grid.device)[None, :]
             < counts.reshape(-1, 1).to(torch.int64))
    return ep.apply(grid, valid, **extras)


def fused_decode_plain(operands: dict, extras: dict, *, format: str,
                       epilogue: str, block_size: int, differential: bool):
    """The plain version of kernel 2: the format's torch decoder, then the
    epilogue's ``apply`` body. ``operands`` holds the format's leaves and
    1-D int32 ``counts``/``bases``."""
    leaves = [operands[k] for k in FORMAT_OPERANDS[format]]
    grid = PLAIN_DECODERS[format](*leaves, operands["counts"],
                                  operands["bases"], block_size=block_size,
                                  differential=differential)
    return apply_grid(epilogue, grid, operands["counts"], extras)


# ---------------------------------------------------------------------------
# kernel 2: the CUDA launch
# ---------------------------------------------------------------------------
def _check_i32(name, t, shape, device):
    if (t.dtype != torch.int32 or tuple(t.shape) != shape
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 {list(shape)} "
                         f"tensor on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _fused_decode_cuda(format: str, ops: dict, extras: dict, *,
                       ep: Epilogue, block_size: int, differential: bool):
    leaves = [ops[k] for k in FORMAT_OPERANDS[format]]
    main = leaves[-1]  # payload or data
    meta = leaves[0] if len(leaves) == 2 else None  # control or widths
    counts, bases = ops["counts"], ops["bases"]
    dev = main.device
    nb, S = main.shape
    B = block_size
    probe = extras.get("probe")
    P = 1
    if probe is not None:
        if "probe" in ep.tiled_extras:
            _check_i32("probe", probe, (nb, 1), dev)
        else:
            P = probe.shape[-1]
            if not 1 <= P <= MAX_PROBE_WIDTH:
                raise ValueError(f"broadcast probe width must be in "
                                 f"[1, {MAX_PROBE_WIDTH}], got {P}")
            _check_i32("probe", probe, (1, P), dev)
    impact = extras.get("impact")
    if impact is not None:
        _check_i32("impact", impact, (1, 1), dev)
    w_format, w_bytes, w_meta, S_w = 0, None, None, 1
    if ep.name.startswith("bm25_weighted"):
        fmt, w_leaves = weight_format(
            **{k: extras.get(k) for k in WEIGHT_OPERANDS})
        CHECK_OPERANDS[fmt](*w_leaves, counts, bases, block_size=B)
        w_format, w_bytes = FORMAT_IDS[fmt], w_leaves[-1]
        w_meta = w_leaves[0] if len(w_leaves) == 2 else None
        S_w = w_bytes.shape[1]

    table, query, edge_base = (extras.get(k) for k in
                               ("table", "query", "edge_base"))
    V = d = nq = round_bf16 = 0
    if table is not None:
        if (table.dtype not in TABLE_DTYPES or table.dim() != 2
                or table.device != dev or not table.is_contiguous()
                or min(table.shape) < 1):
            raise ValueError(f"table must be a contiguous float32 or "
                             f"bfloat16 [V ≥ 1, d ≥ 1] tensor on {dev}; got "
                             f"{table.dtype} {tuple(table.shape)} on "
                             f"{table.device}")
        V, d = table.shape
    if query is not None:
        if (query.dtype not in TABLE_DTYPES or query.shape[-1] != d
                or query.device != dev):
            raise ValueError(f"query must be float32 or bfloat16 [..., {d}] "
                             f"on {dev}; got {query.dtype} "
                             f"{tuple(query.shape)} on {query.device}")
        round_bf16 = int(torch.promote_types(table.dtype, query.dtype)
                         == torch.bfloat16)
        query = query.reshape(-1, d).to(torch.float32).contiguous()
        nq = query.shape[0]
        chunk = 8 if table.dtype == torch.bfloat16 else 4  # 16-byte chunks
        if not 1 <= nq * (-(-d // chunk) * chunk) <= MAX_QUERY_ELEMS:
            raise ValueError(f"query rows × d (rounded up to a multiple of "
                             f"{chunk}) must be in [1, {MAX_QUERY_ELEMS}], "
                             f"got {nq} × {d}")
    if edge_base is not None:
        _check_i32("edge_base", edge_base, (nb, B), dev)

    out = out2 = fout = None
    if ep.name == "bag_sum":
        fout = torch.empty((nb, d), dtype=table.dtype, device=dev)
    elif ep.name == "dot_score":
        out = torch.empty((nb, B), dtype=torch.int32, device=dev)
        fout = torch.empty((nb, B) if nq == 1 else (nb, B, nq),
                           dtype=torch.float32, device=dev)
    elif ep.name in ("stream", "checksum", "adjacency_rebase"):
        out = torch.empty((nb, B), dtype=torch.int32, device=dev)
    elif "probe" in ep.tiled_extras:
        out = torch.empty((nb, 1), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((nb, P), dtype=torch.int32, device=dev)
    if ep.name == "checksum":
        out2 = torch.empty((nb, 1), dtype=torch.int32, device=dev)
    if nb:
        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            library("fused_decode").call(
                "fused_decode_launch", FORMAT_IDS[format], ep.cuda_id,
                main.data_ptr(), ptr(meta), S, counts.data_ptr(),
                bases.data_ptr(), nb, B, int(differential), ptr(probe), P,
                ptr(impact), w_format, ptr(w_bytes), ptr(w_meta), S_w,
                ptr(table), V, d, int(table is not None
                                      and table.dtype == torch.bfloat16),
                ptr(query), nq, round_bf16, ptr(edge_base),
                ptr(out), ptr(out2), ptr(fout), stream)
        launches.bump(f"{format}/{ep.name}")
    if ep.name == "bag_sum":
        return fout
    if ep.name == "dot_score":
        return out, fout
    return (out, out2) if out2 is not None else out


def fused_decode(operands: dict, extras: dict, *, format: str, epilogue: str,
                 block_size: int, differential: bool):
    """Fused decode→epilogue in one pass over the blocked operands.

    ``operands`` is ``CompressedIntArray.device_operands()`` of any format
    (``counts``/``bases`` may be ``[n_blocks]`` or ``[n_blocks, 1]``). On
    the card this is one launch of kernel 2; on the CPU,
    :func:`fused_decode_plain`. Output shapes are exactly ``[n_blocks, …]``.
    """
    ep = get_epilogue(epilogue)
    ep.check(differential, extras)
    if format not in FORMAT_OPERANDS:
        raise ValueError(f"unknown format {format!r}")
    names = FORMAT_OPERANDS[format]
    missing = [k for k in names + ("counts", "bases") if k not in operands]
    if missing:
        raise ValueError(f"format {format!r} operands missing {missing}")
    leaves = [operands[k].contiguous() for k in names]
    counts, bases = normalize_counts_bases(operands["counts"],
                                           operands["bases"],
                                           leaves[-1].shape[0])
    CHECK_OPERANDS[format](*leaves, counts, bases, block_size=block_size)
    ops = dict(zip(names, leaves), counts=counts, bases=bases)
    if not counts.is_cuda:
        return fused_decode_plain(ops, extras, format=format,
                                  epilogue=epilogue, block_size=block_size,
                                  differential=differential)
    return _fused_decode_cuda(format, ops, extras, ep=ep,
                              block_size=block_size,
                              differential=differential)
