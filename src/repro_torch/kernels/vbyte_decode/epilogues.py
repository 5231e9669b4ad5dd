"""Fused decode→consume epilogues, and kernel 2 (``csrc/fused_decode.cu``).

The port of ``repro/kernels/vbyte_decode/epilogues.py``. An
:class:`Epilogue` is a function over the decode contract

    ``(vals int32 [T, B] (uint32 bits), valid bool [T, B], **extras) -> out``

Its torch ``apply`` body, run on a whole decoded grid by :func:`apply_grid`,
is the plain version of the fused kernel: :func:`fused_decode` launches the
CUDA kernel for operands on the card and runs decode + ``apply`` for
operands on the CPU. The epilogues the search path runs are ported:

* ``stream``     — the decoded integers;
* ``checksum``   — the integers plus ``cs[t] = Σ_j vals[t,j]·(2j+1) mod 2^32``;
* ``membership`` — ``[T, P]`` hit bitmap against a sorted probe set padded
  with -1; ``bm25_accum`` multiplies it by the term's int32 impact;
* ``bm25_weighted`` — ``Σ_j hit·w`` where ``w`` is the aligned per-posting
  impact stream (``w_payload``), decoded in the same pass with the main
  tile's counts;
* ``*_rows`` — the block-aligned variants: ``probe`` is a tiled
  ``[T, 1]`` extra, block t compared against its own probe only.

Masked slots compare as -1 and only probes ``>= 0`` count. Sums wrap mod
2^32 exactly like the reference's int32 arithmetic. The ``bag_sum``,
``dot_score`` and ``adjacency_rebase`` consumers, and the Stream-VByte and
binpack weight operands, are still to port (ROADMAP queue 1, slices B/D).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

import torch

from repro_torch.core.vbyte.masked import (decode_blocked as decode_blocked_plain,
                                           to_i32_bits, to_u32)

from ._build import LaunchCounter, library
from .kernel import check_operands
from .ops import as_i32_bits, normalize_block_meta

FORMAT_OPERANDS = {
    "vbyte": ("payload",),
    "streamvbyte": ("control", "data"),
    "binpack": ("widths", "data"),
}
NOT_PORTED = ("not ported yet: format={!r} is ROADMAP queue 1 item 8 "
              "(slice B: Stream-VByte, binpack and the auto partition)")
WEIGHT_OPERANDS = ("w_payload", "w_control", "w_data", "w_widths")
MAX_PROBE_WIDTH = 4096  # broadcast probe set held in shared memory per CTA

launches = LaunchCounter()

# broadcast epilogues compare [rows, B, P]; chunk rows to bound the memory
_CHUNK_ELEMS = 1 << 24


# ---------------------------------------------------------------------------
# epilogue bodies — torch ops on the decode contract (the plain versions)
# ---------------------------------------------------------------------------
def _stream_apply(vals, valid):
    return vals


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


def _decode_weight_tile(valid, w_payload=None, w_control=None, w_data=None,
                        w_widths=None):
    """Decode the aligned per-posting weight tile (non-differential). Its
    blocks align 1:1 with the main stream, so the main tile's ``valid`` mask
    is the weight tile's count vector."""
    if w_control is not None or w_widths is not None or (
            w_data is not None and w_payload is None):
        raise NotImplementedError(NOT_PORTED.format(
            "binpack" if w_widths is not None else "streamvbyte"))
    if w_payload is None:
        raise ValueError("weighted epilogue needs the w_payload (vbyte) extra")
    counts = valid.sum(dim=1).to(torch.int32)
    zeros = torch.zeros_like(counts)
    w = decode_blocked_plain(w_payload, counts, zeros,
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
}
# consumers of the same decode core that are still to port (ROADMAP queue 1
# item 12, slice D)
UNPORTED_EPILOGUES = ("bag_sum", "dot_score", "adjacency_rebase")


def get_epilogue(name: str) -> Epilogue:
    if name in UNPORTED_EPILOGUES:
        raise NotImplementedError(
            f"epilogue {name!r} is not ported yet (ROADMAP queue 1 item 12)")
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


def fused_decode_plain(payload, counts, bases, extras, *, epilogue: str,
                       block_size: int, differential: bool):
    """The plain version of kernel 2: torch decode, then the ``apply`` body."""
    grid = decode_blocked_plain(payload, counts, bases, block_size=block_size,
                                differential=differential)
    return apply_grid(epilogue, grid, counts, extras)


# ---------------------------------------------------------------------------
# kernel 2: the CUDA launch
# ---------------------------------------------------------------------------
def _check_i32(name, t, shape, device):
    if (t.dtype != torch.int32 or tuple(t.shape) != shape
            or t.device != device or not t.is_contiguous()):
        raise ValueError(f"{name} must be a contiguous int32 {list(shape)} "
                         f"tensor on {device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _fused_decode_cuda(payload, counts, bases, extras, *, ep: Epilogue,
                       block_size: int, differential: bool):
    dev = payload.device
    nb, S = payload.shape
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
    w_payload = extras.get("w_payload")
    S_w = 1
    if ep.name.startswith("bm25_weighted"):
        if any(k in extras for k in ("w_control", "w_data", "w_widths")):
            raise NotImplementedError(NOT_PORTED.format(
                "binpack" if "w_widths" in extras else "streamvbyte"))
        if w_payload is None:
            raise ValueError("weighted epilogue needs the w_payload (vbyte) extra")
        if (w_payload.dtype != torch.uint8 or w_payload.dim() != 2
                or w_payload.shape[0] != nb or w_payload.shape[1] < 1
                or w_payload.device != dev or not w_payload.is_contiguous()):
            raise ValueError(f"w_payload must be a contiguous uint8 [{nb}, S_w] "
                             f"tensor on {dev}; got {w_payload.dtype} "
                             f"{tuple(w_payload.shape)} on {w_payload.device}")
        S_w = w_payload.shape[1]

    if ep.name in ("stream", "checksum"):
        out = torch.empty((nb, B), dtype=torch.int32, device=dev)
    elif "probe" in ep.tiled_extras:
        out = torch.empty((nb, 1), dtype=torch.int32, device=dev)
    else:
        out = torch.empty((nb, P), dtype=torch.int32, device=dev)
    out2 = (torch.empty((nb, 1), dtype=torch.int32, device=dev)
            if ep.name == "checksum" else None)
    if nb:
        def ptr(t):
            return None if t is None else t.data_ptr()

        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream().cuda_stream
            library("fused_decode").call(
                "fused_decode_launch", ep.cuda_id, payload.data_ptr(), S,
                counts.data_ptr(), bases.data_ptr(), nb, B, int(differential),
                ptr(probe), P, ptr(impact), ptr(w_payload), S_w,
                out.data_ptr(), ptr(out2), stream)
        launches.bump(ep.name)
    return (out, out2) if out2 is not None else out


def fused_decode(operands: dict, extras: dict, *, format: str, epilogue: str,
                 block_size: int, differential: bool):
    """Fused decode→epilogue in one pass over the blocked operands.

    ``operands`` is ``CompressedIntArray.device_operands()`` (``counts``/
    ``bases`` may be ``[n_blocks]`` or ``[n_blocks, 1]``). On the card this
    is one launch of kernel 2; on the CPU, :func:`fused_decode_plain`.
    Output shapes are exactly ``[n_blocks, …]``.
    """
    ep = get_epilogue(epilogue)
    ep.check(differential, extras)
    if format not in FORMAT_OPERANDS:
        raise ValueError(f"unknown format {format!r}")
    if format != "vbyte":
        raise NotImplementedError(NOT_PORTED.format(format))
    payload = operands["payload"].contiguous()
    nb = payload.shape[0]
    counts = as_i32_bits(normalize_block_meta("counts", operands["counts"], nb))
    bases = as_i32_bits(normalize_block_meta("bases", operands["bases"], nb))
    counts, bases = counts.contiguous(), bases.contiguous()
    check_operands(payload, counts, bases, block_size=block_size)
    if not payload.is_cuda:
        return fused_decode_plain(payload, counts, bases, extras,
                                  epilogue=epilogue, block_size=block_size,
                                  differential=differential)
    return _fused_decode_cuda(payload, counts, bases, extras, ep=ep,
                              block_size=block_size,
                              differential=differential)
