"""Stream validation: typed decode errors, host validators, checked decode.

The port of ``repro/robustness/validate.py``. Every decoder — the scalar
oracle, the plain torch decoders and the CUDA kernels — is branch-free
arithmetic over whatever bytes it is handed: a truncated payload, a
flipped continuation bit or a corrupted Stream VByte control byte gives
*defined garbage*, never a crash. That is the right contract for the
kernels, but it lets corruption flow silently into skip tables, BM25
scores and served results. This module is the detection layer on top:

* **Error taxonomy** — :class:`DecodeError` subclasses carrying
  ``format``/``block``/``term`` coordinates, so a failing segment can be
  quarantined instead of taking the whole index down
  (``repro_torch.launch.serve``).
* **Host validators** — :func:`validate_structure` (block metadata),
  :func:`validate_stream` (per-block byte-level format checks),
  :func:`validate_meta` (skip table, ``df``, ``max_impact`` bounds). They
  read the array's host leaves (``counts_host``, one ``leaves_numpy()``
  per array) and raise the reference's class at the reference's first
  failing block. The reference walks the blocks one by one in Python;
  here a vectorised screen over every block flags the blocks that can
  fail, and the reference's per-block check runs on the flagged ones in
  block order, so the first error raised is the reference's.
* **Checked decode** — :func:`decode_checked`: decode through kernel 2's
  ``checksum`` epilogue on the array's device and compare the per-block
  column written by ``encode(checksum=True)``. The checksum
  ``cs[b] = Σ_j vals[b,j]·(2j+1) mod 2^32`` comes out of the same pass as
  the decoded grid; the odd weights are invertible mod 2^32, so any
  single-value corruption is detected.

Also home of :class:`Deadline`, the injectable-clock per-request budget
the query engine and serving layer check at strip/chunk boundaries.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.core.compressed_array import (CompressedIntArray,
                                               block_checksums)
from repro_torch.core.vbyte import binpack as bpk
from repro_torch.core.vbyte import stream_vbyte as svb

# blocks screened per vectorised step (bounds the host scratch memory)
SCREEN_BLOCKS = 8192


# ---------------------------------------------------------------------------
# error taxonomy
# ---------------------------------------------------------------------------
class DecodeError(ValueError):
    """A compressed stream (or its metadata) failed validation.

    Carries coordinates — ``format``, ``block`` (index within the stream's
    block dimension), ``term`` (owning posting-list term, when known) — so
    callers can quarantine the failing segment.
    """

    def __init__(self, message: str, *, format: str | None = None,
                 block: int | None = None, term=None):
        self.format = format
        self.block = block
        self.term = term
        coords = [f"format={format!r}" if format else None,
                  f"block={block}" if block is not None else None,
                  f"term={term!r}" if term is not None else None]
        coords = ", ".join(c for c in coords if c)
        super().__init__(f"{message} [{coords}]" if coords else message)


class TruncatedPayloadError(DecodeError):
    """The payload ends before the block's ``counts`` integers terminate."""


class OverlongRunError(DecodeError):
    """A continuation run spans more than 5 bytes (no 32-bit terminator)."""


class NonCanonicalError(DecodeError):
    """A value is encoded in more bytes than the format requires."""


class ControlMismatchError(DecodeError):
    """Stream VByte control-claimed data length exceeds the data stride."""


class BlockMetaError(DecodeError):
    """Block metadata is inconsistent (counts, bases, skip table, bounds)."""


class BoundViolationError(BlockMetaError):
    """A block's ``max_impact`` understates its true impact max — the
    MaxScore pruning invariant. Pruning with an understated bound silently
    drops true top-k results, so the serving layer maps this error to an
    exhaustive-TAAT fallback (exact, just slower) instead of quarantine."""


class ChecksumError(DecodeError):
    """Decoded values disagree with the stored per-block checksum column."""


class WalError(DecodeError):
    """A write-ahead-log record is structurally invalid *mid-log*: a CRC or
    framing failure on a record that has durable data after it, or a
    replayed operation that contradicts index state. A torn *tail* (the
    one unacknowledged record a crash can legitimately shear) is not an
    error — the reader truncates it and recovers the acknowledged
    prefix."""


class SegmentError(DecodeError):
    """A persisted index segment — or the manifest naming it — is missing,
    truncated, corrupt, or stale: the whole-file CRC or per-term metadata
    disagrees with the bytes on disk, or recovery cannot reconstruct a
    consistent segment set."""


class CheckpointError(DecodeError):
    """A checkpoint step's manifest or leaves are unreadable or internally
    inconsistent; restoring treats this as skip-to-previous-intact-step,
    not a crash."""


# ---------------------------------------------------------------------------
# deadlines (used by repro_torch.index.query and repro_torch.launch.serve)
# ---------------------------------------------------------------------------
@dataclass
class Deadline:
    """A per-request time budget with an injectable clock.

    ``expired()`` is checked at work-unit boundaries (per decoded chunk /
    per term / per MaxScore strip) — work in flight always completes, so a
    deadline never yields a torn result, only a *smaller* one flagged
    ``degraded``. ``clock`` is injectable so tests expire deadlines
    deterministically.
    """

    budget_s: float
    clock: callable = time.monotonic
    start: float = field(default=None)  # type: ignore[assignment]
    hit: bool = False  # set once expired() first returns True

    def __post_init__(self):
        if self.start is None:
            self.start = self.clock()

    def expired(self) -> bool:
        if not self.hit and self.clock() - self.start >= self.budget_s:
            self.hit = True
        return self.hit

    def remaining(self) -> float:
        return max(0.0, self.budget_s - (self.clock() - self.start))


# ---------------------------------------------------------------------------
# host-side validators
# ---------------------------------------------------------------------------
def validate_structure(arr: CompressedIntArray, *, term=None,
                       leaves: dict | None = None) -> None:
    """Block-metadata invariants that need no byte-level decoding.

    Raises :class:`BlockMetaError` when ``counts`` fall outside
    ``[0, block_size]``, when they don't sum to ``n``, or when ``bases``
    are nonzero for a non-differential (or ragged) stream. ``leaves``
    (``arr.leaves_numpy()``) saves a second copy from the device.
    """
    fmt = arr.format
    counts = arr.counts_host
    bad = np.flatnonzero((counts < 0) | (counts > arr.block_size))
    if bad.size:
        raise BlockMetaError(
            f"count {int(counts[bad[0]])} outside [0, {arr.block_size}]",
            format=fmt, block=int(bad[0]), term=term)
    if int(counts.sum()) != arr.n:
        raise BlockMetaError(
            f"counts sum to {int(counts.sum())} but n={arr.n}",
            format=fmt, term=term)
    if not arr.differential or arr.ragged:
        bases = (leaves["bases"] if leaves is not None
                 else arr.bases.cpu().numpy())
        bad = np.flatnonzero(bases != 0)
        if bad.size:
            raise BlockMetaError(
                "nonzero base on a stream whose blocks are self-based",
                format=fmt, block=int(bad[0]), term=term)


# -- the reference's per-block checks (run on the screened blocks) ----------
def _validate_vbyte_block(p: np.ndarray, c: int, b: int, term) -> None:
    term_pos = np.flatnonzero(p < 128)
    if term_pos.size < c:
        # fewer terminator bytes than claimed integers — either the stream
        # was cut, or a flipped continuation bit merged two integers
        raise TruncatedPayloadError(
            f"payload holds {term_pos.size} terminated integers, "
            f"counts claim {c}", format="vbyte", block=b, term=term)
    ends = term_pos[:c]
    starts = np.concatenate(([0], ends[:-1] + 1))
    lens = ends - starts + 1
    bad = np.flatnonzero(lens > 5)
    if bad.size:
        raise OverlongRunError(
            f"integer {int(bad[0])} spans {int(lens[bad[0]])} bytes "
            "(max 5 for 32-bit values)", format="vbyte", block=b, term=term)
    top = p[ends].astype(np.int64)
    # a multi-byte integer whose most-significant 7-bit group is zero fits
    # in fewer bytes; a 5-byte integer with >4 payload bits in the top
    # group overflows 32 bits (the decoders wrap it mod 2^32)
    bad = np.flatnonzero(((lens > 1) & (top == 0))
                         | ((lens == 5) & (top > 0x0F)))
    if bad.size:
        j = int(bad[0])
        raise NonCanonicalError(
            f"integer {j} ({int(lens[j])} bytes, top group "
            f"{int(top[j]):#x}) is not canonically encoded",
            format="vbyte", block=b, term=term)


def _validate_svb_block(control: np.ndarray, data: np.ndarray, c: int,
                        b: int, term) -> None:
    lengths = svb.unpack_control(control, c) + 1
    total = int(lengths.sum())
    if total > data.shape[0]:
        raise ControlMismatchError(
            f"control stream claims {total} data bytes, stride is "
            f"{data.shape[0]}", format="streamvbyte", block=b, term=term)
    # canonical: the top claimed byte of every multi-byte integer must be
    # nonzero, else the control code overstates the length
    ends = np.cumsum(lengths) - 1
    top = data[ends].astype(np.int64)
    bad = np.flatnonzero((lengths > 1) & (top == 0))
    if bad.size:
        j = int(bad[0])
        raise NonCanonicalError(
            f"integer {j} ({int(lengths[j])} bytes) has a zero top byte — "
            "control code overstates its length",
            format="streamvbyte", block=b, term=term)


def _validate_binpack_block(w: int, data: np.ndarray, c: int, b: int,
                            term) -> None:
    if w > bpk.MAX_WIDTH:
        raise BlockMetaError(
            f"width byte {w} exceeds the 32-bit maximum",
            format="binpack", block=b, term=term)
    used = -(-(w * c) // 8)
    if used > data.shape[0]:
        raise TruncatedPayloadError(
            f"width {w} × {c} values needs {used} bytes, stride is "
            f"{data.shape[0]}", format="binpack", block=b, term=term)
    vals = bpk.decode_block_scalar(data, w, c)
    if w and int(bpk.bit_widths(vals).max(initial=0)) < w:
        raise NonCanonicalError(
            f"width byte claims {w} bits but the widest value fits in "
            f"{int(bpk.bit_widths(vals).max(initial=0))} — width is "
            "overstated", format="binpack", block=b, term=term)
    # canonical padding: bits of the last used byte past c·w must be zero
    tail_bits = (w * c) & 7
    if used and tail_bits and int(data[used - 1]) >> tail_bits:
        raise NonCanonicalError(
            f"nonzero padding bits above bit {w * c} in the last packed "
            "byte", format="binpack", block=b, term=term)


# -- vectorised screens: a block not flagged passes its per-block check -----
def _screen_vbyte(payload: np.ndarray, c: np.ndarray) -> np.ndarray:
    """Blocks whose first ``c`` integers are not all terminated, canonical
    runs of at most 5 bytes."""
    S = payload.shape[1]
    is_t = payload < 128
    cum = np.cumsum(is_t, axis=1, dtype=np.int32)  # ordinal of a terminator
    pos = np.broadcast_to(np.arange(S, dtype=np.int32), payload.shape)
    last = np.maximum.accumulate(np.where(is_t, pos, -1), axis=1)
    prev = np.concatenate([np.full((payload.shape[0], 1), -1, np.int32),
                           last[:, :-1]], axis=1)
    lens = pos - prev  # run length, read at terminator bytes
    bad_run = ((lens > 5) | ((lens > 1) & (payload == 0))
               | ((lens == 5) & (payload > 0x0F)))
    counted = is_t & (cum <= c[:, None])
    return (cum[:, -1] < c) | (counted & bad_run).any(axis=1)


def _screen_svb(control: np.ndarray, data: np.ndarray,
                c: np.ndarray) -> np.ndarray:
    """Blocks whose claimed lengths overrun the stride, or whose
    multi-byte integers end on a zero byte."""
    S = data.shape[1]
    shifts = np.arange(4, dtype=np.uint8) * np.uint8(2)
    codes = ((control[:, :, None] >> shifts) & np.uint8(3)).reshape(
        control.shape[0], -1).astype(np.int32)
    live = np.arange(codes.shape[1])[None, :] < c[:, None]
    lens = np.where(live, codes + 1, 0)
    ends = np.clip(np.cumsum(lens, axis=1) - 1, 0, S - 1)
    top = np.take_along_axis(data, ends, axis=1)
    return ((lens.sum(axis=1) > S)
            | (live & (lens > 1) & (top == 0)).any(axis=1))


def _screen_binpack(widths: np.ndarray, data: np.ndarray, c: np.ndarray,
                    block_size: int) -> np.ndarray:
    """Blocks with a width past 32, packed bits past the stride, a width
    wider than the widest value, or nonzero padding bits."""
    nb, S = data.shape
    w = widths.astype(np.int64)
    used = -(-(w * c) // 8)
    out = (w > bpk.MAX_WIDTH) | (used > S)
    ok = ~out
    w, used, c, d = w[ok], used[ok], c[ok], data[ok]
    bit = np.arange(block_size, dtype=np.int64)[None, :] * w[:, None]
    byte0, shift = bit >> 3, (bit & 7).astype(np.uint64)
    padded = np.concatenate([d, np.zeros((d.shape[0], 5), np.uint8)], axis=1)
    word = np.zeros(byte0.shape, np.uint64)
    for k in range(5):  # the 40-bit window holding value j (shift ≤ 7)
        word |= (np.take_along_axis(padded, byte0 + k, axis=1)
                 .astype(np.uint64) << np.uint64(8 * k))
    mask = (np.uint64(1) << w.astype(np.uint64)) - np.uint64(1)
    live = np.arange(block_size)[None, :] < c[:, None]
    vals = np.where(live, (word >> shift) & mask[:, None], 0)
    wide = np.where(w > 0, np.uint64(1) << np.maximum(w - 1, 0)
                    .astype(np.uint64), 0)
    loose = (w > 0) & (vals.max(axis=1, initial=0) < wide)
    tail = (w * c) & 7
    last = d[np.arange(d.shape[0]), np.maximum(used - 1, 0)].astype(np.int64)
    pad_bits = (used > 0) & (tail > 0) & ((last >> tail) != 0)
    out[ok] = loose | pad_bits
    return out


def _screen(arr: CompressedIntArray, lv: dict, sl: slice) -> np.ndarray:
    c = arr.counts_host[sl].astype(np.int64)
    if arr.format == "vbyte":
        flag = _screen_vbyte(lv["payload"][sl], c)
    elif arr.format == "binpack":
        flag = _screen_binpack(lv["widths"].reshape(-1)[sl], lv["data"][sl],
                               np.clip(c, 0, arr.block_size), arr.block_size)
    else:
        flag = _screen_svb(lv["control"][sl], lv["data"][sl],
                           np.clip(c, 0, arr.block_size))
    # counts outside [0, B] go to the per-block check as they are
    return flag | (c < 0) | (c > arr.block_size)


def validate_stream(arr: CompressedIntArray, *, term=None, blocks=None,
                    leaves: dict | None = None) -> None:
    """Byte-level format validation of every (or the given) block.

    VByte: the block must hold ``counts[b]`` terminated integers
    (:class:`TruncatedPayloadError`), no continuation run may exceed 5
    bytes (:class:`OverlongRunError`), and every integer must be canonical
    (:class:`NonCanonicalError`). Stream VByte: the control-claimed data
    length must fit the data stride (:class:`ControlMismatchError`) and
    every multi-byte integer must use its claimed width
    (:class:`NonCanonicalError`). Binpack: the width byte must be ≤ 32
    (:class:`BlockMetaError`), the packed bits must fit the data stride
    (:class:`TruncatedPayloadError`), the width must be tight for the
    block's widest value, and the final partial byte's padding bits must
    be zero (:class:`NonCanonicalError`). Padding bytes beyond the last
    claimed integer are *not* checked — the decoders mask them.

    Blocks are visited in block order (or in the order of ``blocks``); the
    first failing one raises, with the reference's class and message.
    ``leaves`` (``arr.leaves_numpy()``) saves a second copy from the
    device.
    """
    lv = arr.leaves_numpy() if leaves is None else leaves
    counts = arr.counts_host
    nb = counts.shape[0]
    flag = np.concatenate(
        [_screen(arr, lv, slice(s, s + SCREEN_BLOCKS))
         for s in range(0, nb, SCREEN_BLOCKS)]) if nb else np.zeros(0, bool)
    flag &= counts != 0
    idx = (np.flatnonzero(flag) if blocks is None
           else [b for b in blocks if flag[b]])
    for b in idx:
        c = int(counts[b])
        if arr.format == "vbyte":
            _validate_vbyte_block(lv["payload"][b], c, int(b), term)
        elif arr.format == "binpack":
            _validate_binpack_block(int(lv["widths"].reshape(-1)[b]),
                                    lv["data"][b], c, int(b), term)
        else:
            _validate_svb_block(lv["control"][b], lv["data"][b], c, int(b),
                                term)


def validate_array(arr: CompressedIntArray, *, term=None) -> None:
    """Structure + stream validation (the serving layer's startup gate),
    over one host copy of the leaves."""
    lv = arr.leaves_numpy()
    validate_structure(arr, term=term, leaves=lv)
    validate_stream(arr, term=term, leaves=lv)


def validate_meta(tp, *, deep: bool = False) -> None:
    """Skip-table / impact invariants of one ``TermPostings``.

    Cheap checks: per-block ``first_doc <= last_doc``, strictly increasing
    across non-empty blocks (docids are sorted and unique), ``df`` equal to
    the stream's ``n``. With ``deep=True`` the postings and impacts are
    scalar-decoded and the skip table and ``max_impact`` column are checked
    against the actual block contents — in particular ``max_impact[b]``
    must bound block ``b``'s true impact max, the invariant MaxScore prunes
    with (a violated bound silently drops results, so the engine falls back
    to exhaustive TAAT when this raises).
    """
    term = tp.term
    counts = tp.arr.counts_host
    live = np.flatnonzero(counts > 0)
    first = np.asarray(tp.first_doc).astype(np.int64)
    last = np.asarray(tp.last_doc).astype(np.int64)
    bad = live[first[live] > last[live]]
    if bad.size:
        raise BlockMetaError(
            f"skip table first_doc {int(first[bad[0]])} > last_doc "
            f"{int(last[bad[0]])}", block=int(bad[0]), term=term)
    if live.size > 1:
        gap = np.flatnonzero(first[live][1:] <= last[live][:-1])
        if gap.size:
            b = int(live[gap[0] + 1])
            raise BlockMetaError(
                "skip table not monotone: first_doc[b] <= last_doc of the "
                "previous non-empty block", block=b, term=term)
    if tp.df != int(counts.sum()):
        raise BlockMetaError(
            f"df={tp.df} but posting blocks hold {int(counts.sum())} ids",
            term=term)
    if not deep:
        return
    grid = _scalar_grid(tp.arr).astype(np.int64)
    B = tp.arr.block_size
    valid = np.arange(B)[None, :] < counts[:, None]
    lo = grid[live, 0]
    hi = grid[live, np.minimum(counts[live], B) - 1]
    bad = np.flatnonzero((lo != first[live]) | (hi != last[live]))
    if bad.size:
        b, i = int(live[bad[0]]), int(bad[0])
        raise BlockMetaError(
            f"skip table ({int(first[b])}, {int(last[b])}) disagrees "
            f"with decoded block range ({int(lo[i])}, {int(hi[i])})",
            block=b, term=term)
    if tp.impacts is not None and tp.max_impact is not None:
        imp = _scalar_grid(tp.impacts)
        actual = np.where(valid, imp, 0).max(axis=1).astype(np.int64)
        mi = np.asarray(tp.max_impact).astype(np.int64)
        bad = np.flatnonzero(mi < actual)
        if bad.size:
            b = int(bad[0])
            raise BoundViolationError(
                f"max_impact {int(mi[b])} < actual block max "
                f"{int(actual[b])} — MaxScore bounds are unsafe",
                block=b, term=term)


def check_skip_table(tp, grid: torch.Tensor) -> None:
    """The skip table against a decoded docid grid (``decode_checked``'s
    grid, on its device): each live block's first and last docid must be
    ``first_doc[b]`` and ``last_doc[b]``. Raises the
    :class:`BlockMetaError` that ``validate_meta(tp, deep=True)`` raises
    for the first such block; only the mismatch flags come to the host.

    This catches what the checksum column cannot see: a flipped bit ``k``
    of a differential block's base shifts all ``c`` values by ``2^k``,
    which moves the position-weighted sum by ``2^k · c²`` — nothing mod
    2^32 once ``k ≥ 32 − 2·log2(c)`` (bit 18 and up in a full block of
    128)."""
    counts = tp.arr.counts_host
    live = np.flatnonzero(counts > 0)
    if not live.size:
        return
    B = tp.arr.block_size
    dev = grid.device
    rows = torch.as_tensor(live, device=dev)
    cols = torch.as_tensor(np.minimum(counts[live], B) - 1, device=dev)
    first = np.asarray(tp.first_doc).astype(np.uint32)[live]
    last = np.asarray(tp.last_doc).astype(np.uint32)[live]
    lo, hi = grid[rows, 0], grid[rows, cols]
    bad = ((lo != torch.as_tensor(first.view(np.int32), device=dev))
           | (hi != torch.as_tensor(last.view(np.int32), device=dev)))
    bad = np.flatnonzero(bad.cpu().numpy())
    if bad.size:
        i = int(bad[0])
        b = int(live[i])
        got = np.array([lo[i].item(), hi[i].item()], np.int32).view(
            np.uint32)
        raise BlockMetaError(
            f"skip table ({int(first[i])}, {int(last[i])}) disagrees "
            f"with decoded block range ({int(got[0])}, {int(got[1])})",
            block=b, term=tp.term)


def _scalar_grid(arr: CompressedIntArray) -> np.ndarray:
    """Scalar-oracle decode to the padded block grid (host, trusted path)."""
    flat = arr.decode_scalar_oracle()
    counts = arr.counts_host
    grid = np.zeros((counts.shape[0], arr.block_size), np.uint32)
    mask = np.arange(arr.block_size)[None, :] < counts[:, None]
    grid[mask] = flat
    return grid


# ---------------------------------------------------------------------------
# checksum-verified decode (kernel 2's `checksum` epilogue, host compare)
# ---------------------------------------------------------------------------
def decode_checked(arr: CompressedIntArray, *, plan="auto",
                   term=None) -> torch.Tensor:
    """Decode to the int32 (uint32 bits) ``[n_blocks, block_size]`` grid on
    the array's device, verified.

    Runs kernel 2's ``checksum`` epilogue (on the CPU, its plain version):
    the decoded grid and its position-weighted per-block checksum come out
    of the same pass. Only the 4-byte-per-block column is copied to the
    host and compared with the one stored at encode time
    (``encode(checksum=True)``); a mismatch raises :class:`ChecksumError`
    at the first mismatching block. On clean input the grid is bit-exact
    with ``decode_blocked``'s and stays on the device.

    An array may carry more blocks than checksum rows (count-0 padding,
    which checksums to 0): only stored rows are compared, padding rows
    must be 0.
    """
    from repro_torch.kernels.vbyte_decode import dispatch

    if arr.checksums is None:
        raise ValueError(
            "array carries no checksum column — encode with checksum=True "
            "(or validate via validate_array/scalar re-decode instead)")
    vals, cs = dispatch.decode(arr, epilogue="checksum", plan=plan)
    cs = cs.reshape(-1).cpu().numpy().view(np.uint32)
    stored = np.asarray(arr.checksums).reshape(-1).astype(np.uint32)
    k = min(stored.shape[0], cs.shape[0])
    bad = np.flatnonzero(cs[:k] != stored[:k])
    if bad.size == 0 and cs.shape[0] > k:
        bad = k + np.flatnonzero(cs[k:] != 0)  # padding blocks
    if bad.size:
        b = int(bad[0])
        want = int(stored[b]) if b < k else 0
        raise ChecksumError(
            f"block checksum {int(cs[b]):#010x} != stored {want:#010x} "
            f"({bad.size} corrupt block(s))",
            format=arr.format, block=b, term=term)
    return vals


def expected_checksums(arr: CompressedIntArray) -> np.ndarray:
    """Recompute the checksum column from a trusted scalar decode
    (tests/tools; the fast path is the fused epilogue above)."""
    return block_checksums(_scalar_grid(arr), arr.counts_host)
