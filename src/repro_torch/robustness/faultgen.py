"""Seeded corruption generator for the robustness property tests.

The port of the stream and index classes of
``repro/robustness/faultgen.py``. Every stream class takes a *clean*
``CompressedIntArray`` (typically encoded with ``checksum=True``) and a
seed, and returns a :class:`Corruption` — the corrupted array plus the
coordinates of what was broken — or ``None`` when the class doesn't apply
to the array (e.g. ``continuation_flip`` on Stream VByte,
``base_corrupt`` on a non-differential stream). With the same seed a
class makes the same draws from ``np.random.default_rng(seed)`` in the
same order as the reference, so it breaks the same byte of the same
block. Corruptions only touch *used* bytes (bytes the decoder consumes
for the claimed ``counts``): flipping padding is harmless by the masking
contract.

The corrupted array is rebuilt onto the clean array's device with the
clean array's ``n``: ``counts``, ``counts_host`` and ``checksums`` are
replaced together, so ``count_over`` / ``count_under`` leave counts that
no longer sum to ``n`` — what ``validate_structure`` catches.

The contract (tests/test_torch_robustness.py), per class × format:
**detect-or-defined-value** — either a typed
:class:`~repro_torch.robustness.validate.DecodeError` is raised by
``validate_structure``/``validate_stream``/``decode_checked``, or (with no
checksum column) the corrupted stream decodes to the same defined value
on every plan.

Index-level corruptions (skip table, ``max_impact`` bound, impact
payload) operate on a ``TermPostings`` and return a replaced copy;
whole-shard loss is injected at the serving layer
(``SearchEngine.kill_shard``). The durability classes
(:data:`DURABILITY_CLASSES`, :func:`corrupt_dir`) corrupt the WAL,
segment and manifest files of a closed live-index directory; with the
same seed they corrupt the same bytes of the same file as the
reference's on the same directory.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.compressed_array import CompressedIntArray
from repro_torch.core.vbyte import ref as vref
from repro_torch.core.vbyte import stream_vbyte as svb


@dataclass(frozen=True)
class Corruption:
    """One injected fault: the corrupted array + what/where."""

    arr: CompressedIntArray
    cls: str
    block: int
    detail: str


def _leaf(arr: CompressedIntArray, name: str) -> np.ndarray:
    """A writable host copy of one leaf (``bases`` as uint32)."""
    if name == "counts":
        return arr.counts_host.copy()
    if name == "checksums":
        return np.array(arr.checksums)
    out = getattr(arr, name).cpu().numpy().copy()
    return out.view(np.uint32) if name == "bases" else out


def _rebuild(arr: CompressedIntArray, **leaves) -> CompressedIntArray:
    """``arr`` with some leaves replaced, on ``arr``'s device, ``n`` kept.
    Like the reference's rebuild (which drops ``host_enc``), the encoded
    size no longer applies."""
    dev = arr.device
    kw: dict = {"payload_bytes": None}
    for name, v in leaves.items():
        if name == "counts":
            kw["counts_host"] = v.astype(np.int32)
            kw["counts"] = torch.as_tensor(kw["counts_host"].copy(),
                                           device=dev)
        elif name == "checksums":
            kw["checksums"] = v
        elif name == "bases":
            kw["bases"] = torch.as_tensor(v.astype(np.uint32).view(np.int32),
                                          device=dev)
        else:
            kw[name] = torch.as_tensor(v, device=dev)
    return replace(arr, **kw)


def _pick_block(arr: CompressedIntArray, rng: np.random.Generator) -> int:
    """A block with at least one claimed integer (corrupting an empty
    block's padding is harmless by construction)."""
    live = np.flatnonzero(arr.counts_host > 0)
    if live.size == 0:
        raise ValueError("array has no non-empty block to corrupt")
    return int(rng.choice(live))


def _row(arr: CompressedIntArray, name: str, b: int) -> np.ndarray:
    return getattr(arr, name)[b].cpu().numpy()


def _used_bytes(arr: CompressedIntArray, b: int) -> int:
    """Bytes the decoder consumes in block ``b`` for the claimed count."""
    c = int(arr.counts_host[b])
    if arr.format == "vbyte":
        return vref.consumed_bytes(_row(arr, "payload", b), c)
    if arr.format == "binpack":
        w = int(_row(arr, "widths", b)[0])
        return max(-(-(w * c) // 8), 1)  # ≥1 so bit_flip/byte_drop apply
    lengths = svb.unpack_control(_row(arr, "control", b), c) + 1
    return int(lengths.sum())


# --- stream-level corruption classes ---------------------------------------
def _bit_flip(arr, rng):
    b = _pick_block(arr, rng)
    name = "payload" if arr.format == "vbyte" else "data"
    leaf = _leaf(arr, name)
    i = int(rng.integers(_used_bytes(arr, b)))
    bit = int(rng.integers(8))
    leaf[b, i] ^= 1 << bit
    return Corruption(_rebuild(arr, **{name: leaf}), "bit_flip", b,
                      f"{name}[{b},{i}] ^= 1<<{bit}")


def _byte_drop(arr, rng):
    # drop one used byte: the tail shifts left, the last byte pads with 0 —
    # models a short read / lost byte mid-segment
    b = _pick_block(arr, rng)
    name = "payload" if arr.format == "vbyte" else "data"
    leaf = _leaf(arr, name)
    used = _used_bytes(arr, b)
    i = int(rng.integers(used))
    leaf[b, i:-1] = leaf[b, i + 1:]
    leaf[b, -1] = 0
    return Corruption(_rebuild(arr, **{name: leaf}), "byte_drop", b,
                      f"{name}[{b},{i}] dropped, tail shifted")


def _payload_truncate(arr, rng):
    # vbyte-only: turn the tail of the used region into an unterminated
    # continuation run, as if the stream were cut mid-integer
    if arr.format != "vbyte":
        return None
    b = _pick_block(arr, rng)
    leaf = _leaf(arr, "payload")
    used = _used_bytes(arr, b)
    i = int(rng.integers(max(used - 2, 0), used))
    leaf[b, i:] = 0xFF
    return Corruption(_rebuild(arr, payload=leaf), "payload_truncate", b,
                      f"payload[{b},{i}:] = 0xFF (no terminator)")


def _continuation_flip(arr, rng):
    if arr.format != "vbyte":
        return None
    b = _pick_block(arr, rng)
    leaf = _leaf(arr, "payload")
    i = int(rng.integers(_used_bytes(arr, b)))
    leaf[b, i] ^= 0x80
    return Corruption(_rebuild(arr, payload=leaf), "continuation_flip", b,
                      f"payload[{b},{i}] continuation bit flipped")


def _control_corrupt(arr, rng):
    if arr.format != "streamvbyte":
        return None
    b = _pick_block(arr, rng)
    c = int(arr.counts_host[b])
    leaf = _leaf(arr, "control")
    i = int(rng.integers(-(-c // 4)))  # a control byte with live codes
    leaf[b, i] ^= int(rng.integers(1, 256))
    return Corruption(_rebuild(arr, control=leaf), "control_corrupt", b,
                      f"control[{b},{i}] xored")


def _count_over(arr, rng):
    b = _pick_block(arr, rng)
    counts = _leaf(arr, "counts")
    if int(counts[b]) >= arr.block_size:
        counts[b] = arr.block_size  # keep in range; sum mismatch remains
        counts[(b + 1) % counts.shape[0]] += 1
    else:
        counts[b] += 1
    return Corruption(_rebuild(arr, counts=counts), "count_over", b,
                      f"counts[{b}] inflated (sum != n)")


def _count_under(arr, rng):
    b = _pick_block(arr, rng)
    counts = _leaf(arr, "counts")
    counts[b] -= 1
    return Corruption(_rebuild(arr, counts=counts), "count_under", b,
                      f"counts[{b}] deflated (sum != n)")


def _base_corrupt(arr, rng):
    if not arr.differential or arr.ragged:
        return None
    live = np.flatnonzero(arr.counts_host > 0)
    live = live[live > 0]  # block 0's base is 0 by convention
    if live.size == 0:
        return None
    b = int(rng.choice(live))
    bases = _leaf(arr, "bases")
    bases[b] ^= np.uint32(1 << int(rng.integers(31)))
    return Corruption(_rebuild(arr, bases=bases), "base_corrupt", b,
                      f"bases[{b}] bit-flipped")


def _width_inflate(arr, rng):
    # binpack-only: overstate a block's width byte by one — the decoder
    # reads shifted garbage; the validator's tight-width canon catches it
    if arr.format != "binpack":
        return None
    b = _pick_block(arr, rng)
    widths = _leaf(arr, "widths")
    if int(widths[b, 0]) >= 32:
        return None
    widths[b, 0] += 1
    return Corruption(_rebuild(arr, widths=widths), "width_inflate", b,
                      f"widths[{b}] inflated by 1")


def _width_deflate(arr, rng):
    # binpack-only: understate the width — values alias into each other
    if arr.format != "binpack":
        return None
    ws = _leaf(arr, "widths").reshape(-1)
    live = np.flatnonzero((arr.counts_host > 0) & (ws > 0))
    if live.size == 0:
        return None
    b = int(rng.choice(live))
    widths = _leaf(arr, "widths")
    widths[b, 0] -= 1
    return Corruption(_rebuild(arr, widths=widths), "width_deflate", b,
                      f"widths[{b}] deflated by 1")


def _width_range(arr, rng):
    # binpack-only: width byte outside [0, 32] entirely
    if arr.format != "binpack":
        return None
    b = _pick_block(arr, rng)
    widths = _leaf(arr, "widths")
    widths[b, 0] = 200
    return Corruption(_rebuild(arr, widths=widths), "width_range", b,
                      f"widths[{b}] = 200 (out of range)")


def _checksum_corrupt(arr, rng):
    if arr.checksums is None:
        return None
    b = _pick_block(arr, rng)
    cs = _leaf(arr, "checksums")
    cs[b] ^= np.int32(1 << int(rng.integers(31)))
    return Corruption(_rebuild(arr, checksums=cs), "checksum_corrupt", b,
                      f"checksums[{b}] bit-flipped")


STREAM_CLASSES: dict[str, Callable[..., Any]] = {
    "bit_flip": _bit_flip,
    "byte_drop": _byte_drop,
    "payload_truncate": _payload_truncate,
    "continuation_flip": _continuation_flip,
    "control_corrupt": _control_corrupt,
    "width_inflate": _width_inflate,
    "width_deflate": _width_deflate,
    "width_range": _width_range,
    "count_over": _count_over,
    "count_under": _count_under,
    "base_corrupt": _base_corrupt,
    "checksum_corrupt": _checksum_corrupt,
}


def corrupt(arr: CompressedIntArray, cls: str, seed: int) -> Corruption | None:
    """Apply one named corruption class with a fixed seed.

    Returns ``None`` when the class doesn't apply to this array (wrong
    format / no checksum column / not differential).
    """
    try:
        fn = STREAM_CLASSES[cls]
    except KeyError:
        raise ValueError(f"unknown corruption class {cls!r}; expected one "
                         f"of {tuple(STREAM_CLASSES)}") from None
    return fn(arr, np.random.default_rng(seed))


# --- index-level corruption classes (TermPostings) -------------------------
def corrupt_skip_table(tp, seed: int):
    """Break skip-table monotonicity: swap a block's first/last bounds."""
    rng = np.random.default_rng(seed)
    b = _pick_block(tp.arr, rng)
    first = np.array(tp.first_doc)
    last = np.array(tp.last_doc)
    first[b], last[b] = last[b] + 1, first[b]
    return replace(tp, first_doc=first, last_doc=last)


def corrupt_max_impact(tp, seed: int):
    """Understate a block's ``max_impact`` bound (the MaxScore invariant
    violation: pruning with it silently drops true top-k results)."""
    rng = np.random.default_rng(seed)
    mi = np.array(tp.max_impact)
    live = np.flatnonzero(mi > 0)
    b = int(rng.choice(live)) if live.size else 0
    mi[b] = 0
    return replace(tp, max_impact=mi)


def corrupt_impacts(tp, seed: int):
    """Bit-flip a used byte of the per-posting impact stream."""
    if tp.impacts is None:
        return None
    c = _bit_flip(tp.impacts, np.random.default_rng(seed))
    return replace(tp, impacts=c.arr)


INDEX_CLASSES = {
    "skip_corrupt": corrupt_skip_table,
    "max_impact_under": corrupt_max_impact,
    "impact_bit_flip": corrupt_impacts,
}


# --- durability corruption classes (LiveIndex directory) --------------------
# These operate on a *closed* ``repro_torch.index.ingest.LiveIndex`` directory —
# the WAL files, segment dirs and manifest on disk — and model storage
# faults rather than in-memory stream corruption. The contract is
# **detect-or-recover** (tests/test_torch_ingest.py): reopening the directory
# either recovers to the exact acknowledged state (``expect="recover"``,
# minus ``ops_lost`` trailing ops for the sheared-tail classes, which model
# a crash *during* an append that was never acknowledged) or raises a
# typed ``WalError``/``SegmentError`` (``expect="detect"``). Silently
# serving wrong history is never an outcome.

@dataclass(frozen=True)
class DirCorruption:
    """One injected durability fault on a LiveIndex directory."""

    cls: str
    path: str  # file corrupted
    detail: str
    expect: str  # "recover" | "detect"
    ops_lost: int = 0  # trailing unacked-op shear (torn-tail classes only)


def _live_wals(directory: str):
    """Unmerged WAL paths in id order, with their record spans."""
    import json as _json
    import os as _os

    from repro_torch.index.wal import parse_wal_name, wal_path

    with open(_os.path.join(directory, "MANIFEST.json")) as f:
        merged = int(_json.load(f)["merged_wal"])
    ids = sorted(i for nm in _os.listdir(directory)
                 if (i := parse_wal_name(nm)) is not None and i > merged)
    return [wal_path(directory, i) for i in ids]


def _record_spans(path: str):
    """Byte spans ``[(start, end), ...]`` of each valid WAL record."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    hdr = struct.Struct("<II")
    spans, off = [], 0
    while off + hdr.size <= len(data):
        length, _ = hdr.unpack_from(data, off)
        end = off + hdr.size + length
        if end > len(data):
            break
        spans.append((off, end))
        off = end
    return spans


def _wal_torn_tail(directory, rng):
    """A crash mid-append: a half-written record at the tail of the active
    WAL. No acknowledged op is affected — recovery truncates it."""
    import os as _os
    wals = _live_wals(directory)
    if not wals:
        return None
    path = wals[-1]
    junk = bytes(rng.integers(0, 256, size=int(rng.integers(1, 7)),
                              dtype=np.uint8))
    with open(path, "ab") as f:
        f.write(junk)  # shorter than a header: unmistakably torn
    return DirCorruption("wal_torn_tail", path,
                         f"{len(junk)} partial bytes appended",
                         expect="recover", ops_lost=0)


def _wal_tail_shear(directory, rng):
    """A crash that tore the *final* append mid-record: truncate inside the
    last record. That op was still in flight (ack follows the fsync), so
    recovery legitimately rolls back exactly one op."""
    wals = _live_wals(directory)
    if not wals:
        return None
    path = wals[-1]
    spans = _record_spans(path)
    if not spans:
        return None
    s, e = spans[-1]
    cut = int(rng.integers(s + 1, e))
    with open(path, "r+b") as f:
        f.truncate(cut)
    return DirCorruption("wal_tail_shear", path,
                         f"truncated at {cut} inside record [{s},{e})",
                         expect="recover", ops_lost=1)


def _wal_record_flip(directory, rng):
    """Bit rot in an acknowledged, non-final WAL record — durable data
    after it proves this is not a torn append. Must detect (WalError)."""
    for path in _live_wals(directory):
        spans = _record_spans(path)
        if len(spans) >= 2:
            s, e = spans[int(rng.integers(len(spans) - 1))]
            i = int(rng.integers(s + 8, e))  # payload byte, not header
            with open(path, "r+b") as f:
                f.seek(i)
                b = f.read(1)[0]
                f.seek(i)
                f.write(bytes([b ^ (1 << int(rng.integers(8)))]))
            return DirCorruption("wal_record_flip", path,
                                 f"payload byte {i} bit-flipped",
                                 expect="detect")
    return None


def _wal_length_corrupt(directory, rng):
    """Corrupt a non-final record's length field (framing), keeping the
    claimed extent inside the file so it cannot pass as a torn tail.
    The mis-framed payload fails its CRC — must detect."""
    for path in _live_wals(directory):
        spans = _record_spans(path)
        if len(spans) >= 2:
            s, e = spans[int(rng.integers(len(spans) - 1))]
            new_len = max((e - s - 8) // 2, 1)  # shrink: stays in-file
            with open(path, "r+b") as f:
                f.seek(s)
                f.write(int(new_len).to_bytes(4, "little"))
            return DirCorruption("wal_length_corrupt", path,
                                 f"record at {s} length rewritten to "
                                 f"{new_len}", expect="detect")
    return None


def _segment_paths(directory):
    import json as _json
    import os as _os
    with open(_os.path.join(directory, "MANIFEST.json")) as f:
        man = _json.load(f)
    return [_os.path.join(directory, "segments", nm)
            for nm in man["segments"]]


def _segment_truncate(directory, rng):
    """Truncated segment payload (short write / lost extent). The
    whole-file CRC in segment.json must catch it — detect."""
    import os as _os
    segs = _segment_paths(directory)
    if not segs:
        return None
    npz = _os.path.join(segs[0], "postings.npz")
    size = _os.path.getsize(npz)
    cut = int(rng.integers(1, size))
    with open(npz, "r+b") as f:
        f.truncate(cut)
    return DirCorruption("segment_truncate", npz,
                         f"truncated {size} -> {cut} bytes", expect="detect")


def _segment_bit_flip(directory, rng):
    """Bit rot inside the segment payload — CRC must catch it."""
    import os as _os
    segs = _segment_paths(directory)
    if not segs:
        return None
    npz = _os.path.join(segs[0], "postings.npz")
    size = _os.path.getsize(npz)
    i = int(rng.integers(size))
    with open(npz, "r+b") as f:
        f.seek(i)
        b = f.read(1)[0]
        f.seek(i)
        f.write(bytes([b ^ (1 << int(rng.integers(8)))]))
    return DirCorruption("segment_bit_flip", npz,
                         f"byte {i} bit-flipped", expect="detect")


def _segment_meta_garbage(directory, rng):
    """Unparseable segment metadata for a manifest-listed segment —
    nothing to roll forward to, must detect."""
    import os as _os
    segs = _segment_paths(directory)
    if not segs:
        return None
    meta = _os.path.join(segs[0], "segment.json")
    with open(meta, "wb") as f:
        f.write(b"{ not json" + bytes(rng.integers(32, 127, size=8,
                                                   dtype=np.uint8)))
    return DirCorruption("segment_meta_garbage", meta,
                         "segment.json overwritten with garbage",
                         expect="detect")


def _manifest_garbage(directory, rng):
    """Unparseable manifest: the commit point itself is unreadable, so the
    acknowledged epoch is unknowable — must detect."""
    import os as _os
    path = _os.path.join(directory, "MANIFEST.json")
    with open(path, "wb") as f:
        f.write(bytes(rng.integers(0, 256, size=24, dtype=np.uint8)))
    return DirCorruption("manifest_garbage", path,
                         "MANIFEST.json overwritten with garbage",
                         expect="detect")


def _manifest_stale(directory, rng):
    """The manifest rolled back to a pre-merge version (e.g. restored from
    an old backup) while the merged segment survived and its drained WALs
    are gone. Recovery must adopt the newer segment (roll forward) — the
    segment is the only durable copy of that history."""
    import json as _json
    import os as _os
    path = _os.path.join(directory, "MANIFEST.json")
    with open(path) as f:
        man = _json.load(f)
    if man["epoch"] < 1 or not man["segments"]:
        return None  # needs a committed merge to stale away
    old = dict(man)
    old.update(epoch=man["epoch"] - 1, segments=[],
               merged_wal=max(man["merged_wal"] - 1, 0))
    with open(path, "w") as f:
        _json.dump(old, f)
    return DirCorruption("manifest_stale", path,
                         f"manifest rolled back to epoch {old['epoch']}",
                         expect="recover")


def _manifest_missing(directory, rng):
    """The manifest vanished entirely after a committed merge. Same roll-
    forward contract: the surviving segment + WAL suffix reconstruct the
    acknowledged state."""
    import json as _json
    import os as _os
    path = _os.path.join(directory, "MANIFEST.json")
    with open(path) as f:
        man = _json.load(f)
    if man["epoch"] < 1 or not man["segments"]:
        return None
    _os.remove(path)
    return DirCorruption("manifest_missing", path, "MANIFEST.json deleted",
                         expect="recover")


DURABILITY_CLASSES: dict[str, Callable[..., Any]] = {
    "wal_torn_tail": _wal_torn_tail,
    "wal_tail_shear": _wal_tail_shear,
    "wal_record_flip": _wal_record_flip,
    "wal_length_corrupt": _wal_length_corrupt,
    "segment_truncate": _segment_truncate,
    "segment_bit_flip": _segment_bit_flip,
    "segment_meta_garbage": _segment_meta_garbage,
    "manifest_garbage": _manifest_garbage,
    "manifest_stale": _manifest_stale,
    "manifest_missing": _manifest_missing,
}


def corrupt_dir(directory: str, cls: str, seed: int) -> DirCorruption | None:
    """Apply one named durability fault to a closed LiveIndex directory.

    Returns ``None`` when the class doesn't apply (no unmerged WAL
    records, no committed segment to corrupt, ...).
    """
    try:
        fn = DURABILITY_CLASSES[cls]
    except KeyError:
        raise ValueError(f"unknown durability class {cls!r}; expected one "
                         f"of {tuple(DURABILITY_CLASSES)}") from None
    return fn(directory, np.random.default_rng(seed))
