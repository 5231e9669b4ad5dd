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
(``SearchEngine.kill_shard``). The reference's durability classes (WAL
and segment files of a live index) come with the port of ingestion.
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
