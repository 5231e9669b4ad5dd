"""Checksummed write-ahead log for the live index.

The port of ``repro/index/wal.py`` (host code: the record format is the
reference's byte for byte, so a WAL written by either package replays in
the other to the same ops). Every mutation of a
:class:`repro_torch.index.ingest.LiveIndex` is appended here
*before* it is applied in memory or acknowledged to the caller, so that a
crash at any instant replays to exactly the acknowledged state.

Record framing (little-endian)::

    [u32 payload_length][u32 crc32(payload)][payload]

where ``payload`` is one operation as canonical JSON (sorted keys, no
whitespace), e.g. ``{"doc":7,"op":"add","terms":{"3":2}}`` or
``{"doc":7,"op":"del"}``. JSON keeps the log self-describing and
debuggable (``python -m repro_torch.index.wal <file>`` dumps it); framing + CRC
make corruption detection independent of the payload encoding.

Reader contract (the detect-or-recover split):

* **Torn tail → recover.** An incomplete header, a payload extending past
  EOF, or a CRC/JSON failure on the *final* record is the signature of a
  crash mid-append: only the one record that was never acknowledged can be
  affected (``append`` fsyncs before returning). The reader truncates to
  the last valid prefix and recovery proceeds — no acked write is lost.
* **Mid-log corruption → detect.** A CRC/framing failure on a record with
  durable data *after* it cannot be a torn append — it means acknowledged
  bytes changed under us. That raises :class:`WalError`; serving wrong
  history silently is never an option.

Known limitation (inherent to any log without an external length oracle):
corruption that truncates the file *exactly* at a record boundary, or a
bogus length field that happens to claim an extent past EOF, is
indistinguishable from a torn tail and recovers the shorter prefix. The
fault classes in ``robustness/faultgen.py`` exercise the distinguishable
cases; the manifest's ``merged_wal`` watermark bounds how much history a
boundary-truncation could ever silently drop to the unmerged suffix.
"""
from __future__ import annotations

import json
import os
import struct
import time
import zlib

from repro_torch.obs import histogram_observe as _obs_histogram_observe
from repro_torch.robustness.atomic_io import fsync_dir
from repro_torch.robustness.validate import WalError

_HDR = struct.Struct("<II")

# Sanity bound on one record's payload. A real op is tens to hundreds of
# bytes; anything claiming more is framing corruption, not data.
MAX_RECORD_BYTES = 1 << 20


def wal_name(wal_id: int) -> str:
    return f"wal_{wal_id:08d}.log"


def wal_path(directory: str, wal_id: int) -> str:
    return os.path.join(directory, wal_name(wal_id))


def parse_wal_name(name: str) -> int | None:
    """``wal_00000003.log`` -> 3; None for anything else."""
    if not (name.startswith("wal_") and name.endswith(".log")):
        return None
    mid = name[4:-4]
    return int(mid) if mid.isdigit() else None


def encode_record(op: dict) -> bytes:
    payload = json.dumps(op, sort_keys=True, separators=(",", ":")).encode("utf-8")
    if len(payload) > MAX_RECORD_BYTES:
        raise ValueError(f"WAL record too large: {len(payload)} bytes")
    return _HDR.pack(len(payload), zlib.crc32(payload) & 0xFFFFFFFF) + payload


class WalWriter:
    """Append-only writer. ``append`` returns only after the record is
    written, flushed and (by default) fsynced — the durability point that
    lets the caller acknowledge the op."""

    def __init__(self, path: str, *, fsync: bool = True):
        self.path = path
        self.fsync = fsync
        self._f = open(path, "ab")

    def append(self, op: dict) -> int:
        """Durably append one op; returns the byte offset after it."""
        rec = encode_record(op)
        t0 = time.perf_counter()
        self._f.write(rec)
        self._f.flush()
        if self.fsync:
            os.fsync(self._f.fileno())
        _obs_histogram_observe("wal_append_seconds",
                               time.perf_counter() - t0,
                               fsync=self.fsync)
        _obs_histogram_observe("wal_record_bytes", len(rec))
        return self._f.tell()

    def tell(self) -> int:
        return self._f.tell()

    def close(self) -> None:
        if not self._f.closed:
            self._f.flush()
            self._f.close()


def read_wal(path: str) -> tuple[list[dict], int]:
    """Parse a WAL; returns ``(ops, valid_bytes)``.

    ``valid_bytes`` is the length of the longest valid prefix. If it is
    shorter than the file, the remainder is a torn tail (recoverable by
    truncation). Mid-log corruption raises :class:`WalError` — see module
    docstring for the exact split.
    """
    with open(path, "rb") as f:
        data = f.read()
    n = len(data)
    ops: list[dict] = []
    off = 0
    while off < n:
        if n - off < _HDR.size:
            break  # torn: header sheared mid-write
        length, crc = _HDR.unpack_from(data, off)
        end = off + _HDR.size + length
        if length > MAX_RECORD_BYTES:
            if end > n:
                break  # claims past EOF: indistinguishable from torn tail
            raise WalError(
                f"WAL record at offset {off} claims {length} bytes "
                f"(> MAX_RECORD_BYTES) with data following — framing corrupt",
                format="wal")
        if end > n:
            break  # torn: payload sheared mid-write
        payload = data[off + _HDR.size:end]
        if zlib.crc32(payload) & 0xFFFFFFFF != crc:
            if end >= n:
                break  # final record garbage -> torn tail
            raise WalError(
                f"WAL CRC mismatch at offset {off} with {n - end} durable "
                f"bytes following — acknowledged data corrupted",
                format="wal", block=len(ops))
        try:
            op = json.loads(payload)
        except ValueError:
            if end >= n:
                break
            raise WalError(
                f"WAL record at offset {off} is not valid JSON with data "
                f"following", format="wal", block=len(ops))
        if not isinstance(op, dict) or op.get("op") not in ("add", "del"):
            raise WalError(f"WAL record at offset {off} has unknown op "
                           f"{op!r}", format="wal", block=len(ops))
        ops.append(op)
        off = end
    return ops, off


def open_wal(path: str, *, fsync: bool = True) -> tuple[list[dict], "WalWriter"]:
    """Open a WAL for append: replay its valid prefix, truncate any torn
    tail, and return ``(ops, writer)`` positioned at the end."""
    ops: list[dict] = []
    if os.path.exists(path):
        ops, valid = read_wal(path)
        if valid != os.path.getsize(path):
            with open(path, "r+b") as f:
                f.truncate(valid)
                f.flush()
                if fsync:
                    os.fsync(f.fileno())
    else:
        # create durably so the file survives a crash right after rotation
        with open(path, "ab") as f:
            if fsync:
                os.fsync(f.fileno())
        if fsync:
            fsync_dir(os.path.dirname(os.path.abspath(path)))
    return ops, WalWriter(path, fsync=fsync)


def main(argv=None):  # pragma: no cover - debugging aid
    import sys
    for p in (argv or sys.argv[1:]):
        ops, valid = read_wal(p)
        torn = os.path.getsize(p) - valid
        print(f"{p}: {len(ops)} records, {valid} valid bytes"
              + (f", torn tail of {torn} bytes" if torn else ""))
        for i, op in enumerate(ops):
            print(f"  [{i}] {op}")


if __name__ == "__main__":  # pragma: no cover
    main()
