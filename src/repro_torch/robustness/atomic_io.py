"""Crash-consistent filesystem primitives (tmp + fsync + rename).

The port's copy of ``repro/robustness/atomic_io.py`` (standard library
only): one implementation of the atomic-write protocol for every layer
that persists state (index segments and the ingestion manifest, train
checkpoints). The protocol is the classic POSIX one:

1. write the complete content under a temporary name in the *same*
   directory (same filesystem — rename must not degrade to copy),
2. flush + ``fsync`` the content so the bytes are durable before the name,
3. ``rename``/``replace`` onto the final name (atomic on POSIX: readers
   see either the old complete state or the new complete state, never a
   torn mix),
4. ``fsync`` the parent directory so the *name* survives a crash too.

A crash at any point leaves either the old state intact (tmp names are
ignored and garbage-collected by :func:`clean_tmp`) or the new state
complete. Nothing in between is ever visible under a final name.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib

TMP_PREFIX = ".tmp_"


def _tmp_name(final_path: str) -> str:
    d, base = os.path.split(os.path.abspath(final_path))
    return os.path.join(d, f"{TMP_PREFIX}{base}_{os.getpid()}_{time.time_ns()}")


def fsync_file(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def fsync_dir(path: str) -> None:
    """Durably persist directory entries (created/renamed names)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write_bytes(path: str, data: bytes, *, fsync: bool = True) -> None:
    """Atomically replace ``path`` with ``data`` (tmp + fsync + rename)."""
    tmp = _tmp_name(path)
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        if fsync:
            os.fsync(f.fileno())
    os.replace(tmp, path)
    if fsync:
        fsync_dir(os.path.dirname(os.path.abspath(path)))


def atomic_write_json(path: str, obj, *, fsync: bool = True) -> None:
    atomic_write_bytes(path, json.dumps(obj, indent=1).encode("utf-8"),
                       fsync=fsync)


def atomic_write_dir(final_dir: str, fill, *, fsync: bool = True) -> None:
    """Atomically materialize a directory: ``fill(tmp_dir)`` writes the
    complete content, then the tmp dir is fsynced file-by-file and renamed
    onto ``final_dir``. Used for checkpoint steps and index segments —
    partial writes never carry the final name.

    When ``final_dir`` already exists, POSIX offers no atomic non-empty
    directory swap: the old version is first renamed *away* to a tmp name,
    the new one renamed in, and only then is the old tree deleted. A crash
    in the (two-rename) window leaves no final name — readers that replace
    a live directory must tolerate its momentary absence by falling back
    to an older step; the old content is never deleted before the new name
    is durably in place."""
    tmp = _tmp_name(final_dir)
    os.makedirs(tmp)
    try:
        fill(tmp)
        if fsync:
            for root, _dirs, files in os.walk(tmp):
                for f in files:
                    fsync_file(os.path.join(root, f))
                fsync_dir(root)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    old = None
    if os.path.exists(final_dir):
        old = _tmp_name(final_dir)
        os.rename(final_dir, old)
    try:
        os.rename(tmp, final_dir)
    except BaseException:
        if old is not None:  # put the previous version back under its name
            os.rename(old, final_dir)
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    if fsync:
        fsync_dir(os.path.dirname(os.path.abspath(final_dir)))
    if old is not None:
        shutil.rmtree(old, ignore_errors=True)


def clean_tmp(directory: str) -> int:
    """Garbage-collect orphaned tmp files/dirs left by a crash mid-write.

    Safe at any time: tmp names are never referenced by a manifest or a
    final name, so removing them can only reclaim space. Returns the
    number of entries removed."""
    removed = 0
    try:
        entries = os.listdir(directory)
    except OSError:
        return 0
    for e in entries:
        if e.startswith(TMP_PREFIX):
            p = os.path.join(directory, e)
            if os.path.isdir(p):
                shutil.rmtree(p, ignore_errors=True)
            else:
                try:
                    os.remove(p)
                except OSError:
                    pass
            removed += 1
    return removed


def crc32_file(path: str) -> int:
    """Whole-file CRC32 — the cheap integrity stamp segment manifests
    store next to their npz payloads (detects truncation and bit rot
    deterministically at load)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(chunk, crc)
