"""Checkpointing: atomic, resumable, async-capable, VByte-compressed ints.

The port of ``repro/checkpoint/manager.py``, with its on-disk layout:
``<dir>/step_<N>/{manifest.json, leaves.npz}``, written through
:func:`repro_torch.robustness.atomic_io.atomic_write_dir` (a tmp dir,
fsync per file, a rename), so a partial write never carries the final
name. A state is a tree (nested dicts, lists and tuples of tensors,
numpy arrays or Python scalars) whose leaves are written in the
reference's leaf order under its paths (:mod:`repro_torch.tree`);
integer leaves are zigzag + VByte coded inside the npz where that is
smaller, bf16 leaves stored as their uint16 bits. So a directory written
by either package restores in the other.

Restart: ``restore_latest(example_state)`` → ``(state, step)``, the
leaves as CPU tensors in the example's structure. A truncated or corrupt
``leaves.npz`` or ``manifest.json`` raises
:class:`~repro_torch.robustness.validate.CheckpointError`, and
``restore_latest`` skips back to the newest intact step.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zipfile

import numpy as np
import torch

from repro_torch.core.vbyte.encode import encode_stream
from repro_torch.core.vbyte.masked import decode_stream
from repro_torch.core.vbyte.ref import decode_stream_scalar
from repro_torch.robustness.atomic_io import atomic_write_dir
from repro_torch.robustness.validate import CheckpointError
from repro_torch.tree import flatten, unflatten_like

_INT_KINDS = ("i", "u")
BF16 = "bfloat16"


def _zigzag(x: np.ndarray) -> np.ndarray:
    x64 = x.astype(np.int64)
    return ((x64 << 1) ^ (x64 >> 63)).astype(np.uint64)


def _unzigzag(z: np.ndarray) -> np.ndarray:
    z = z.astype(np.int64)  # values < 2^33 after zigzag of int32 range
    return (z >> 1) ^ -(z & 1)


def _host(x) -> tuple[np.ndarray, str]:
    """A copy of a leaf on the host and its dtype's name (bf16 as its
    uint16 bits, named ``bfloat16`` as numpy's bfloat16 is)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().to("cpu", copy=True)
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), BF16
        a = x.numpy()
    else:
        a = np.array(x)
    return a, str(a.dtype)


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3,
                 compress_ints: bool = True):
        self.dir = directory
        self.keep = keep
        self.compress_ints = compress_ints
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, state, *, async_: bool = False):
        """Write ``state`` as step ``step``; its leaves are copied to the
        host now, so the caller may go on updating them. ``async_`` writes
        the copies in a thread (:meth:`wait` joins it)."""
        host = [(path, *_host(x)) for path, x in flatten(state)]
        if async_:
            self.wait()
            self._thread = threading.Thread(target=self._write,
                                            args=(step, host))
            self._thread.start()
        else:
            self._write(step, host)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host_leaves):
        arrays, manifest = {}, {"step": step, "leaves": []}
        for i, (name, arr, dtype) in enumerate(host_leaves):
            key = f"leaf_{i}"
            entry = {"name": name, "key": key, "dtype": dtype,
                     "shape": list(arr.shape), "codec": "raw"}
            if dtype == BF16:
                arrays[key] = arr
                entry["codec"] = "bf16_as_u16"
            elif (self.compress_ints and arr.dtype.kind in _INT_KINDS
                    and arr.size > 0 and arr.dtype.itemsize <= 8):
                z = _zigzag(arr.reshape(-1))
                if z.size and int(z.max()) <= 0xFFFFFFFF:
                    stream = encode_stream(z)
                    if stream.nbytes < arr.nbytes:  # only keep wins
                        arrays[key] = stream
                        entry["codec"] = "vbyte_zigzag"
            if entry["codec"] == "raw":
                arrays[key] = arr
            manifest["leaves"].append(entry)

        def fill(tmp):
            np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)

        atomic_write_dir(os.path.join(self.dir, f"step_{step:08d}"), fill)
        self._prune()

    def _prune(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_"))

    def restore(self, step: int, example_state):
        """Restore one step into ``example_state``'s structure, leaves as
        CPU tensors; raises :class:`CheckpointError` if its manifest or
        leaves are unreadable or inconsistent (truncated npz, garbage
        json, missing keys, shape or codec mismatches)."""
        d = os.path.join(self.dir, f"step_{step:08d}")
        try:
            with open(os.path.join(d, "manifest.json")) as f:
                manifest = json.load(f)
            data = np.load(os.path.join(d, "leaves.npz"))
            leaves = []
            for entry in manifest["leaves"]:
                raw = data[entry["key"]]
                shape = tuple(entry["shape"])
                if entry["codec"] == "vbyte_zigzag":
                    n = int(np.prod(shape)) if shape else 1
                    z = (decode_stream_scalar(raw, n) if n < 4096 else
                         decode_stream(torch.from_numpy(raw), n,
                                       nbytes=len(raw))[0].numpy()
                         .view(np.uint32).astype(np.uint64))
                    arr = _unzigzag(z).astype(np.dtype(entry["dtype"]))
                    leaves.append(torch.from_numpy(arr.reshape(shape)))
                elif entry["codec"] == "bf16_as_u16":
                    bits = raw.view(np.int16).reshape(shape)
                    leaves.append(torch.from_numpy(bits.copy())
                                  .view(torch.bfloat16))
                else:
                    arr = raw.astype(np.dtype(entry["dtype"])).reshape(shape)
                    leaves.append(torch.from_numpy(arr))
        except (OSError, ValueError, KeyError, TypeError, IndexError,
                zipfile.BadZipFile) as e:
            raise CheckpointError(
                f"checkpoint step {step} unreadable: {e}") from e
        return unflatten_like(example_state, leaves)

    def restore_latest(self, example_state):
        """The newest intact checkpoint as ``(state, step)``, or ``(None,
        -1)``: a step whose files are truncated or corrupt is skipped (an
        older consistent state beats a crash loop on a broken one)."""
        for step in reversed(self.steps()):
            try:
                return self.restore(step, example_state), step
            except CheckpointError:
                continue
        return None, -1
