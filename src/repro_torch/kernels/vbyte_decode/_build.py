"""Build and load the hand-written CUDA kernels of this package.

Each ``<kernels package>/csrc/*.cu`` file is compiled on first use by
``nvcc`` into its own shared library with a plain C interface, and loaded
with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/lib<name>-<hash>.so csrc/<name>.cu

A source is named by its file's stem and its directory: this package's
``csrc/`` (``CSRC``) by default, or another kernels package's, which
passes its own (``kernels/segment_sum`` for ``owner_sum``). The library
name carries a hash of the sources it was built from, so an edited kernel
is rebuilt and a stale library is never loaded. Libraries go to
``build/`` beside the source directory (listed in ``.gitignore``).
Nothing here runs at import time: the CPU-only test environment imports
every module and has no ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
# C signatures of the entry points in each source (restype is always int:
# the cudaError_t of the launch)
SIGNATURES = {
    "vbyte_decode": {
        "vbyte_decode_blocked_launch": [_P, _P, _P, _P, _LL, _I, _I, _I, _P],
    },
    "stream_decode": {
        "stream_decode_blocked_launch": [_P, _P, _P, _P, _P, _LL, _I, _I, _I,
                                         _P],
    },
    "binpack_decode": {
        "binpack_decode_blocked_launch": [_P, _P, _P, _P, _P, _LL, _I, _I, _I,
                                          _P],
    },
    "fused_decode": {
        # format, epilogue, bytes, meta, S, counts, bases, nb, B,
        # differential, probe, P, impact, w_format, w_bytes, w_meta, S_w,
        # table, V, d, table_bf16, query, nq, round_bf16, edge_base,
        # out, out2, fout, stream
        "fused_decode_launch": [_I, _I, _P, _P, _I, _P, _P, _LL, _I, _I, _P,
                                _I, _P, _I, _P, _P, _I,
                                _P, _LL, _I, _I, _P, _I, _I, _P,
                                _P, _P, _P, _P],
    },
    "owner_sum": {
        # h, ld, d, h_bf16, gran, src, row_offsets, order, n_long,
        # n_owners, lanes, out, out_ld, round_bf16, counter, stream
        "owner_sum_launch": [_P, _LL, _I, _I, _I, _P, _P, _P, _P, _LL,
                             _I, _P, _LL, _I, _P, _P],
    },
}
# this package's sources, as build() takes them
SOURCES = tuple((name, CSRC) for name in ("vbyte_decode", "stream_decode",
                                          "binpack_decode", "fused_decode"))
ERROR_STRING = {"vbyte_decode": "vbyte_error_string",
                "stream_decode": "stream_error_string",
                "binpack_decode": "binpack_error_string",
                "fused_decode": "fused_error_string",
                "owner_sum": "owner_sum_error_string"}


@dataclass
class LaunchCounter:
    """Plain count of kernel launches, bumped by a wrapper where it launches
    its kernel and nowhere else — how a run shows it went through it.
    ``by`` splits the count by variant (the fused kernel's
    ``"format/epilogue"``)."""

    count: int = 0
    by: dict = field(default_factory=dict)

    def bump(self, key: str | None = None) -> None:
        self.count += 1
        if key is not None:
            self.by[key] = self.by.get(key, 0) + 1

    def reset(self) -> None:
        self.count = 0
        self.by.clear()


@dataclass
class BuildResult:
    name: str
    path: Path
    seconds: float  # 0.0 when the library was already built
    ptxas: list[str]  # the -Xptxas -v lines (registers, shared memory, spills)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = shutil.which("nvcc")
    if cand is None and CUDA_HOME:
        cand = os.path.join(CUDA_HOME, "bin", "nvcc")
    if cand is None or not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                           "CUDA toolkit's nvcc on a machine with a GPU")
    return cand


def _lib_path(name: str, csrc: Path) -> Path:
    h = hashlib.sha256()
    for src in sorted(csrc.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return csrc.parent / "build" / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(sources=SOURCES) -> dict[str, BuildResult]:
    """Compile every ``(name, csrc)`` source (``csrc/<name>.cu``) that is
    not built yet, all at once (one ``nvcc`` process per source, started
    together). Raises if one fails."""
    nvcc = None
    procs = {}
    done = {}
    for name, src_dir in sources:
        path = _lib_path(name, src_dir)
        if path.exists():
            done[name] = BuildResult(name, path, 0.0, [])
            continue
        path.parent.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc or _nvcc()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src_dir / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, path, time.perf_counter())
    for name, (proc, tmp, path, t0) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
        os.replace(tmp, path)
        lines = [ln.strip() for ln in out.splitlines() if "ptxas" in ln]
        done[name] = BuildResult(name, path, time.perf_counter() - t0, lines)
    return done


class _Library:
    """A loaded kernel library: its C entry points with argtypes set."""

    def __init__(self, name: str, path: Path):
        self._lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES[name].items():
            f = getattr(self._lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        err = getattr(self._lib, ERROR_STRING[name])
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        self._err = err

    def call(self, fn: str, *args) -> None:
        """Launch through entry point ``fn``; raise on a non-zero cudaError_t."""
        code = getattr(self._lib, fn)(*args)
        if code != 0:
            raise RuntimeError(
                f"{fn} failed: {self._err(code).decode()} (cudaError {code})")


_LOADED: dict[tuple[str, Path], _Library] = {}
_LOAD_LOCK = threading.Lock()  # a merge thread and a query thread may both
#   reach a library's first use


def library(name: str, csrc: Path = CSRC) -> _Library:
    """The built and loaded library for ``<csrc>/<name>.cu`` (built on
    first use)."""
    key = (name, csrc)
    lib = _LOADED.get(key)
    if lib is None:
        with _LOAD_LOCK:
            lib = _LOADED.get(key)
            if lib is None:
                lib = _LOADED[key] = _Library(name,
                                              build((key,))[name].path)
    return lib
