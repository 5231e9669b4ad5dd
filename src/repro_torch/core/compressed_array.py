"""Device-resident compressed integer arrays in three formats.

``CompressedIntArray`` is the port of ``repro/core/compressed_array.py``:
posting lists and id streams stored in a blocked layout (``block_size``
integers per block, each block independently decodable through its
``counts``/``bases`` entry) and decoded on the card by the kernels of
``repro_torch.kernels.vbyte_decode``. The format's leaves, as in the
reference's ``FORMAT_LEAVES``:

* ``"vbyte"``       — ``payload [n_blocks, stride]`` (kernel 1);
* ``"streamvbyte"`` — ``control [n_blocks, B/4]`` + ``data [n_blocks,
  stride]`` (kernel 3);
* ``"binpack"``     — ``widths [n_blocks, 1]`` + ``data [n_blocks, stride]``
  (kernel 4);

plus ``counts`` and ``bases`` for every format.

Placement: the leaves are tensors on one device — on the card by default —
and stay there for the array's lifetime. ``take_blocks``/``slice_blocks``
gather rows on that device (``index_select``), padding with count-0 blocks
to ``pad_to``; nothing is uploaded again per decode. The query engine
reads ``counts`` on the host for its accounting, so the array keeps a host
copy (``counts_host``) next to the device tensor and no probe pass waits
on the device for it. What does wait is :meth:`decode`, which copies the
decoded grid to the host: that is inherent to the host-driven query
engine.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch._device import resolve_device

from .vbyte import binpack as bpk
from .vbyte import encode as venc
from .vbyte import ref as vref
from .vbyte import stream_vbyte as svb

FORMATS = ("vbyte", "streamvbyte", "binpack")
# the leaves of each format, in the reference's order (block dim leads)
FORMAT_LEAVES = {
    "vbyte": ("payload", "counts", "bases"),
    "streamvbyte": ("control", "data", "counts", "bases"),
    "binpack": ("widths", "data", "counts", "bases"),
}
_ENCODERS = {"vbyte": (venc.encode_blocked, venc.encode_ragged_blocked),
             "streamvbyte": (svb.encode_blocked, svb.encode_ragged_blocked),
             "binpack": (bpk.encode_blocked, bpk.encode_ragged_blocked)}


def _check_format(format: str) -> None:
    if format not in FORMATS:
        raise ValueError(f"unknown format {format!r}; expected one of "
                         f"{FORMATS}")


def block_checksums(grid: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Per-block position-weighted checksum of a decoded value grid.

    ``cs[b] = (Σ_{j < counts[b]} grid[b, j] · (2j+1)) mod 2^32``, returned
    as ``int32 [n_blocks]`` (bit pattern of the uint32 sum). The device
    twin is the fused ``checksum`` epilogue.
    """
    g = np.asarray(grid, dtype=np.uint64) & np.uint64(0xFFFFFFFF)
    B = g.shape[1]
    w = (2 * np.arange(B, dtype=np.uint64) + 1)[None, :]
    valid = np.arange(B)[None, :] < np.asarray(counts).reshape(-1, 1)
    cs = (g * w * valid).sum(axis=1, dtype=np.uint64)
    return (cs & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)


@dataclass(frozen=True, eq=False)
class CompressedIntArray:
    """A compressed, block-decodable array of uint32 on one device.

    * ``payload`` — ``uint8 [n_blocks, stride]`` (vbyte)
    * ``control`` — ``uint8 [n_blocks, block_size // 4]`` (streamvbyte)
    * ``widths``  — ``uint8 [n_blocks, 1]`` per-block bit width (binpack)
    * ``data``    — ``uint8 [n_blocks, stride]`` (streamvbyte, binpack)
    * ``counts``  — ``int32 [n_blocks]`` valid integers per block
    * ``bases``   — ``int32 [n_blocks]`` differential carry-in (uint32 bits)
    * ``counts_host`` — numpy copy of ``counts`` (host-side accounting)

    A format's unused leaves are ``None``.
    """

    counts: torch.Tensor
    bases: torch.Tensor
    counts_host: np.ndarray
    format: str = "vbyte"
    payload: torch.Tensor | None = None
    control: torch.Tensor | None = None
    widths: torch.Tensor | None = None
    data: torch.Tensor | None = None
    block_size: int = 128
    differential: bool = False
    n: int = 0
    ragged: bool = False
    # tight compressed size (the paper's metric); None once blocks were
    # gathered (take_blocks/slice_blocks), as the reference drops host_enc
    payload_bytes: int | None = field(default=None, repr=False)
    # optional per-block checksum column (int32 [n_blocks], block_checksums)
    checksums: np.ndarray | None = field(default=None, repr=False)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_operands(cls, operands: dict, *, format: str = "vbyte",
                      block_size: int = 128, differential: bool = False,
                      n: int | None = None, ragged: bool = False,
                      payload_bytes: int | None = None, checksums=None,
                      device=None) -> "CompressedIntArray":
        """Wrap the format's leaves (numpy arrays or tensors; no
        re-encoding) and place them on ``device`` (default: the card).
        ``bases`` may be uint32 or int32; they are kept as int32 bits.
        ``n`` defaults to ``sum(counts)``."""
        _check_format(format)
        missing = [k for k in FORMAT_LEAVES[format] if k not in operands]
        if missing:
            raise ValueError(f"format {format!r} operands missing {missing}")
        dev = resolve_device(device)

        def host(x, dtype=None):
            # a writable contiguous copy where the caller's array is
            # read-only (a buffer handed over from another framework)
            x = x.cpu().numpy() if isinstance(x, torch.Tensor) else x
            return np.require(x, dtype, ["C", "W"])

        counts_host = host(operands["counts"], np.int32).reshape(-1)
        bases_bits = host(operands["bases"]).reshape(-1)
        if bases_bits.dtype != np.int32:
            bases_bits = bases_bits.astype(np.uint32).view(np.int32)
        leaves = {k: torch.as_tensor(host(operands[k], np.uint8), device=dev)
                  for k in FORMAT_LEAVES[format][:-2]}
        return cls(
            counts=torch.as_tensor(counts_host, device=dev),
            bases=torch.as_tensor(bases_bits, device=dev),
            counts_host=counts_host, format=format, block_size=block_size,
            differential=differential,
            n=int(counts_host.sum()) if n is None else int(n),
            ragged=ragged, payload_bytes=payload_bytes,
            checksums=None if checksums is None else np.asarray(checksums),
            **leaves)

    @classmethod
    def from_encoding(cls, enc, format: str, *, checksums=None,
                      device=None) -> "CompressedIntArray":
        """Place a host encoding (``BlockedEncoding``,
        ``StreamVByteEncoding`` or ``BinpackEncoding``) on ``device``."""
        return cls.from_operands(
            {k: getattr(enc, k) for k in FORMAT_LEAVES[format]},
            format=format, block_size=enc.block_size,
            differential=enc.differential, n=enc.n,
            ragged=enc.ragged, payload_bytes=enc.payload_bytes,
            checksums=checksums, device=device)

    @classmethod
    def encode(
        cls,
        values: np.ndarray | None = None,
        *,
        format: str = "vbyte",
        block_size: int = 128,
        differential: bool = False,
        stride_multiple: int = 128,
        wrap: bool = False,
        checksum: bool = False,
        meta=None,
        device=None,
    ) -> "CompressedIntArray":
        """Encode ``values`` (or a pre-computed ``BlockedMeta`` via
        ``meta=``) on the host and place the leaves on ``device``."""
        _check_format(format)
        dev = resolve_device(device)
        if meta is None:
            meta = venc.prepare_blocked(
                values, block_size=block_size, differential=differential,
                wrap=wrap)
        enc = _ENCODERS[format][0](stride_multiple=stride_multiple, meta=meta)
        cs = None
        if checksum:
            # checksum the decoded (absolute) values, padded to the grid
            grid = np.zeros((enc.counts.shape[0], meta.block_size), np.uint64)
            grid.reshape(-1)[: meta.values.size] = meta.values
            cs = block_checksums(grid, enc.counts)
        return cls.from_encoding(enc, format, checksums=cs, device=dev)

    @classmethod
    def encode_ragged(
        cls,
        lists,
        *,
        format: str = "vbyte",
        block_size: int = 128,
        differential: bool = False,
        stride_multiple: int = 128,
        wrap: bool = False,
        checksum: bool = False,
        device=None,
    ) -> "CompressedIntArray":
        """Encode ragged id bags: block b holds list b (≤ block_size ids)."""
        _check_format(format)
        dev = resolve_device(device)
        enc = _ENCODERS[format][1](
            lists, block_size=block_size, differential=differential,
            stride_multiple=stride_multiple, wrap=wrap)
        cs = None
        if checksum:
            vpad, counts = venc.ragged_block_values(
                lists, block_size=block_size, differential=False, wrap=wrap)
            cs = block_checksums(vpad, counts)
        return cls.from_encoding(enc, format, checksums=cs, device=dev)

    # -- metadata ----------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return self.counts_host.shape[0]

    @property
    def stride(self) -> int:
        """Byte width of the main byte leaf (``payload`` or ``data``)."""
        main = self.payload if self.format == "vbyte" else self.data
        return main.shape[1]

    @property
    def device(self) -> torch.device:
        return self.counts.device

    @property
    def resident_bytes(self) -> int:
        """Bytes the leaves hold on the device (padding included)."""
        return sum(t.numel() * t.element_size()
                   for t in self.device_operands().values())

    def _encoded_size(self, what: str) -> int:
        if self.payload_bytes is None:
            raise RuntimeError(
                f"{what} needs the encoded size, which an array built by "
                "take_blocks/slice_blocks no longer carries; compute it on "
                "the array returned by encode()")
        return self.payload_bytes

    @property
    def bits_per_int(self) -> float:
        return 8.0 * self._encoded_size("bits_per_int") / max(self.n, 1)

    @property
    def compression_ratio(self) -> float:
        """Raw uint32 bytes / tight compressed bytes (the paper's framing)."""
        return 4.0 * self.n / max(self._encoded_size("compression_ratio"), 1)

    # -- device form --------------------------------------------------------
    def device_operands(self) -> dict[str, torch.Tensor]:
        """The format's leaves, as consumed by the decoders and kernels."""
        return {k: getattr(self, k) for k in FORMAT_LEAVES[self.format]}

    def leaves_numpy(self) -> dict[str, np.ndarray]:
        """Host copies of the leaves: byte leaves uint8, counts int32,
        bases uint32."""
        out = {k: t.cpu().numpy() for k, t in self.device_operands().items()}
        out["bases"] = out["bases"].view(np.uint32)
        return out

    def to(self, device) -> "CompressedIntArray":
        dev = resolve_device(device)
        return replace(self, **{k: t.to(dev)
                                for k, t in self.device_operands().items()})

    def slice_blocks(self, start: int, stop: int, *,
                     pad_to: int | None = None) -> "CompressedIntArray":
        """Contiguous block range ``[start, stop)`` as a new array (see
        :meth:`take_blocks`)."""
        return self.take_blocks(np.arange(start, stop), pad_to=pad_to)

    def take_blocks(self, blocks, *, pad_to: int | None = None
                    ) -> "CompressedIntArray":
        """Arbitrary block subset (row gather on the device) as a new array.

        Blocks decode independently, so any subset is itself a valid
        compressed array — what skip-table pruning decodes instead of whole
        posting lists. ``pad_to`` appends count-0 blocks up to a fixed
        block count, so pruned decodes hit a bounded set of shapes.
        """
        idx = np.asarray(blocks, dtype=np.int64).reshape(-1)
        k = idx.size
        rows = max(k, pad_to or 0)
        idx_t = torch.as_tensor(idx, device=self.device)

        def gather(t: torch.Tensor) -> torch.Tensor:
            g = t.index_select(0, idx_t)
            if rows == k:
                return g
            out = torch.zeros((rows,) + tuple(t.shape[1:]), dtype=t.dtype,
                              device=t.device)
            out[:k] = g
            return out

        counts_host = np.zeros(rows, np.int32)
        counts_host[:k] = self.counts_host[idx]
        cs = None
        if self.checksums is not None:  # count-0 pad blocks checksum to 0
            cs = np.zeros(rows, np.int32)
            cs[:k] = self.checksums[idx]
        return replace(self, counts_host=counts_host, n=int(counts_host.sum()),
                       payload_bytes=None, checksums=cs,
                       **{name: gather(t)
                          for name, t in self.device_operands().items()})

    # -- decoding ------------------------------------------------------------
    def decode_blocked(self, *, plan="auto") -> torch.Tensor:
        """Decode on the device to the int32 (uint32 bits)
        ``[n_blocks, block_size]`` grid (see ``kernels.vbyte_decode.dispatch``)."""
        from repro_torch.kernels.vbyte_decode import dispatch

        return dispatch.decode(self, plan=plan)

    def decode(self, *, plan="auto", check: bool = False) -> np.ndarray:
        """Decode to host ``uint32[n]``: each block's valid prefix,
        concatenated. (Not a flat ``[:n]`` trim — a ``take_blocks`` gather
        can put a partial block before a full one.)

        ``check=True`` decodes through kernel 2's ``checksum`` epilogue and
        verifies the per-block column written by ``encode(checksum=True)``
        in the same pass, raising
        :class:`repro_torch.robustness.validate.ChecksumError` (with block
        coordinates) on a mismatch."""
        if check:
            from repro_torch.robustness.validate import decode_checked

            grid = decode_checked(self, plan=plan)
        else:
            grid = self.decode_blocked(plan=plan)
        grid = grid.cpu().numpy().view(np.uint32)
        mask = (np.arange(self.block_size)[None, :]
                < self.counts_host[:, None])
        return grid[mask]

    def decode_scalar_oracle(self) -> np.ndarray:
        """Byte-at-a-time reference decode (slow; tests only)."""
        lv = self.leaves_numpy()
        kw = dict(differential=self.differential)
        meta = (lv["counts"], lv["bases"], self.block_size)
        if self.format == "streamvbyte":
            out = svb.decode_blocked_scalar(lv["control"], lv["data"], *meta,
                                            **kw)
        elif self.format == "binpack":
            out = bpk.decode_blocked_scalar(lv["widths"], lv["data"], *meta,
                                            **kw)
        else:
            out = vref.decode_blocked_scalar(lv["payload"], *meta, **kw)
        mask = (np.arange(self.block_size)[None, :]
                < self.counts_host[:, None])
        return out[mask].astype(np.uint32)
