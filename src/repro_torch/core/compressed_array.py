"""Device-resident compressed integer arrays (format ``"vbyte"``).

``CompressedIntArray`` is the port of ``repro/core/compressed_array.py``:
posting lists and id streams stored in the blocked VByte layout
(``block_size`` integers per block, each block independently decodable
through its ``counts``/``bases`` entry) and decoded on the card by the
kernels of ``repro_torch.kernels.vbyte_decode``.

Placement: the leaves are tensors on one device — on the card by default —
and stay there for the array's lifetime. ``take_blocks``/``slice_blocks``
gather rows on that device (``index_select``), padding with count-0 blocks
to ``pad_to``; nothing is uploaded again per decode. The query engine
reads ``counts`` on the host for its accounting, so the array keeps a host
copy (``counts_host``) next to the device tensor and no probe pass waits
on the device for it. What does wait is :meth:`decode`, which copies the
decoded grid to the host: that is inherent to the host-driven query
engine.

Only the vbyte format is ported; ``"streamvbyte"`` and ``"binpack"`` raise
``NotImplementedError`` (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace

import numpy as np
import torch

from repro_torch._device import resolve_device

from .vbyte import encode as venc
from .vbyte import ref as vref

FORMATS = ("vbyte",)
_NOT_PORTED = ("format={!r} is not ported yet (ROADMAP queue 1 item 8, "
               "slice B: Stream-VByte, binpack and the auto partition)")


def _check_format(format: str) -> None:
    if format in ("streamvbyte", "binpack", "auto"):
        raise NotImplementedError(_NOT_PORTED.format(format))
    if format not in FORMATS:
        raise ValueError(f"unknown format {format!r}; expected one of "
                         f"('vbyte', 'streamvbyte', 'binpack')")


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

    * ``payload`` — ``uint8 [n_blocks, stride]``
    * ``counts``  — ``int32 [n_blocks]`` valid integers per block
    * ``bases``   — ``int32 [n_blocks]`` differential carry-in (uint32 bits)
    * ``counts_host`` — numpy copy of ``counts`` (host-side accounting)
    """

    payload: torch.Tensor
    counts: torch.Tensor
    bases: torch.Tensor
    counts_host: np.ndarray
    format: str = "vbyte"
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
    def from_host(cls, payload, counts, bases, *, block_size: int,
                  differential: bool, n: int | None = None,
                  payload_bytes: int | None = None, ragged: bool = False,
                  checksums=None, device=None) -> "CompressedIntArray":
        """Place host leaves (numpy) on ``device`` (default: the card).
        ``bases`` may be uint32 or int32; they are kept as int32 bits."""
        dev = resolve_device(device)
        counts_host = np.ascontiguousarray(counts, dtype=np.int32).reshape(-1)
        bases_bits = np.ascontiguousarray(bases).reshape(-1)
        if bases_bits.dtype != np.int32:
            bases_bits = bases_bits.astype(np.uint32).view(np.int32)
        return cls(
            payload=torch.as_tensor(np.ascontiguousarray(payload, np.uint8),
                                    device=dev),
            counts=torch.as_tensor(counts_host, device=dev),
            bases=torch.as_tensor(bases_bits, device=dev),
            counts_host=counts_host, format="vbyte", block_size=block_size,
            differential=differential,
            n=int(counts_host.sum()) if n is None else int(n),
            ragged=ragged, payload_bytes=payload_bytes,
            checksums=None if checksums is None else np.asarray(checksums))

    @classmethod
    def from_encoding(cls, enc: venc.BlockedEncoding, *, checksums=None,
                      device=None) -> "CompressedIntArray":
        return cls.from_host(enc.payload, enc.counts, enc.bases,
                             block_size=enc.block_size,
                             differential=enc.differential, n=enc.n,
                             payload_bytes=enc.payload_bytes,
                             ragged=enc.ragged, checksums=checksums,
                             device=device)

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
        enc = venc.encode_blocked(stride_multiple=stride_multiple, meta=meta)
        cs = None
        if checksum:
            # checksum the decoded (absolute) values, padded to the grid
            grid = np.zeros((enc.counts.shape[0], meta.block_size), np.uint64)
            grid.reshape(-1)[: meta.values.size] = meta.values
            cs = block_checksums(grid, enc.counts)
        return cls.from_encoding(enc, checksums=cs, device=dev)

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
        enc = venc.encode_ragged_blocked(
            lists, block_size=block_size, differential=differential,
            stride_multiple=stride_multiple, wrap=wrap)
        cs = None
        if checksum:
            vpad, counts = venc.ragged_block_values(
                lists, block_size=block_size, differential=False, wrap=wrap)
            cs = block_checksums(vpad, counts)
        return cls.from_encoding(enc, checksums=cs, device=dev)

    # -- metadata ----------------------------------------------------------
    @property
    def n_blocks(self) -> int:
        return self.counts_host.shape[0]

    @property
    def stride(self) -> int:
        return self.payload.shape[1]

    @property
    def device(self) -> torch.device:
        return self.payload.device

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
        """Tensors consumed by the decoders and the kernels."""
        return {"payload": self.payload, "counts": self.counts,
                "bases": self.bases}

    def leaves_numpy(self) -> dict[str, np.ndarray]:
        """Host copies of the leaves: payload uint8, counts int32, bases uint32."""
        return {"payload": self.payload.cpu().numpy(),
                "counts": self.counts.cpu().numpy(),
                "bases": self.bases.cpu().numpy().view(np.uint32)}

    def to(self, device) -> "CompressedIntArray":
        dev = resolve_device(device)
        return replace(self, payload=self.payload.to(dev),
                       counts=self.counts.to(dev), bases=self.bases.to(dev))

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
        return replace(self, payload=gather(self.payload),
                       counts=gather(self.counts), bases=gather(self.bases),
                       counts_host=counts_host, n=int(counts_host.sum()),
                       payload_bytes=None, checksums=cs)

    # -- decoding ------------------------------------------------------------
    def decode_blocked(self, *, plan="auto") -> torch.Tensor:
        """Decode on the device to the int32 (uint32 bits)
        ``[n_blocks, block_size]`` grid (see ``kernels.vbyte_decode.dispatch``)."""
        from repro_torch.kernels.vbyte_decode import dispatch

        return dispatch.decode(self, plan=plan)

    def decode(self, *, plan="auto") -> np.ndarray:
        """Decode to host ``uint32[n]``: each block's valid prefix,
        concatenated. (Not a flat ``[:n]`` trim — a ``take_blocks`` gather
        can put a partial block before a full one.)"""
        grid = self.decode_blocked(plan=plan).cpu().numpy().view(np.uint32)
        mask = (np.arange(self.block_size)[None, :]
                < self.counts_host[:, None])
        return grid[mask]

    def decode_scalar_oracle(self) -> np.ndarray:
        """Byte-at-a-time reference decode (slow; tests only)."""
        leaves = self.leaves_numpy()
        out = vref.decode_blocked_scalar(
            leaves["payload"], leaves["counts"], leaves["bases"],
            self.block_size, differential=self.differential)
        mask = (np.arange(self.block_size)[None, :]
                < self.counts_host[:, None])
        return out[mask].astype(np.uint32)
