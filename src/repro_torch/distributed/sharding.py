"""Block sharding of compressed arrays over a mesh.

The compressed-array part of ``repro/distributed/sharding.py``. Every leaf
of a ``CompressedIntArray`` leads with the block dimension, and every
block decodes independently (per-block ``counts``/``bases`` carry all
cross-block state) — so the block dimension is THE sharding dimension:
``shard_compressed`` pads ``n_blocks`` with count-0 blocks to a multiple
of the axis size and places contiguous, equal block ranges, one on each
shard's device. The dispatch layer then runs the single-device decode once
per shard where the bytes live, with no cross-device traffic
(``repro_torch.kernels.vbyte_decode.dispatch``).

A sharded leaf is a :class:`BlockSharded`: the mesh, the axes the block
dimension is split over, and one tensor per shard. Reading it on the host
takes one explicit :meth:`BlockSharded.gather`. A :class:`Replicated` is
one tensor with a copy on each distinct device of a mesh (an embedding
table the per-shard epilogues read), made once by :func:`replicate`.

The parameter / state rule tables of the reference wait for the training
half of the sharded port (ROADMAP queue 1 item 13).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .api import Mesh, _resolve_axes

DP = ("pod", "data")
# leaves with a trailing byte dimension; counts and bases are [n_blocks]
_BYTE_LEAVES = ("payload", "control", "data", "widths")


def shard_devices(mesh: Mesh, axes: tuple[str, ...]) -> tuple:
    """The device of each block shard, in block order: the sharded axes
    row-major, the first position along every other axis."""
    order = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(mesh.devices.ndim) if i not in order]
    n = math.prod(mesh.shape[a] for a in axes)
    grid = np.transpose(mesh.devices, order + rest).reshape(n, -1)
    return tuple(grid[:, 0])


@dataclass(frozen=True, eq=False)
class BlockSharded:
    """A tensor whose leading (block) dimension is split into equal,
    contiguous ranges, one tensor a shard on that shard's device."""

    mesh: Mesh
    axes: tuple[str, ...]
    shards: tuple[torch.Tensor, ...]

    @property
    def shape(self) -> tuple:
        first = self.shards[0]
        return (sum(s.shape[0] for s in self.shards),) + tuple(first.shape[1:])

    @property
    def device(self) -> torch.device:
        """The first shard's device (where :meth:`gather` puts the rows)."""
        return self.shards[0].device

    @property
    def nbytes(self) -> int:
        return sum(s.numel() * s.element_size() for s in self.shards)

    def gather(self, device=None) -> torch.Tensor:
        """Every shard's rows, in block order, as one tensor on ``device``
        (default: the first shard's device)."""
        dev = self.device if device is None else torch.device(device)
        return torch.cat([s.to(dev, non_blocking=True) for s in self.shards])

    def same_layout(self, other) -> bool:
        return (isinstance(other, BlockSharded) and other.mesh == self.mesh
                and other.axes == self.axes
                and len(other.shards) == len(self.shards))


@dataclass(frozen=True, eq=False)
class Replicated:
    """One tensor with a copy on each distinct device of ``mesh``."""

    mesh: Mesh
    copies: dict  # str(device) -> tensor

    def on(self, device) -> torch.Tensor:
        return self.copies[str(torch.device(device))]


def replicate(x: torch.Tensor, mesh: Mesh) -> Replicated:
    """``x`` on every distinct device of ``mesh``: one copy a device, the
    tensor itself where it already lives."""
    copies = {}
    for dev in mesh.devices.flat:
        if str(dev) not in copies:
            copies[str(dev)] = x if x.device == dev else x.to(dev)
    return Replicated(mesh, copies)


def split_blocks(x: torch.Tensor, mesh: Mesh, axes: tuple[str, ...]
                 ) -> BlockSharded:
    """``x`` (block dimension first, a multiple of the shard count) as
    equal contiguous block ranges on the shards' devices. Ranges already
    on their device are views of ``x``, not copies."""
    devs = shard_devices(mesh, axes)
    if x.shape[0] % len(devs):
        raise ValueError(f"{x.shape[0]} blocks do not split into "
                         f"{len(devs)} equal shards; pad them first")
    per = x.shape[0] // len(devs)
    return BlockSharded(mesh, axes, tuple(
        x[i * per:(i + 1) * per].to(d) for i, d in enumerate(devs)))


def compressed_block_specs(format: str, axis=DP) -> dict:
    """Per-leaf sharding specs of a blocked compressed stream, keyed like
    ``device_operands()``: the byte leaves split on the block dimension
    and keep their byte dimension whole (``(axis, None)``), counts and
    bases split on their one dimension (``(axis,)``)."""
    from repro_torch.core.compressed_array import FORMAT_LEAVES

    return {nm: (axis, None) if nm in _BYTE_LEAVES else (axis,)
            for nm in FORMAT_LEAVES[format]}


def shard_compressed(arr, mesh: Mesh, axis="data"):
    """Place ``arr``'s block dimension across ``mesh[axis]``.

    Pads ``n_blocks`` with count-0 blocks to a multiple of the axis size so
    the per-shard decode divides evenly; padding blocks hold no integers,
    so every decode and epilogue output is unchanged on the real blocks
    and zero on the padding. Axis names absent from the mesh are dropped,
    so a mesh of one shard leaves the array as it is (moved to the mesh's
    device).
    """
    from dataclasses import replace

    from repro_torch.core.compressed_array import FORMAT_LEAVES

    axes = _resolve_axes((axis,), mesh)[0]  # a name, names, or None
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    n_shards = math.prod(mesh.shape[a] for a in axes)
    if n_shards <= 1:
        return arr.to(mesh.devices.flat[0])
    if arr.sharding is not None:
        raise TypeError("the array is already sharded")
    pad = (-arr.n_blocks) % n_shards
    leaves = {}
    for nm in FORMAT_LEAVES[arr.format]:
        x = getattr(arr, nm)
        if pad:
            x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])
        leaves[nm] = split_blocks(x, mesh, axes)
    counts_host = arr.counts_host
    if pad:
        counts_host = np.concatenate([counts_host,
                                      np.zeros(pad, counts_host.dtype)])
    return replace(arr, counts_host=counts_host, **leaves)
