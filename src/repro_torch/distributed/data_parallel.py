"""A microbatch split by rows over a mesh's positions, its loss reduced
across them.

The reference's ``jax.jit(step, in_shardings=...)`` splits each
microbatch's rows over the axes its batch spec names and lets GSPMD
reduce the loss across them: the function stays the single-device step's.
The port runs one controller (``distributed/api.py``). A
:class:`RowSplit` is one microbatch's positions: each position's compute
copy (a model on its device, or a ``tensor_parallel.ModelParallel`` over
its ``model`` positions) and its device. :func:`split_rows` gives each
position its equal range of the rows, in the order of the batch spec's
split (a compressed entry by blocks, count-0 blocks padding the last).

The families' losses take a ``RowSplit`` in place of the parameters and
the list of the positions' parts in place of the batch
(``models/{recsys,gnn,lm}.py``). Each position runs its rows' forward on
its own copy; the per-row terms are joined at home in position order
(:meth:`RowSplit.gather`) and reduced there by the single device's own
code, so masked means divide once by the whole count and plain means by
the whole microbatch's rows. Where a row reads other rows (the two-tower
in-batch softmax, a graph's neighbours), :meth:`RowSplit.share` gives
every position all the positions' rows; its backward adds the positions'
gradients in position order, in float32, rounded once. The step adds the
positions' parameter gradients in position order
(``train/train_state.py``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .api import NamedSharding
from .sharding import DP, shard_devices, split_of


@dataclass
class RowSplit:
    """One microbatch's positions: ``replicas[p]`` the compute copy of
    position ``p`` and ``devices[p]`` its (home) device; position 0's is
    home, where the loss is reduced."""

    replicas: tuple
    devices: tuple

    @classmethod
    def one(cls, params, batch: dict) -> "RowSplit":
        """The single device's microbatch as one position: ``params`` on
        the device of ``batch``'s tensors. :meth:`gather` and
        :meth:`share` give its pieces back as they are, so a loss over it
        is the single-device loss."""
        dev = next(x.device for x in batch.values()
                   if isinstance(x, torch.Tensor))
        return cls((params,), (dev,))

    @property
    def n(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def gather(self, xs: list, dim: int = 0) -> torch.Tensor:
        """The positions' pieces joined along ``dim`` at home (each
        piece's gradient goes back to its position)."""
        if len(xs) == 1:
            return xs[0]
        return torch.cat([x.to(self.home) for x in xs], dim=dim)

    def share(self, xs: list, dim: int = 0) -> list:
        """Every position's copy of the positions' pieces joined along
        ``dim``: the same values at each. In the backward the positions'
        gradients add in position order in float32, rounded once to the
        pieces' dtype, and each piece takes its range."""
        if len(xs) == 1:
            return list(xs)
        return list(_Share.apply(tuple(self.devices), dim, *xs))


class _Share(torch.autograd.Function):
    @staticmethod
    def forward(ctx, devices, dim, *xs):
        ctx.dim = dim
        ctx.sizes = [x.shape[dim] for x in xs]
        ctx.where = [(x.device, x.dtype) for x in xs]
        whole = torch.cat([x.to(devices[0]) for x in xs], dim=dim)
        # one tensor a position, each its own (positions may share a device)
        return tuple(whole.to(d, copy=True) for d in devices)

    @staticmethod
    def backward(ctx, *grads):
        home = grads[0].device
        total = None
        for g in grads:  # position order
            g = g.to(home, torch.float32)
            total = g if total is None else total + g
        return (None, None, *(part.to(dev, dt) for part, (dev, dt) in zip(
            torch.split(total, ctx.sizes, dim=ctx.dim), ctx.where)))


def row_axes(mesh, batch_shardings) -> tuple:
    """The mesh axes (of size > 1) that the batch's shardings split its
    rows over: the same for every entry that splits; ``()`` where none
    does. Without shardings, the data axes."""
    shs = shardings_of(batch_shardings)
    if not shs:
        return tuple(a for a in DP if mesh.shape.get(a, 1) > 1)
    found = set()
    for s in shs:
        split = dict(split_of(tuple(s.spec), mesh))
        if 0 in split:
            found.add(split[0])
    if len(found) > 1:
        raise ValueError(f"the batch's entries split their rows over "
                         f"different axes: {sorted(found)}")
    return found.pop() if found else ()


def shardings_of(tree) -> list:
    """The ``NamedSharding`` values of a tree of them (dicts, lists,
    tuples; a ``CompressedIntArray`` of shardings gives its ``counts``')."""
    if isinstance(tree, NamedSharding):
        return [tree]
    if isinstance(tree, dict):
        return [s for v in tree.values() for s in shardings_of(v)]
    if isinstance(tree, (list, tuple)):
        return [s for v in tree for s in shardings_of(v)]
    if hasattr(tree, "counts_host"):  # a CompressedIntArray of shardings
        return shardings_of(tree.counts)
    return []


def row_devices(mesh, axes: tuple) -> tuple:
    """The device of each row position over ``axes`` (row-major), the
    first position along every other axis: ``sharding.shard_devices``."""
    return shard_devices(mesh, tuple(axes)) if axes else (
        mesh.devices.flat[0],)


def _splits_rows(sh, x, n: int, mesh) -> bool:
    if isinstance(sh, NamedSharding):
        return 0 in dict(split_of(tuple(sh.spec), mesh))
    if hasattr(sh, "counts_host"):
        return _splits_rows(sh.counts, x, n, mesh)
    # no sharding given: the microbatch rule (a 1-D side input whose
    # length the positions do not divide is shared)
    return not (x.dim() == 1 and x.shape[0] % n)


def split_rows(batch: dict, shardings, devices: tuple, mesh) -> list:
    """``batch`` as one part a position: an entry whose sharding splits
    its rows, ``n`` equal row ranges in position order (a
    ``CompressedIntArray``: equal block ranges, count-0 blocks padding the
    last); any other entry whole at every position. Rows that ``n`` does
    not divide raise."""
    from repro_torch.core.compressed_array import CompressedIntArray

    n = len(devices)
    shardings = shardings if isinstance(shardings, dict) else {}
    parts = [{} for _ in devices]
    for k, x in batch.items():
        sh = shardings.get(k)
        if isinstance(x, CompressedIntArray):
            for p, piece in enumerate(block_shards(x, n, devices)
                                      if sh is None or _splits_rows(
                                          sh, x, n, mesh)
                                      else [x] * n):
                parts[p][k] = piece.to(devices[p])
            continue
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            for part in parts:
                part[k] = x
            continue
        if not _splits_rows(sh, x, n, mesh):
            for part, dev in zip(parts, devices):
                part[k] = x.to(dev)
            continue
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows of batch[{k!r}] do not "
                             f"split over {n} positions")
        per = x.shape[0] // n
        for p, (part, dev) in enumerate(zip(parts, devices)):
            part[k] = x[p * per:(p + 1) * per].to(dev)
    return parts


def block_shards(arr, n: int, devices: tuple) -> list:
    """``arr``'s blocks in ``n`` equal ranges, one on each device (an
    array already split ``n`` ways keeps its shards)."""
    from dataclasses import replace

    from repro_torch.core.compressed_array import FORMAT_LEAVES

    if arr.sharding is not None:
        first = arr.counts
        if len(first.shards) != n:
            raise ValueError(f"a compressed entry split {len(first.shards)} "
                             f"ways, over {n} positions")
        per = arr.n_blocks // n
        return [replace(arr, counts_host=arr.counts_host[p * per:(p + 1) *
                                                          per],
                        payload_bytes=None, checksums=None,
                        n=int(arr.counts_host[p * per:(p + 1) * per].sum()),
                        **{k: getattr(arr, k).shards[p]
                           for k in FORMAT_LEAVES[arr.format]})
                for p in range(n)]
    per = -(-arr.n_blocks // n)
    return [arr.slice_blocks(p * per, min((p + 1) * per, arr.n_blocks),
                             pad_to=per).to(dev)
            if p * per < arr.n_blocks else
            arr.take_blocks(np.arange(0), pad_to=per).to(dev)
            for p, dev in enumerate(devices)]


def block_offsets(parts: list, key: str) -> list:
    """The first block of each position's range of ``parts[p][key]`` (a
    compressed entry split by :func:`split_rows`)."""
    out, at = [], 0
    for part in parts:
        out.append(at)
        at += part[key].n_blocks
    return out


def rows_of(parts: list, key: str) -> list:
    """``(lo, hi)``: each position's range of the rows of
    ``parts[p][key]``, in position order."""
    out, at = [], 0
    for part in parts:
        n = part[key].shape[0]
        out.append((at, at + n))
        at += n
    return out


def realign(pieces: list, ranges: list, lo: int, hi: int,
            device) -> torch.Tensor:
    """Rows ``lo .. hi`` of the whole that ``pieces`` (each over its
    range of ``ranges``) make, on ``device``: the overlapping part of each
    piece, joined in order."""
    got = [x[max(lo, a) - a:min(hi, b) - a].to(device)
           for x, (a, b) in zip(pieces, ranges) if max(lo, a) < min(hi, b)]
    if not got:
        return pieces[0][:0].to(device)
    return torch.cat(got) if len(got) > 1 else got[0]
