"""Sharding rules and placement over a mesh.

The port of ``repro/distributed/sharding.py``. Its rule tables
(:func:`lm_param_spec`, :func:`lm_cache_spec`, :func:`gnn_param_spec`,
:func:`recsys_param_spec`, with :func:`zero1_extend` for ZeRO-1) are pure
functions of a leaf's path, shape and config that give a spec: a tuple of
axis names, ``None`` or tuples, equal to the reference's
``PartitionSpec``. :func:`tree_specs` / :func:`state_specs` map them over a
model's leaves (a flat dict keyed by path, as the port's train state
keeps its leaves), :func:`to_named` turns spec trees into
``NamedSharding`` values, and :func:`place` lays a tensor out by one.

Every leaf
of a ``CompressedIntArray`` leads with the block dimension, and every
block decodes independently (per-block ``counts``/``bases`` carry all
cross-block state) — so the block dimension is THE sharding dimension:
``shard_compressed`` pads ``n_blocks`` with count-0 blocks to a multiple
of the axis size and places contiguous, equal block ranges, one on each
shard's device. The dispatch layer then runs the single-device decode once
per shard where the bytes live, with no cross-device traffic
(``repro_torch.kernels.vbyte_decode.dispatch``).

A sharded leaf is a :class:`BlockSharded`: the mesh, the axes one
dimension (the block dimension of a compressed array; any dimension of a
parameter) is split over, and one tensor per shard; or a grid of shards
split along two dimensions (a leaf split over ``model`` that ZeRO-1 also
splits over the data axes: h2o-danube's ``attn/wq`` ``(None, DP,
"model")``). Reading it whole takes one explicit
:meth:`BlockSharded.gather`; :meth:`BlockSharded.keep` gathers a grid
along one of its splits. A :class:`Replicated` is one tensor with a copy
on each distinct device of a mesh (an embedding table the per-shard
epilogues read; a parameter the data-parallel replicas share), made by
:func:`replicate`. The model code computes over the ``model`` axis
(``distributed/tensor_parallel.py``): the LM rule's splits and the recsys
rule's (row- or column-split tables, the MLPs' alternating column / row
splits); GIN replicates every leaf.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from .api import Mesh, NamedSharding, _resolve_axes, resolved_spec

DP = ("pod", "data")
TP = "model"
ALL = ("pod", "data", "model")
# leaves with a trailing byte dimension; counts and bases are [n_blocks]
_BYTE_LEAVES = ("payload", "control", "data", "widths")


def shard_devices(mesh: Mesh, axes: tuple[str, ...],
                  axes2: tuple[str, ...] = ()) -> tuple:
    """The device of each block shard, in block order: the sharded axes
    row-major (``axes``, then ``axes2`` for a grid split along two
    dimensions), the first position along every other axis."""
    named = (*axes, *axes2)
    order = [mesh.axis_names.index(a) for a in named]
    rest = [i for i in range(mesh.devices.ndim) if i not in order]
    n = math.prod(mesh.shape[a] for a in named)
    grid = np.transpose(mesh.devices, order + rest).reshape(n, -1)
    return tuple(grid[:, 0])


@dataclass(frozen=True, eq=False)
class BlockSharded:
    """A tensor whose dimension ``dim`` (the leading, block dimension
    unless said) is split into equal, contiguous ranges over ``axes``, one
    tensor a shard on that shard's device; with ``dim2``, also split along
    ``dim2`` over ``axes2``: a grid of shards, row-major (shard ``i·n2 +
    j`` holds range ``i`` of ``dim`` and range ``j`` of ``dim2``)."""

    mesh: Mesh
    axes: tuple[str, ...]
    shards: tuple[torch.Tensor, ...]
    dim: int = 0
    dim2: int | None = None
    axes2: tuple[str, ...] = ()

    @property
    def grid(self) -> tuple[int, int]:
        """Shards along ``dim`` and along ``dim2`` (1 without it)."""
        n2 = (1 if self.dim2 is None
              else math.prod(self.mesh.shape[a] for a in self.axes2))
        return len(self.shards) // n2, n2

    @property
    def splits(self) -> tuple:
        """``((dim, axes), ...)``: the split dimensions and their axes."""
        one = ((self.dim, self.axes),)
        return one if self.dim2 is None else one + ((self.dim2, self.axes2),)

    @property
    def shape(self) -> tuple:
        n1, n2 = self.grid
        shape = list(self.shards[0].shape)
        shape[self.dim] = sum(self.shards[i * n2].shape[self.dim]
                              for i in range(n1))
        if self.dim2 is not None:
            shape[self.dim2] = sum(s.shape[self.dim2]
                                   for s in self.shards[:n2])
        return tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

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
        parts = [s.to(dev, non_blocking=True) for s in self.shards]
        if self.dim2 is None:
            return torch.cat(parts, dim=self.dim)
        n1, n2 = self.grid
        return torch.cat([torch.cat(parts[i * n2:(i + 1) * n2], dim=self.dim2)
                          for i in range(n1)], dim=self.dim)

    def keep(self, axes: tuple[str, ...]) -> "BlockSharded":
        """A grid gathered along its other split: the split over ``axes``
        kept, each kept range whole along the other dimension on the
        device of its first shard."""
        n1, n2 = self.grid
        if self.dim2 is None or axes not in (self.axes, self.axes2):
            raise ValueError(f"keep({axes}) of a split over "
                             f"{[a for _, a in self.splits]}")
        if axes == self.axes:
            rows = [self.shards[i * n2:(i + 1) * n2] for i in range(n1)]
            dim, other = self.dim, self.dim2
        else:
            rows = [self.shards[j::n2] for j in range(n2)]
            dim, other = self.dim2, self.dim
        parts = tuple(torch.cat([s.to(r[0].device, non_blocking=True)
                                 for s in r], dim=other) for r in rows)
        return BlockSharded(self.mesh, axes, parts, dim)

    def same_layout(self, other) -> bool:
        return (isinstance(other, BlockSharded) and other.mesh == self.mesh
                and other.splits == self.splits
                and len(other.shards) == len(self.shards))

    def map(self, fn) -> "BlockSharded":
        """``fn`` applied to every shard (an elementwise map keeps the
        layout)."""
        return replace(self, shards=tuple(fn(s) for s in self.shards))

    def to(self, *args, **kwargs) -> "BlockSharded":
        """Every shard ``.to(...)`` on its own device (a dtype cast)."""
        return self.map(lambda s: s.to(*args, **kwargs))


@dataclass(frozen=True, eq=False)
class Replicated:
    """One tensor with a copy on each distinct device of ``mesh``."""

    mesh: Mesh
    copies: dict  # str(device) -> tensor

    def on(self, device) -> torch.Tensor:
        return self.copies[str(torch.device(device))]

    @property
    def shape(self) -> tuple:
        return tuple(self.first.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.first.dtype

    @property
    def first(self) -> torch.Tensor:
        """The copy on the mesh's first device."""
        return self.on(self.mesh.devices.flat[0])

    def map(self, fn) -> "Replicated":
        """``fn`` applied to every copy."""
        return Replicated(self.mesh, {k: fn(v) for k, v in self.copies.items()})

    def to(self, *args, **kwargs) -> "Replicated":
        """Every copy ``.to(...)`` on its own device (a dtype cast)."""
        return self.map(lambda t: t.to(*args, **kwargs))


def replicate(x: torch.Tensor, mesh: Mesh) -> Replicated:
    """``x`` on every distinct device of ``mesh``: one copy a device, the
    tensor itself where it already lives."""
    copies = {}
    for dev in mesh.devices.flat:
        if str(dev) not in copies:
            copies[str(dev)] = x if x.device == dev else x.to(dev)
    return Replicated(mesh, copies)


def _split(source, shape, mesh: Mesh, splits: tuple, *,
           copy: bool) -> BlockSharded:
    """A :class:`BlockSharded` of ``splits`` (``((dim, axes), ...)``, one
    or two) made from ``source(device)``, a tensor of ``shape`` to narrow
    for the shard on ``device``."""
    (dim, axes), *rest = splits
    dim2, axes2 = rest[0] if rest else (None, ())
    devs = shard_devices(mesh, axes, axes2)
    n2 = math.prod(mesh.shape[a] for a in axes2)
    n1 = len(devs) // n2
    for d, n in ((dim, n1), (dim2, n2)):
        if d is not None and shape[d] % n:
            raise ValueError(f"{shape[d]} blocks do not split into {n} "
                             f"equal shards; pad them first")
    per1 = shape[dim] // n1
    per2 = shape[dim2] // n2 if dim2 is not None else 0
    parts = []
    for i in range(n1):
        for j in range(n2):
            d = devs[i * n2 + j]
            p = source(d).narrow(dim, i * per1, per1)
            if dim2 is not None:
                p = p.narrow(dim2, j * per2, per2)
            p = p.to(d, copy=copy)
            parts.append(p.contiguous() if copy else p)
    return BlockSharded(mesh, axes, tuple(parts), dim, dim2, axes2)


def split_blocks(x: torch.Tensor, mesh: Mesh, axes: tuple[str, ...], *,
                 dim: int = 0, copy: bool = False) -> BlockSharded:
    """``x`` (dimension ``dim`` a multiple of the shard count) as equal
    contiguous ranges of that dimension on the shards' devices. Ranges
    already on their device are views of ``x`` unless ``copy``; with it
    every shard is a contiguous tensor of its own."""
    return _split(lambda d: x, x.shape, mesh, ((dim, tuple(axes)),),
                  copy=copy)


def split_of(spec: tuple, mesh: Mesh) -> tuple:
    """The dimensions ``spec`` splits over ``mesh`` and the axes it splits
    each over, dropping axes of size 1: ``((dim, axes), ...)`` in
    dimension order, ``()`` for a spec that splits nothing. A leaf is
    split along at most two dimensions (a ``model`` split and ZeRO-1's
    data split); a spec that names one axis twice raises."""
    found, seen = [], set()
    for i, entry in enumerate(spec):
        names = (() if entry is None else (entry,) if isinstance(entry, str)
                 else tuple(entry))
        for a in names:
            if a in seen:
                raise ValueError(f"spec {spec} names mesh axis {a!r} twice")
            seen.add(a)
        names = tuple(a for a in names if mesh.shape.get(a, 1) > 1)
        if names:
            found.append((i, names))
    if len(found) > 2:
        raise NotImplementedError(
            f"spec {spec} splits {len(found)} dimensions; a leaf is split "
            "along at most two")
    return tuple(found)


def without_data(spec: tuple) -> tuple:
    """``spec`` with the data axes dropped from every entry: the layout a
    data position computes in (the reference's compute spec of a ZeRO-1
    master leaf)."""
    out = []
    for entry in spec:
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        kept = tuple(a for a in names if a not in DP)
        out.append(kept[0] if len(kept) == 1 else (kept or None))
    return tuple(out)


def _on_devices(x: BlockSharded, devs: tuple) -> BlockSharded:
    """``x`` with each shard on its layout's device (a no-op where it is
    there already)."""
    if all(s.device == d for s, d in zip(x.shards, devs)):
        return x
    return replace(x, shards=tuple(s.to(d) for s, d in zip(x.shards, devs)))


def _refine(x: BlockSharded, mesh: Mesh, splits: tuple, kept: int, *,
            copy: bool) -> BlockSharded:
    """``x``, split once over ``splits[kept]``, split further into the grid
    of ``splits``: each shard narrowed along the other dimension."""
    (dim, axes), (dim2, axes2) = splits
    devs = shard_devices(mesh, axes, axes2)
    n2 = math.prod(mesh.shape[a] for a in axes2)
    n1 = len(devs) // n2
    other, n_other = (dim2, n2) if kept == 0 else (dim, n1)
    if x.shape[other] % n_other:
        raise ValueError(f"{x.shape[other]} blocks do not split into "
                         f"{n_other} equal shards; pad them first")
    per = x.shape[other] // n_other
    parts = []
    for i in range(n1):
        for j in range(n2):
            src, r = (x.shards[i], j) if kept == 0 else (x.shards[j], i)
            p = src.narrow(other, r * per, per).to(devs[i * n2 + j],
                                                   copy=copy)
            parts.append(p.contiguous() if copy else p)
    return BlockSharded(mesh, axes, tuple(parts), dim, dim2, axes2)


def place(x, sharding: NamedSharding, *, copy: bool = False):
    """``x`` (a tensor, :class:`BlockSharded` or :class:`Replicated`) laid
    out by ``sharding``: split along its split dimensions
    (:func:`split_of`), or one copy on each distinct device of the mesh. A
    value already in that layout is returned as it is (its shards moved to
    the layout's devices where they lie elsewhere); a grid whose one split
    the layout keeps is gathered along the other (:meth:`BlockSharded.keep`);
    a split the layout refines is split further; any other split value is
    gathered (``torch.cat``) and split anew. ``copy`` makes every split
    shard a tensor of its own (a state leaf whose full tensor is then
    dropped), where by default a shard on the tensor's own device is a
    view."""
    mesh = sharding.mesh
    splits = split_of(tuple(sharding.spec), mesh)
    if not splits:
        if isinstance(x, Replicated) and x.mesh == mesh:
            return x
        if isinstance(x, BlockSharded):
            return Replicated(mesh, {str(d): x.gather(d) for d in
                                     dict.fromkeys(mesh.devices.flat)})
        return replicate(x.first if isinstance(x, Replicated) else x, mesh)
    devs = shard_devices(mesh, *(a for _, a in splits))
    if isinstance(x, BlockSharded) and x.mesh == mesh:
        if x.splits == splits:
            return _on_devices(x, devs)
        if len(x.splits) == 2 and len(splits) == 1 and splits[0] in x.splits:
            return _on_devices(x.keep(splits[0][1]), devs)
        if len(x.splits) == 1 and len(splits) == 2 and x.splits[0] in splits:
            return _refine(x, mesh, splits, splits.index(x.splits[0]),
                           copy=copy)
    if isinstance(x, BlockSharded):
        x = x.gather()
    if isinstance(x, Replicated):
        src = x
        return _split(lambda d: src.on(d) if str(d) in src.copies
                      else src.first, x.shape, mesh, splits, copy=copy)
    return _split(lambda d: x, x.shape, mesh, splits, copy=copy)


def pieces(x) -> list:
    """The tensors that hold ``x``: its shards, its copies, or ``[x]``."""
    if isinstance(x, BlockSharded):
        return list(x.shards)
    if isinstance(x, Replicated):
        return list(x.copies.values())
    return [x]


def map_pieces(fn, x, *others):
    """``fn`` over the pieces of ``x`` and of ``others`` (each in ``x``'s
    layout) side by side: an elementwise operation in that layout."""
    if isinstance(x, (BlockSharded, Replicated)):
        for o in others:
            same = (x.same_layout(o) if isinstance(x, BlockSharded) else
                    isinstance(o, Replicated) and o.mesh == x.mesh)
            if not same:
                raise ValueError("operands of an elementwise map are laid "
                                 "out differently")
    if isinstance(x, BlockSharded):
        return replace(x, shards=tuple(
            fn(*ps) for ps in zip(x.shards, *(o.shards for o in others))))
    if isinstance(x, Replicated):
        return Replicated(x.mesh, {k: fn(v, *(o.copies[k] for o in others))
                                   for k, v in x.copies.items()})
    return fn(x, *others)


def whole(x, device=None) -> torch.Tensor:
    """``x`` as one tensor: a :class:`BlockSharded` gathered on ``device``
    (default: its first shard's), a :class:`Replicated`'s copy there (its
    first copy if it has none there), a tensor as it is."""
    if isinstance(x, BlockSharded):
        return x.gather(device)
    if isinstance(x, Replicated):
        if device is not None and str(torch.device(device)) in x.copies:
            return x.on(device)
        return x.first if device is None else x.first.to(device)
    return x


# ---------------------------------------------------------------------------
# parameter rules (the reference's tables, leaf by leaf)
# ---------------------------------------------------------------------------
def _path_str(path) -> str:
    """A leaf's path as ``a/b/c``: a string as it is; a sequence of
    ``jax``-style keys (``.key``, ``.idx``) or plain values joined."""
    if isinstance(path, str):
        return path
    parts = []
    for p in path:
        if hasattr(p, "key"):
            parts.append(str(p.key))
        elif hasattr(p, "idx"):
            parts.append(str(p.idx))
        else:
            parts.append(str(p))
    return "/".join(parts)


def _size(leaf) -> int:
    return math.prod(leaf.shape)


def zero1_extend(spec: tuple, leaf, *, min_size: int = 1 << 20,
                 divisor: int = 32) -> tuple:
    """ZeRO-1: additionally split a (master / moment) leaf of at least
    ``min_size`` elements over the data axes, on its first unsplit
    dimension divisible by ``divisor``: storage only; the train step
    gathers a bf16 compute copy."""
    if _size(leaf) < min_size:
        return spec
    axes = list(spec) + [None] * (len(leaf.shape) - len(spec))
    for i, (ax, dim) in enumerate(zip(axes, leaf.shape)):
        if ax is None and dim % divisor == 0:
            axes[i] = DP
            return tuple(axes)
    return spec


def _none(leaf) -> tuple:
    return (None,) * len(leaf.shape)


def lm_param_spec(cfg, *, zero1: bool = False):
    """``rule(path, leaf) -> spec`` of an LM's parameters: embedding rows,
    the head's columns, attention heads, FFN hidden units and MoE experts
    (``ep_shard``) or their hidden units over ``model``; with ``zero1``,
    :func:`zero1_extend` over the data axes."""
    tp_divides_kv = ((cfg.n_kv_heads * cfg.dh) % 16 == 0
                     and cfg.n_kv_heads % 16 == 0)
    ep = bool(cfg.moe and cfg.moe.ep_shard)

    def base(path, leaf):
        s = _path_str(path)
        if s.endswith("embed/emb"):
            return (TP, None)
        if s.endswith("lm_head/w"):
            return (None, TP)
        if "attn/wq" in s:
            return (None, None, TP)
        if "attn/wk" in s or "attn/wv" in s:
            return (None, None, TP) if tp_divides_kv else (None, None, None)
        if "attn/wo" in s:
            return (None, TP, None)
        if "ffn/gate" in s or "ffn/up" in s:
            return (None, None, TP)
        if "ffn/down" in s:
            return (None, TP, None)
        if "moe/router" in s:
            return (None, None, None)
        if "moe/gate" in s or "moe/up" in s:  # [L, E, d, f]
            return (None, TP, None, None) if ep else (None, None, None, TP)
        if "moe/down" in s:  # [L, E, f, d]
            return (None, TP, None, None) if ep else (None, None, TP, None)
        return _none(leaf)

    def rule(path, leaf):
        spec = base(path, leaf)
        return zero1_extend(spec, leaf) if zero1 else spec

    return rule


def lm_cache_spec(cfg, batch: int, mesh_dp: int) -> tuple:
    """The KV cache ``[L, B, Sc, Hk, dh]``: batch over the data axes when
    they divide it, else the cache length over ``data`` (long_500k); heads
    or head dim over ``model``."""
    from repro_torch.models.lm import cache_head_axes

    head_axes = cache_head_axes(cfg)
    if batch % mesh_dp == 0 and batch >= mesh_dp:
        return (None, DP, None, *head_axes)
    return (None, None, "data", *head_axes)


def gnn_param_spec(cfg):
    """GIN's parameters are small: every leaf replicated."""
    def rule(path, leaf):
        return _none(leaf)

    return rule


def recsys_param_spec(cfg, *, serving: bool = False):
    """Tables of at least 2^16 rows split by rows over ``model`` (by
    columns in ``serve_table_mode="column"`` serving; every leaf
    replicated in ``"replicated"`` serving), MLP layers alternating
    column / row splits (megatron style), the rest replicated."""
    table_mode = getattr(cfg, "serve_table_mode", "row") if serving else "row"

    def rule(path, leaf):
        s = _path_str(path)
        if table_mode == "replicated" and serving:
            return _none(leaf)
        if s.endswith("_emb/emb") and leaf.shape[0] >= 1 << 16:
            return (None, TP) if table_mode == "column" else (TP, None)
        if "_mlp/" in s or s.startswith("mlp/") or "/mlp/" in s:
            try:
                layer_idx = int(s.split("layer_")[1].split("/")[0])
            except (IndexError, ValueError):
                layer_idx = 0
            col = layer_idx % 2 == 0
            if s.endswith("/w"):
                if leaf.shape[-1] % 16 != 0:  # final logit layer etc.
                    return _none(leaf)
                return (None, TP) if col else (TP, None)
            if s.endswith("/b"):
                return (TP,) if col and leaf.shape[-1] % 16 == 0 else (None,)
        return _none(leaf)

    return rule


def compressed_block_specs(format: str, axis=DP) -> dict:
    """Per-leaf sharding specs of a blocked compressed stream, keyed like
    ``device_operands()``: the byte leaves split on the block dimension
    and keep their byte dimension whole (``(axis, None)``), counts and
    bases split on their one dimension (``(axis,)``)."""
    from repro_torch.core.compressed_array import FORMAT_LEAVES

    return {nm: (axis, None) if nm in _BYTE_LEAVES else (axis,)
            for nm in FORMAT_LEAVES[format]}


def compressed_array_specs(arr, axis=DP):
    """A ``CompressedIntArray`` of specs in place of its leaves (the
    block dimension on ``axis``): the spec tree of a compressed batch
    entry, beside the array's own."""
    return replace(arr, counts_host=None, checksums=None,
                   **compressed_block_specs(arr.format, axis))


FORMAT_LEAVES_ALL = ("payload", "control", "widths", "data", "counts",
                     "bases")


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


# ---------------------------------------------------------------------------
# assembling state shardings
# ---------------------------------------------------------------------------
def tree_specs(params, rule) -> dict:
    """``{path: rule(path, leaf)}`` over ``params`` (a model whose
    ``tree()`` gives its leaves, or a nested dict), in the reference's
    leaf order."""
    from repro_torch.train.train_state import param_leaves

    return {k: rule(k, v) for k, v in param_leaves(params).items()}


def state_specs(params, rule, *, has_ef: bool = False) -> dict:
    """Specs of a train state laid out as the port keeps one: ``params``,
    the moments ``opt/m``, ``opt/v`` by ``rule``, ``opt/step``
    replicated, and with ``has_ef`` the error feedback by ``rule``."""
    pspec = tree_specs(params, rule)
    out = {"params": pspec,
           "opt": {"m": dict(pspec), "v": dict(pspec), "step": ()}}
    if has_ef:
        out["ef"] = dict(pspec)
    return out


def _is_spec(x) -> bool:
    """A spec: a tuple of axis names, ``None`` and tuples of names (a
    tuple holding anything else, such as the spec trees of a step's
    arguments, is a container)."""
    return isinstance(x, tuple) and all(
        e is None or isinstance(e, str)
        or (isinstance(e, tuple) and all(isinstance(a, str) for a in e))
        for e in x)


def map_specs(fn, tree):
    """``fn`` over every spec of a spec tree (dicts, tuples and lists of
    spec trees, and ``CompressedIntArray`` objects of specs, whose leaves
    are specs), the tree's structure kept."""
    from repro_torch.core.compressed_array import CompressedIntArray

    if _is_spec(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_specs(fn, v) for v in tree)
    if isinstance(tree, CompressedIntArray):
        return replace(tree, **{k: fn(getattr(tree, k))
                                for k in FORMAT_LEAVES_ALL
                                if getattr(tree, k) is not None})
    raise TypeError(f"not a spec tree: {type(tree).__name__}")


def to_named(mesh: Mesh, spec_tree):
    """Every spec of ``spec_tree`` as a ``NamedSharding`` on ``mesh``
    (axes the mesh lacks dropped)."""
    return map_specs(lambda s: NamedSharding(mesh, resolved_spec(s, mesh)),
                     spec_tree)
