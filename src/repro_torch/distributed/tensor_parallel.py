"""Tensor- and expert-parallel compute over a mesh's ``model`` axis.

The reference lets GSPMD partition its LM over ``model``: attention
heads, FFN hidden units, MoE experts (or their hidden units), embedding
rows and ``lm_head`` columns are split by its rule tables
(``distributed/sharding.py``), and the compiler inserts the sums. The
port runs one controller (``distributed/api.py``): a ``model`` position is
a place on the mesh that holds its slice of each split leaf, and the
controller runs that position's part of a layer on the position's
device. A data position's compute copy is a :class:`ModelParallel`: its
``k`` devices (position 0 is the *home*, where the replicated work runs:
norms, residuals, the router, softmaxes) and its leaves, each a tensor
on the home device or a :class:`~repro_torch.distributed.sharding.BlockSharded`
over ``("model",)`` with one slice a position.

The functions here work on the position slices of one leaf
(:class:`Slices`, a layer's view of a split leaf). They read the layout
(which dimension is split); they take no flag and no config field:

* :func:`column_dense` — each position multiplies by its columns; no sum,
  so each output column is the single-device product's;
* :func:`row_dense` — each position multiplies its input slice by its
  rows, the float32 partials are added in position order at home and
  rounded to the compute dtype once (:func:`reduce_sum`);
* :func:`vocab_embedding` — each position looks up the ids in its row
  range and leaves zeros elsewhere; the rows are summed (one of them is
  not zero, so the sum is exact); :func:`lookup` takes a table split by
  rows or by columns (the recsys tables);
* :func:`mlp` — a recsys MLP's alternating column / row splits;
* :func:`vocab_logsumexp` — the logsumexp over the positions' logit
  slices, and the target's logit read from the position that owns it.

Autograd runs through them as through any torch code: a gradient lands
on the slice that produced it.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.nn.layers import DEFAULT_COMPUTE_DTYPE, dense

MODEL = "model"


@dataclass(frozen=True)
class Slices:
    """One slice of a leaf a model position, each on its position's
    device, split along ``dim``."""

    parts: tuple
    dim: int


class ModelParallel:
    """One data position's compute copy over the ``model`` axis:
    ``mesh``, the position's ``devices`` (one a model position, in order;
    the first is home) and ``leaves`` by path, each a tensor on the home
    device or a ``BlockSharded`` over ``("model",)`` whose shards lie on
    ``devices``."""

    def __init__(self, mesh, devices, leaves: dict):
        self.mesh, self.devices, self.leaves = mesh, tuple(devices), leaves

    @property
    def k(self) -> int:
        return len(self.devices)

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    def view(self, path: str):
        """The leaf at ``path``: a tensor, or its :class:`Slices`."""
        x = self.leaves[path]
        return x if isinstance(x, torch.Tensor) else Slices(x.shards, x.dim)

    def unbind(self, path: str) -> list:
        """A stacked leaf ``[L, ...]`` as one view a layer: a tensor, or
        :class:`Slices` along the layer's own dimensions."""
        x = self.leaves[path]
        if isinstance(x, torch.Tensor):
            return list(torch.unbind(x, 0))
        if x.dim == 0:
            raise ValueError(f"{path}: the layer dimension is split")
        per = [torch.unbind(s, 0) for s in x.shards]
        return [Slices(tuple(u[i] for u in per), x.dim - 1)
                for i in range(len(per[0]))]

    @classmethod
    def of(cls, mesh, row: tuple, leaves: dict, *,
           requires_grad: bool = False) -> "ModelParallel":
        """The compute copy on ``row`` (a data position's devices) of
        placed leaves (split over ``model`` or whole): each split leaf's
        slices on the row's devices, each whole leaf at its home; with
        ``requires_grad``, every piece a leaf of its own that requires
        grad."""
        from dataclasses import replace

        from repro_torch.distributed.sharding import BlockSharded, whole

        def own(t):
            return t.detach().requires_grad_(True) if requires_grad else t

        return cls(mesh, row, {
            k: replace(v, shards=tuple(own(s.to(d))
                                       for s, d in zip(v.shards, row)))
            if isinstance(v, BlockSharded) else own(whole(v, row[0]))
            for k, v in leaves.items()})

    def split(self, x: torch.Tensor, dim: int):
        """``x`` (on home) laid out over the positions along ``dim``: a
        ``BlockSharded`` over ``("model",)`` on this position's devices."""
        from repro_torch.distributed.sharding import BlockSharded

        n = x.shape[dim]
        if n % self.k:
            raise ValueError(f"{n} do not split into {self.k} equal shards")
        per = n // self.k
        return BlockSharded(self.mesh, (MODEL,), tuple(
            x.narrow(dim, p * per, per).to(d)
            for p, d in enumerate(self.devices)), dim)


def data_rows(mesh) -> list[tuple]:
    """Each data position's devices, one a ``model`` position (home
    first), the data positions in row-major order of the data axes."""
    from repro_torch.distributed.sharding import DP, shard_devices

    dp = tuple(a for a in DP if a in mesh.axis_names)
    k = mesh.shape.get(MODEL, 1)
    grid = shard_devices(mesh, dp, (MODEL,) if k > 1 else ())
    return [grid[i:i + k] for i in range(0, len(grid), k)]


class _WideProduct(torch.autograd.Function):
    """``x [..., K] · w [K, N]`` of bf16 / fp16 operands on the card with a
    float32 result: the tensor cores' product (float32 sums), no rounding
    after (``torch.mm(out_dtype=float32)``, which has no backward of its
    own). The backward is a dense layer's: products in the operands'
    dtype."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = torch.mm(x.reshape(-1, x.shape[-1]), w,
                       out_dtype=torch.float32)
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1]).to(x.dtype)
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g2 @ w.t()).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gw = x.reshape(-1, x.shape[-1]).t() @ g2
        return gx, gw


def _f32_product(x: torch.Tensor, w: torch.Tensor,
                 dtype) -> torch.Tensor:
    """``x · w`` of the operands rounded to ``dtype``, with float32
    products and sums and no rounding after (``accum_matmul``'s meaning):
    a partial of a row-parallel product. On the card a half-precision
    product stays on the tensor cores (:class:`_WideProduct`); elsewhere
    the operands are widened."""
    x, w = x.to(dtype), w.to(dtype)
    if x.is_cuda and dtype in (torch.bfloat16, torch.float16):
        return _WideProduct.apply(x, w)
    return torch.matmul(x.to(torch.float32), w.to(torch.float32))


def reduce_sum(partials: list, home) -> torch.Tensor:
    """The partials added at ``home`` in position order (a left fold), in
    their own dtype."""
    total = partials[0].to(home)
    for t in partials[1:]:
        total = total + t.to(home)
    return total


def column_dense(x: torch.Tensor, w: Slices, *,
                 dtype=DEFAULT_COMPUTE_DTYPE) -> list:
    """``dense(w_p, x)`` on each position ``p`` (``x`` whole, at home):
    the output's columns a position, no sum."""
    if w.dim != w.parts[0].dim() - 1:
        raise ValueError(f"a column-parallel weight splits its last "
                         f"dimension, not {w.dim}")
    xd = x.to(dtype)
    return [dense(wp, xd.to(wp.device), dtype=dtype) for wp in w.parts]


def row_dense(xs: list, w: Slices, *, home,
              dtype=DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    """``Σ_p xs[p] · w_p`` (each ``xs[p]`` on position ``p``, its slice of
    the input's last dimension): float32 partials added at ``home`` in
    position order, rounded to ``dtype`` once."""
    if w.dim != 0:
        raise ValueError(f"a row-parallel weight splits its rows, not "
                         f"dimension {w.dim}")
    return reduce_sum([_f32_product(x, wp, dtype)
                       for x, wp in zip(xs, w.parts)], home).to(dtype)


def vocab_embedding(emb: Slices, ids: torch.Tensor, *, home,
                    dtype=DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    """``emb[ids]`` in ``dtype`` at ``home`` over a table split by rows:
    each position looks up the ids in its row range (zeros elsewhere) and
    the float32 rows are summed, then cast (the single-device lookup
    gathers, then casts)."""
    if emb.dim != 0:
        raise ValueError(f"a vocabulary-parallel table splits its rows, "
                         f"not dimension {emb.dim}")
    outs, lo = [], 0
    for e in emb.parts:
        n = e.shape[0]
        local = ids.to(e.device, torch.int64) - lo
        mask = (local >= 0) & (local < n)
        rows = torch.nn.functional.embedding(local.clamp(0, n - 1), e)
        outs.append(rows * mask[..., None].to(rows.dtype))
        lo += n
    return reduce_sum(outs, home).to(dtype)


def lookup(table: Slices, ids: torch.Tensor, *, home,
           dtype=DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    """``table[ids]`` in ``dtype`` at ``home`` over a table split over the
    positions: by rows (:func:`vocab_embedding`), or by columns (each
    position looks every id up in its columns; the columns joined). Either
    way each value is the single-device lookup's."""
    if table.dim == 0:
        return vocab_embedding(table, ids, home=home, dtype=dtype)
    if table.dim != table.parts[0].dim() - 1:
        raise ValueError(f"a table split along dimension {table.dim}")
    return gather([torch.nn.functional.embedding(
        ids.to(e.device, torch.int64), e).to(dtype) for e in table.parts],
        -1, home)


def mlp(layers, x: torch.Tensor, *, home, act=torch.relu,
        dtype=DEFAULT_COMPUTE_DTYPE) -> torch.Tensor:
    """``nn.layers.mlp`` (``layers.w``, ``layers.b``) over the positions:
    a layer whose weight splits its columns runs :func:`column_dense`
    (its bias split alike, the activation on each position's columns), one
    whose weight splits its rows :func:`row_dense` on the previous
    layer's column slices (its bias whole, added at home), a whole weight
    a plain product at home. Column slices are joined (:func:`gather`)
    before a whole layer and at the end. The activation follows every
    layer but the last."""
    n, xs = len(layers.w), None
    for i, (w, b) in enumerate(zip(layers.w, layers.b)):
        apply_act = i < n - 1
        if isinstance(w, Slices) and w.dim == 0:
            if xs is None:
                xs = scatter(x, [p.device for p in w.parts], x.dim() - 1)
            x, xs = row_dense(xs, w, home=home, dtype=dtype) + b.to(dtype), None
        elif isinstance(w, Slices):
            if xs is not None:
                x, xs = gather(xs, -1, home), None
            bs = b.parts if isinstance(b, Slices) else scatter(
                b, [p.device for p in w.parts], 0)
            xs = [y + bp.to(dtype) for y, bp in zip(
                column_dense(x, w, dtype=dtype), bs)]
            if apply_act:
                xs = [act(y) for y in xs]
            continue
        else:
            if xs is not None:
                x, xs = gather(xs, -1, home), None
            x = x.to(dtype) @ w.to(dtype) + b.to(dtype)
        if apply_act:
            x = act(x)
    return gather(xs, -1, home) if xs is not None else x


def vocab_logsumexp(logits: list, targets: torch.Tensor, *,
                    home) -> tuple[torch.Tensor, torch.Tensor]:
    """``(logsumexp, target logit)`` over the last dimension of logits
    split over the positions (``logits[p]`` float32 on position ``p``, its
    vocabulary range): the maximum over the positions, the sums of
    ``exp(l − max)`` added in position order, and each target's logit
    from the position whose range holds it."""
    # the shift carries no gradient (torch.logsumexp's backward is the
    # softmax)
    m = torch.stack([lp.detach().amax(dim=-1).to(home)
                     for lp in logits]).amax(0)
    s = reduce_sum([torch.exp(lp - m.to(lp.device)[..., None]).sum(-1)
                    for lp in logits], home)
    trues, lo = [], 0
    for lp in logits:
        n = lp.shape[-1]
        local = targets.to(lp.device, torch.int64) - lo
        mask = (local >= 0) & (local < n)
        t = torch.gather(lp, -1, local.clamp(0, n - 1)[..., None])[..., 0]
        trues.append(torch.where(mask, t, 0.0))
        lo += n
    return torch.log(s) + m, reduce_sum(trues, home)


def gather(parts: list, dim: int, home) -> torch.Tensor:
    """The positions' slices joined along ``dim`` at ``home``."""
    return torch.cat([p.to(home) for p in parts], dim=dim)


def scatter(x: torch.Tensor, devices, dim: int) -> list:
    """``x`` cut into equal ranges of ``dim``, one a device."""
    per = x.shape[dim] // len(devices)
    return [x.narrow(dim, p * per, per).to(d) for p, d in enumerate(devices)]
