"""``owner_sum``: the sum of gathered feature rows by owner, in edge order
(CUDA, ``csrc/owner_sum.cu``).

``out[i] = Σ_{e in row_offsets[i] .. row_offsets[i+1]} h[src[e]]`` over
the valid edges (``edge_valid[e]``, and ``src[e] >= 0``: a negative
source marks a masked edge too), the adds in edge order within each
owner: the order in which the reference's ``jax.ops.segment_sum`` (``repro/nn/gnn.py``
``gin_layer``, ``repro/models/gnn.py``'s graph readout) adds on the CPU,
so both give the same bits, on every run. Accumulation is float32, or
bfloat16 rounded after every add (the reference's bf16 ``segment_sum``).

:func:`owner_sum` launches the hand-written kernel for tensors on the
card; for tensors on the CPU it computes the same function with
:func:`owner_sum_plain`. It never falls back from the card to the plain
version. :func:`segments` and :func:`segments_from_owners` prepare the
CSR layout once (plain torch): row offsets and, on the card, the owners
ordered longest first.

Gradients: where grad is enabled and ``h`` requires it, :func:`owner_sum`
runs as a ``torch.autograd.Function`` whose backward is the same kernel
over the transposed grouping (:func:`segments_by_source`, built once per
forward): ``grad_h[u] = Σ_{e: src[e] = u, e valid} grad_out[owner(e)]``,
``u``'s edges in edge order (the order in which the reference's
scatter-add, the transpose of its gather, adds on the CPU), summed in the
forward's accumulate type and cast to ``h``'s. No atomics: the same bits
on every run. Forward launches count in ``launches``, backward ones in
``backward_launches``.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels.vbyte_decode._build import LaunchCounter, library

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = ("owner_sum", CSRC)  # as _build.build() takes it
LONG_ROW = 2048  # owners with at least this many edges: a CTA per slice
MAX_UNITS = 256  # 16-byte (or narrower) feature units per launch
ACCUMULATE = (torch.float32, torch.bfloat16)

launches = LaunchCounter()
backward_launches = LaunchCounter()


@dataclass(frozen=True)
class Segments:
    """Edges grouped by owner: owner ``i`` holds edges ``row_offsets[i] ..
    row_offsets[i+1]``. On the card also ``order`` (int32 ``[n_owners]``,
    owners by edge count, longest first, ties in owner order) and
    ``n_long`` (int32 ``[1]``, the owners with at least ``LONG_ROW``
    edges, split across CTAs by features), which the kernel reads; ``None``
    on the CPU."""

    row_offsets: torch.Tensor
    order: torch.Tensor | None = None
    n_long: torch.Tensor | None = None

    @property
    def n_owners(self) -> int:
        return self.row_offsets.numel() - 1


def segments(row_offsets: torch.Tensor) -> Segments:
    """The :class:`Segments` of CSR row offsets (int ``[n_owners + 1]``)."""
    ro = row_offsets.reshape(-1).to(torch.int32).contiguous()
    if ro.numel() < 1:
        raise ValueError("row_offsets needs at least one entry")
    if not ro.is_cuda:
        return Segments(ro)
    deg = ro[1:] - ro[:-1]
    order = torch.sort(deg, descending=True, stable=True).indices
    n_long = (deg >= LONG_ROW).sum(dtype=torch.int32).reshape(1)
    return Segments(ro, order.to(torch.int32), n_long)


def segments_from_owners(owner: torch.Tensor, n_owners: int
                         ) -> tuple[torch.Tensor, Segments]:
    """Group edges given in any order by their owner: ``(perm, segments)``
    where ``perm`` (int64) stable-sorts the edges by owner, so each owner
    keeps its edges in their given order."""
    owner = owner.reshape(-1)
    perm = torch.sort(owner, stable=True).indices
    counts = torch.bincount(owner.to(torch.int64), minlength=n_owners)
    ro = torch.zeros(n_owners + 1, dtype=torch.int64, device=owner.device)
    ro[1:] = counts.cumsum(0)
    return perm, segments(ro)


def segments_by_source(src: torch.Tensor, owner: torch.Tensor, n_nodes: int,
                       edge_valid: torch.Tensor | None = None
                       ) -> tuple[torch.Tensor, Segments]:
    """The transposed grouping that :func:`owner_sum`'s backward sums over:
    ``(tsrc, tseg)``, the valid edges grouped by source row (``n_nodes``
    rows, one a row of ``h``), each source's edges in their given order
    (one stable sort), and ``tsrc`` (int32) the owner of each. Masked
    edges (``edge_valid`` False, ``src`` < 0, or ``owner`` < 0: an edge
    of no owner) are left out: they sort past every row, where ``tseg``'s
    offsets never reach. No host synchronisation."""
    src = src.reshape(-1)
    keep = (src >= 0) & (owner.reshape(-1) >= 0)
    if edge_valid is not None:
        keep = keep & edge_valid.reshape(-1)
    key = torch.where(keep, src.to(torch.int64), n_nodes)
    perm = torch.sort(key, stable=True).indices
    counts = torch.bincount(key, minlength=n_nodes + 1)[:n_nodes]
    ro = torch.zeros(n_nodes + 1, dtype=torch.int64, device=src.device)
    ro[1:] = counts.cumsum(0)
    tsrc = owner.reshape(-1).to(torch.int32)[perm].contiguous()
    return tsrc, segments(ro)


def _csr_owners(seg: Segments, n_edges: int) -> torch.Tensor:
    """int32 ``[n_edges]``: the owner of each edge of ``seg``, -1 past its
    last offset."""
    ro = seg.row_offsets.to(torch.int64)
    e = torch.arange(n_edges, dtype=torch.int64, device=ro.device)
    own = torch.searchsorted(ro, e, right=True) - 1
    return torch.where(own < seg.n_owners, own, -1).to(torch.int32)


def _check(h, src, seg, edge_valid, accumulate):
    if accumulate not in ACCUMULATE:
        raise ValueError(f"accumulate must be float32 or bfloat16, got "
                         f"{accumulate}")
    if h.dtype not in ACCUMULATE or h.dim() != 2:
        raise ValueError(f"h must be float32 or bfloat16 [n, d], got "
                         f"{h.dtype} {tuple(h.shape)}")
    if src.dtype != torch.int32 or src.dim() != 1:
        raise ValueError(f"src must be int32 [E], got {src.dtype} "
                         f"{tuple(src.shape)}")
    if edge_valid is not None and (edge_valid.dtype != torch.bool
                                   or edge_valid.shape != src.shape):
        raise ValueError(f"edge_valid must be bool {tuple(src.shape)}, got "
                         f"{edge_valid.dtype} {tuple(edge_valid.shape)}")
    ts = [h, src, seg.row_offsets] + ([] if edge_valid is None
                                      else [edge_valid])
    if len({t.device for t in ts}) != 1:
        raise ValueError("h, src, row_offsets and edge_valid must be on one "
                         "device")


def owner_sum_plain(h: torch.Tensor, src: torch.Tensor,
                    row_offsets: torch.Tensor,
                    edge_valid: torch.Tensor | None = None, *,
                    accumulate=torch.float32) -> torch.Tensor:
    """The plain version: gather, then a sequential sum per owner in edge
    order — ``index_add_`` for float32 (on the CPU it adds in index order),
    and for bfloat16 one add per owner and step, rounded to bf16 each
    time. Masked edges (``edge_valid`` False or ``src`` < 0) are left out
    (the same bits as adding +0.0).

    The bfloat16 branch takes one Python step per edge of the longest
    owner (a step adds every owner's k-th edge), so it suits the tests and
    the graph readout (one owner per graph, tens of edges), not a
    power-law graph's nodes: at ogbn-products' shape that is 684,742
    steps. The model's layers accumulate in float32."""
    ro = row_offsets.reshape(-1).to(torch.int64)
    n, d = ro.numel() - 1, h.shape[1]
    deg = ro[1:] - ro[:-1]
    dst = torch.repeat_interleave(torch.arange(n, device=h.device), deg)
    s = src[:dst.numel()].to(torch.int64)
    keep = s >= 0
    if edge_valid is not None:
        keep &= edge_valid[:dst.numel()]
    s, dst = s[keep], dst[keep]
    if accumulate == torch.bfloat16:
        h = h.to(torch.bfloat16)  # the reference gathers, then casts
    msgs = h.index_select(0, s)
    if accumulate == torch.float32:
        out = torch.zeros((n, d), dtype=torch.float32, device=h.device)
        return out.index_add_(0, dst, msgs.float())
    # rank of each kept edge within its owner; step k adds every owner's
    # k-th edge (dst is non-decreasing)
    first = torch.searchsorted(dst, dst)
    rank = torch.arange(dst.numel(), device=h.device) - first
    acc = torch.zeros((n, d), dtype=torch.float32, device=h.device)
    by_rank = torch.argsort(rank, stable=True)
    steps = torch.bincount(rank, minlength=1).tolist() if rank.numel() else []
    at = 0
    for k, m in enumerate(steps):
        e = by_rank[at:at + m]
        at += m
        o = dst[e]
        acc[o] = (acc[o] + msgs[e].float()).to(torch.bfloat16).float()
    return acc.to(torch.bfloat16)


def _gran(h: torch.Tensor) -> int:
    """The widest unit (16, 8, 4 or, for bf16, 2 bytes) that divides h's
    address, its row stride and its width in bytes."""
    es = h.element_size()
    for g in (16, 8, 4, 2):
        if g < es:
            break
        if (h.data_ptr() % g == 0 and (h.stride(0) * es) % g == 0
                and (h.shape[1] * es) % g == 0):
            return g
    return es


def owner_sum(h: torch.Tensor, src: torch.Tensor, seg: Segments,
              edge_valid: torch.Tensor | None = None, *,
              accumulate=torch.float32,
              by_source: tuple[torch.Tensor, Segments] | None = None
              ) -> torch.Tensor:
    """``[n_owners, d]`` in ``accumulate``'s type: the sum of ``h[src[e]]``
    over each owner's valid edges, in edge order.

    ``h`` float32 or bfloat16 ``[n, d]`` (any row stride), ``src`` int32
    ``[E]`` (each a row of ``h``, or < 0 for a masked edge), ``seg`` from
    :func:`segments` (its last offset at most ``E``), ``edge_valid`` bool
    ``[E]`` or ``None`` (folded into ``src`` on the card). With
    bfloat16 accumulation a float32 ``h`` is rounded to bf16 first, as the
    reference's gather-then-cast. On a CUDA tensor: one launch per 256
    feature units on the current stream, no synchronisation.
    """
    _check(h, src, seg, edge_valid, accumulate)
    if torch.is_grad_enabled() and h.requires_grad:
        if by_source is None:
            by_source = segments_by_source(
                src, _csr_owners(seg, src.numel()), h.shape[0], edge_valid)
        if by_source[1].n_owners != h.shape[0]:
            raise ValueError(f"by_source groups {by_source[1].n_owners} "
                             f"rows, h has {h.shape[0]}")
        return _OwnerSum.apply(h, src, seg, edge_valid, accumulate,
                               by_source)
    return _owner_sum(h, src, seg, edge_valid, accumulate, launches)


class _OwnerSum(torch.autograd.Function):
    """owner_sum, differentiable in ``h``: the backward is owner_sum of the
    output's gradient over the transposed grouping."""

    @staticmethod
    def forward(ctx, h, src, seg, edge_valid, accumulate, by_source):
        ctx.h_dtype, ctx.accumulate, ctx.by_source = (h.dtype, accumulate,
                                                      by_source)
        return _owner_sum(h, src, seg, edge_valid, accumulate, launches)

    @staticmethod
    def backward(ctx, grad_out):
        tsrc, tseg = ctx.by_source
        grad = _owner_sum(grad_out.contiguous(), tsrc, tseg, None,
                          ctx.accumulate, backward_launches)
        return grad.to(ctx.h_dtype), None, None, None, None, None


def _owner_sum(h, src, seg, edge_valid, accumulate, launch_count):
    """The sum itself: the plain version on the CPU, else the kernel's
    launches, each counted in ``launch_count``."""
    if not h.is_cuda:
        return owner_sum_plain(h, src, seg.row_offsets, edge_valid,
                               accumulate=accumulate)
    if seg.order is None:
        raise ValueError("seg was prepared on another device: call "
                         "segments() on the card's row offsets")
    if accumulate == torch.bfloat16 and h.dtype == torch.float32:
        h = h.to(torch.bfloat16)
    if h.stride(1) != 1:
        h = h.contiguous()
    src = (src if edge_valid is None
           else torch.where(edge_valid, src, -1)).contiguous()
    n, d = seg.n_owners, h.shape[1]
    out = torch.empty((n, d), dtype=accumulate, device=h.device)
    if n == 0 or d == 0:
        return out
    es = h.element_size()
    gran = _gran(h)
    cols = MAX_UNITS * gran // es  # columns per launch
    counter = torch.empty(1, dtype=torch.int32, device=h.device)
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, d, cols):
            w = min(cols, d - c0)
            units = w * es // gran
            lanes = 1
            while lanes < min(units, 32):
                lanes *= 2
            library(*SOURCE).call(
                "owner_sum_launch", h.data_ptr() + c0 * es, h.stride(0), w,
                int(h.dtype == torch.bfloat16), gran, src.data_ptr(),
                seg.row_offsets.data_ptr(), seg.order.data_ptr(),
                seg.n_long.data_ptr(), n, lanes,
                out.data_ptr() + c0 * out.element_size(), d,
                int(accumulate == torch.bfloat16), counter.data_ptr(),
                stream)
            launch_count.bump()
    return out
