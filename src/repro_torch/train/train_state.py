"""Train state, the train-step factory, and the step over a mesh.

The port of ``repro/train/train_state.py``. A state is a dict: ``params``
(a model whose ``tree()`` gives its parameters under the reference's
paths, or a nested dict of tensors), ``opt`` (``m``, ``v``: float32
moments per leaf; ``step``: int32) and, with gradient compression,
``ef`` (the error feedback per leaf). ``train_step`` updates the state
in place and returns it (the reference returns a new one): copy it
(``copy.deepcopy``) to keep a step's input.

``make_train_step``'s ZeRO-1 hooks are the reference's: ``compute_cast``
builds the compute copy once a step, outside the microbatches, and the
gradients are taken with respect to it; ``grad_transform`` applies to
each microbatch's gradients, and the float32 accumulator takes the
layout it gives (the master's).

:func:`jit_train_step` runs a step over a mesh from one controller, with
no process group (``repro_torch.distributed``): it places the state by
its shardings, in place (the reference's donation), and keeps a compute
copy for each row position: the positions over which the batch's
shardings split its rows (the data positions; every position for GIN's
node batch, split over ``("pod", "data", "model")``; the first alone for
a batch replicated whole). Where their count ``n`` divides the step's
``microbatch``, the parts (:func:`_split`) are dealt out whole,
``microbatch / n`` to each position in order: over a ``model`` axis of 1
the step equals ``make_train_step(microbatch=mb)`` bit for bit. Where it
does not, each part's rows split over the positions
(``distributed/data_parallel.py``): each position runs its rows' forward,
the loss is reduced across them as the model code says (the per-row
terms joined at home, a masked mean divided once by the whole count), and
the positions' gradients add in position order in float32
(:func:`_position_sum`). Either way every part's gradients add into one
float32 accumulator in the master layout in part order (:func:`accumulate`,
the one loop both steps run), so the step computes the single-device
step's function, as the reference's ``jax.jit(in_shardings=...)`` does.
Over a ``model`` axis of ``k > 1`` a data position's copy is a
``tensor_parallel.ModelParallel`` where the rule splits a leaf over
``model`` (the LM and recsys families): each leaf laid out as its master
without the data axes (the reference's compute spec), its ``model``
slices on the position's devices; the model code computes over them
(``models/lm.py``, ``models/recsys.py``), and a slice's gradient lands in
the master's grid (a leaf ZeRO-1 splits over the data axes too). It
differs from the single-device step only where the row-parallel,
vocabulary and cross-position sums re-associate.
Each leaf's square sum in the global norm is taken over the whole leaf
(gathered one leaf at a time), as one device takes it: free while one
card hosts the mesh; over several cards it moves the split gradient to
the first (ROADMAP queue 1 item 13, left 2, measures it first). Every
other operation is elementwise on the pieces.
"""
from __future__ import annotations

import copy
from dataclasses import replace
from typing import Any, Callable

import torch
from torch import nn

from repro_torch.tree import flatten, nest, unflatten_like

from .grad_compress import compress_grads_with_ef, init_ef_state
from .optimizer import OptimizerConfig, adamw_update, global_norm, init_opt_state


class ShardedParams:
    """A model's parameters placed on a mesh: ``skeleton``, the model with
    its leaves on the ``meta`` device (its structure only), and
    ``leaves`` by path, each a tensor, ``BlockSharded`` or
    ``Replicated``; ``derived``, copies that a serving path makes from
    the leaves once and reuses while they stand (``registry.run_cell``'s
    whole item table for kernel 2's ``dot_score``)."""

    def __init__(self, skeleton, leaves: dict):
        self.skeleton, self.leaves = skeleton, leaves
        self.derived = {}

    def tree(self) -> dict:
        return nest(self.leaves)

    def on(self, device):
        """The model with each leaf's copy on ``device`` (every leaf
        replicated, as a compute copy is)."""
        from repro_torch.distributed.sharding import whole

        return with_leaves(self.skeleton, {k: whole(v, device)
                                           for k, v in self.leaves.items()})


def param_leaves(params) -> dict:
    """The parameters keyed by path, in the reference's leaf order: a
    model's ``tree()``, a nested dict of tensors, or a
    :class:`ShardedParams`' leaves."""
    if isinstance(params, ShardedParams):
        return dict(params.leaves)
    return dict(flatten(params.tree() if isinstance(params, nn.Module)
                        else params))


def with_leaves(params, leaves: dict):
    """``params`` (a model or a nested dict) with the leaf at each path
    replaced by ``leaves[path]``; a model's new leaves are parameters that
    do not require grad, the rest of the model copied."""
    old = param_leaves(params)
    if isinstance(params, nn.Module):
        memo = {id(t): nn.Parameter(leaves[k].detach(), requires_grad=False)
                for k, t in old.items()}
        return copy.deepcopy(params, memo)
    return unflatten_like(params, [leaves[k] for k in old])


def map_params(fn, params):
    """``params`` with each leaf ``x`` at path ``k`` replaced by ``fn(k,
    x)``: a model, a nested dict or a :class:`ShardedParams`, kept so."""
    leaves = {k: fn(k, v) for k, v in param_leaves(params).items()}
    if isinstance(params, ShardedParams):
        return ShardedParams(params.skeleton, leaves)
    return with_leaves(params, leaves)


def init_train_state(params, *, grad_compression: bool = False) -> dict:
    """The state of a run from ``params``, which from here on require
    grad."""
    leaves = param_leaves(params)
    for p in leaves.values():
        p.requires_grad_(True)
    state = {"params": params, "opt": init_opt_state(leaves)}
    if grad_compression:
        state["ef"] = init_ef_state(leaves)
    return state


def _split(batch: dict, microbatch: int) -> list[dict]:
    """The batch's ``microbatch`` parts along dim 0; a 1-D tensor whose
    length ``microbatch`` does not divide is a shared side input, given
    whole to every part (the reference's rule)."""
    shared = {}
    for k, x in batch.items():
        if not isinstance(x, torch.Tensor) or x.dim() == 0:
            raise ValueError(f"batch[{k!r}] ({type(x).__name__}) cannot be "
                             "split into microbatches")
        shared[k] = x.dim() == 1 and x.shape[0] % microbatch != 0
        if not shared[k] and x.shape[0] % microbatch:
            raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                             "microbatch")
    return [{k: x if shared[k] else x.reshape(
                microbatch, x.shape[0] // microbatch, *x.shape[1:])[i]
             for k, x in batch.items()} for i in range(microbatch)]


class TrainStep:
    """``train_step(state, batch) -> (state, metrics)`` on one device
    (:func:`make_train_step`); its settings are what
    :func:`jit_train_step` runs over a mesh."""

    def __init__(self, loss_fn: Callable, opt_cfg: OptimizerConfig, *,
                 grad_compression: bool = False, microbatch: int = 1,
                 compute_cast: Callable | None = None,
                 grad_transform: Callable | None = None):
        self.loss_fn, self.opt_cfg = loss_fn, opt_cfg
        self.grad_compression, self.microbatch = grad_compression, microbatch
        self.compute_cast, self.grad_transform = compute_cast, grad_transform

    def value_and_grad(self, params, leaves, batch):
        """``(loss, aux, grads)`` of one batch: gradients with respect to
        ``leaves`` (``params``' leaves by path; a leaf split over a mesh's
        ``model`` axis gives its gradient in the same layout, a slice a
        position). Over a ``data_parallel.RowSplit`` ``leaves`` is a list,
        one dict a position, and the gradients are the positions' sum
        (:func:`_position_sum`)."""
        from repro_torch.distributed.sharding import BlockSharded, pieces

        loss, aux = self.loss_fn(params, batch)
        groups = leaves if isinstance(leaves, list) else [leaves]
        flat = [t for lv in groups for p in lv.values() for t in pieces(p)]
        gs = iter(torch.autograd.grad(loss, flat, allow_unused=True))
        per = []
        for lv in groups:
            grads = {}
            for k, p in lv.items():
                g = [torch.zeros_like(t) if g is None else g
                     for t, g in zip(pieces(p), gs)]
                grads[k] = (replace(p, shards=tuple(g))
                            if isinstance(p, BlockSharded) else g[0])
            per.append(grads)
        del gs
        grads = per[0] if len(per) == 1 else _position_sum(per)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, grads

    def _compute(self, params):
        """The compute copy (``compute_cast``, once a step) and its leaves,
        which require grad: the parameters themselves without a cast."""
        if self.compute_cast is None:
            return params, param_leaves(params)
        with torch.no_grad():
            cp = self.compute_cast(params)
        leaves = param_leaves(cp)
        for p in leaves.values():
            p.requires_grad_(True)
        return cp, leaves

    def __call__(self, state: dict, batch: Any) -> tuple[dict, dict]:
        cp, leaves = self._compute(state["params"])
        parts = ([batch] if self.microbatch <= 1
                 else _split(batch, self.microbatch))
        loss, aux, grads = accumulate(self, [(cp, leaves, p) for p in parts])
        return state, self.finish(state, loss, aux, grads)

    def finish(self, state: dict, loss, aux: dict, grads: dict,
               update: Callable | None = None) -> dict:
        """The step's end, in place on ``state``: gradient compression,
        then ``update(state, grads) -> metrics`` (default: ``adamw_update``
        on one device). Returns the step's metrics."""
        if self.grad_compression:
            grads, state["ef"] = compress_grads_with_ef(grads, state["ef"])
        if update is None:
            _, state["opt"], opt_metrics = adamw_update(
                param_leaves(state["params"]), grads, state["opt"],
                self.opt_cfg)
        else:
            opt_metrics = update(state, grads)
        return {"loss": loss, **opt_metrics, **aux}


def _position_sum(per: list) -> dict:
    """The positions' gradients (one dict a position, each leaf in its
    position's compute layout) added leaf by leaf in position order into
    float32 at the first position's pieces, then rounded once to their
    dtype. Each position's gradient is dropped once added."""
    from repro_torch.distributed.sharding import map_pieces, pieces

    out = {}
    for k in list(per[0]):
        vs = [g.pop(k) for g in per]
        dtype = pieces(vs[0])[0].dtype
        acc = map_pieces(lambda z: z.to(torch.float32), vs.pop(0))
        while vs:
            v = vs.pop(0)
            for a, b in zip(pieces(acc), pieces(v)):
                a.add_(b.to(a.device, torch.float32))
            del v
        out[k] = map_pieces(lambda a: a.to(dtype), acc)
    return out


def accumulate(step: TrainStep, work: list, lay: Callable | None = None,
               mark: Callable | None = None) -> tuple:
    """``(loss, aux, grads)`` over ``work``'s parts, each ``(params,
    leaves, part)``, in order: the gradients with respect to ``leaves``,
    through ``step.grad_transform``, then ``lay(path, grad)`` (where the
    accumulator lives; default: where they are). One part gives them as
    they come, as the reference's ``microbatch <= 1`` does; several add
    into float32 accumulators in the first part's layout, then scale by
    1/parts, as its scan does, and average loss and aux the same way.
    ``mark`` is called with ``"forward_backward"`` and ``"reduce"`` as each
    part's two halves begin."""
    from repro_torch.distributed.sharding import map_pieces

    t = step.grad_transform
    acc = lsum = auxsum = None
    for params, leaves, part in work:
        if mark:
            mark("forward_backward")
        loss, aux, g = step.value_and_grad(params, leaves, part)
        if mark:
            mark("reduce")
        if t:
            g = t(g)
        if lay:
            g = {k: lay(k, v) for k, v in g.items()}
        if len(work) == 1:
            return loss, aux, g
        if acc is None:  # the accumulator adopts the (master) layout
            acc = {k: map_pieces(lambda z: torch.zeros(
                z.shape, dtype=torch.float32, device=z.device), v)
                for k, v in g.items()}
            lsum = torch.zeros((), dtype=torch.float32, device=loss.device)
            auxsum = {k: torch.zeros((), dtype=torch.float32,
                                     device=loss.device) for k in aux}
        for k, v in g.items():
            map_pieces(lambda a, b: a.add_(b.to(torch.float32)), acc[k], v)
        lsum = lsum + loss.to(lsum.device)
        auxsum = {k: a + aux[k].to(a.device) for k, a in auxsum.items()}
    inv = 1.0 / len(work)
    return (lsum * inv, {k: a * inv for k, a in auxsum.items()},
            {k: map_pieces(lambda a: a * inv, v) for k, v in acc.items()})


def make_train_step(loss_fn: Callable, opt_cfg: OptimizerConfig, *,
                    grad_compression: bool = False, microbatch: int = 1,
                    compute_cast: Callable | None = None,
                    grad_transform: Callable | None = None) -> TrainStep:
    """``loss_fn(params, batch) -> (loss, aux)``; returns
    ``train_step(state, batch) -> (state, metrics)``.

    ``microbatch > 1`` splits the batch's leading dim (:func:`_split`) and
    sums float32 gradients over the parts in order, then scales by
    1/``microbatch``, as the reference's scan does; loss and aux are
    averaged the same way. ``compute_cast(params)`` gives the compute copy
    (once a step) whose gradients are taken; ``grad_transform(grads)``
    applies to each part's gradients, and the accumulator takes its
    layout (the reference's ZeRO-1 hooks, ``distributed.sharding``)."""
    return TrainStep(loss_fn, opt_cfg, grad_compression=grad_compression,
                     microbatch=microbatch, compute_cast=compute_cast,
                     grad_transform=grad_transform)


# ---------------------------------------------------------------------------
# the step over a mesh
# ---------------------------------------------------------------------------
def _to(batch: dict, device) -> dict:
    return {k: v.to(device) if hasattr(v, "to") else v
            for k, v in batch.items()}


class ShardedTrainStep:
    """A :class:`TrainStep` over the mesh of its shardings
    (:func:`jit_train_step`). Its row positions are those over which the
    batch's shardings split the rows (``data_parallel.row_axes``): the
    data positions, or every position for a batch split over ``("pod",
    "data", "model")`` (GIN's node batch); one position for a batch
    replicated whole. Where their count divides the step's ``microbatch``
    the parts are dealt out whole, ``per_shard`` to each position in
    order; otherwise (``split``) each part's rows are split over the
    positions and its loss reduced across them. ``on_phase``, when set, is
    called with ``"gather"``, ``"forward_backward"``, ``"reduce"``,
    ``"update"`` (gradient compression, the norm and AdamW) and ``"end"``
    as each part of a step begins (a clock's marks)."""

    def __init__(self, step: TrainStep, in_shardings, out_shardings=None):
        from repro_torch.distributed import data_parallel as dp
        from repro_torch.distributed import tensor_parallel as tp
        from repro_torch.distributed.api import NamedSharding
        from repro_torch.distributed.sharding import split_of, without_data

        state_sh, batch_sh = in_shardings
        meshes = {s.mesh for s in dp.shardings_of(in_shardings)}
        if len(meshes) != 1:
            raise ValueError(f"in_shardings lie on {len(meshes)} meshes; "
                             "a step runs over one")
        mesh = meshes.pop()
        # a data position computes over ``model`` where a leaf is split
        # over it (the LM and recsys rules; GIN replicates every leaf)
        self.tp = any(tp.MODEL in axes for s in state_sh["params"].values()
                      for _, axes in split_of(without_data(s.spec), mesh))
        self.step, self.mesh, self.state_sh = step, mesh, state_sh
        self.batch_sh = batch_sh
        self.out_state_sh = out_shardings[0] if out_shardings else None
        axes = dp.row_axes(mesh, batch_sh)
        if self.tp:
            if tp.MODEL in axes:
                raise ValueError("the batch's rows split over 'model', "
                                 "which the parameters are split over")
            # each data position's devices, one a model position (home
            # first)
            self.rows = tp.data_rows(mesh) if axes else tp.data_rows(
                mesh)[:1]
        else:
            self.rows = [(d,) for d in dp.row_devices(mesh, axes)]
        self.devices = tuple(row[0] for row in self.rows)
        n, mb = len(self.devices), max(step.microbatch, 1)
        self.split = mb % n != 0
        self.per_shard = 0 if self.split else mb // n
        self.whole = NamedSharding(mesh, ())
        self.on_phase = None

    def _mark(self, name: str) -> None:
        if self.on_phase is not None:
            self.on_phase(name)

    def place(self, state: dict, shardings: dict | None = None) -> dict:
        """``state`` laid out by ``shardings`` (default: the step's state
        shardings), in place: a model's parameters become a
        :class:`ShardedParams`, every split leaf its own tensor a shard;
        a leaf already so laid out stays as it is."""
        from repro_torch.distributed.sharding import place

        sh = shardings or self.state_sh
        params = state["params"]
        if not isinstance(params, ShardedParams):
            leaves = param_leaves(params)
            params = ShardedParams(with_leaves(params, {
                k: torch.empty(v.shape, dtype=v.dtype, device="meta")
                for k, v in leaves.items()}), leaves)
            state["params"] = params

        def lay(tree: dict, specs: dict) -> dict:
            return {k: place(v.detach() if isinstance(v, torch.Tensor) else v,
                             specs[k], copy=True) for k, v in tree.items()}

        params.leaves = lay(params.leaves, sh["params"])
        opt = state["opt"]
        opt["m"], opt["v"] = lay(opt["m"], sh["opt"]["m"]), lay(
            opt["v"], sh["opt"]["v"])
        opt["step"] = place(opt["step"], sh["opt"]["step"])
        if "ef" in state:
            state["ef"] = lay(state["ef"], sh["ef"])
        return state

    def __call__(self, state: dict, batch: Any) -> tuple[dict, dict]:
        from repro_torch.distributed.api import activate_mesh
        from repro_torch.distributed.sharding import place

        st = self.step
        state = self.place(state)
        master_sh = self.state_sh["params"]
        dev0 = self.devices[0]
        with activate_mesh(self.mesh):
            self._mark("gather")
            with torch.no_grad():
                cp = (st.compute_cast(state["params"]) if st.compute_cast
                      else state["params"])
                if not isinstance(cp, ShardedParams):
                    raise TypeError("compute_cast of placed parameters must "
                                    "give placed parameters (map_params)")
            parts = [batch] if st.microbatch <= 1 else _split(batch,
                                                               st.microbatch)
            if self.split:
                work = self._row_split_work(cp, master_sh, parts)
            elif self.tp:
                work = self._model_parallel_work(cp, master_sh, parts)
            else:
                distinct = list(dict.fromkeys(self.devices))
                replicas = {str(dev): (model, param_leaves(model))
                            for dev, model in zip(distinct, self._replicas(
                                cp, distinct))}
                work = [(*replicas[str(dev)], _to(part, dev)) for part, dev in
                        zip(parts, (d for d in self.devices
                                    for _ in range(self.per_shard)))]
                del replicas
            del cp
            loss, aux, grads = accumulate(
                st, work, lay=lambda k, g: place(g, master_sh[k]),
                mark=self._mark)
            del work
            self._mark("update")
            metrics = st.finish(state, loss.to(dev0),
                                {k: a.to(dev0) for k, a in aux.items()},
                                grads, update=self._adamw)
            self._mark("end")
        if self.out_state_sh is not None:
            self.place(state, self.out_state_sh)
        return state, metrics

    def _replicas(self, cp: ShardedParams, devices) -> list:
        """One compute copy a device of ``devices``: the model whole on it,
        its leaves' storage shared with ``cp``'s copy there, each leaf its
        own tensor that requires grad."""
        from repro_torch.distributed.sharding import place

        with torch.no_grad():
            cp = ShardedParams(cp.skeleton, {
                k: place(v, self.whole) for k, v in cp.leaves.items()})
        out = []
        for dev in devices:
            model = cp.on(dev)
            for p in param_leaves(model).values():
                p.requires_grad_(True)
            out.append(model)
        return out

    def _model_parallel_copies(self, cp: ShardedParams, master_sh: dict,
                               rows: list) -> list:
        """One compute copy over the ``model`` axis
        (``tensor_parallel.ModelParallel``) for each of ``rows``: every
        leaf laid out as its master minus the data axes (the reference's
        compute spec), a split leaf's slices on the row's devices, a whole
        leaf at its home; each piece requires grad."""
        from repro_torch.distributed.api import NamedSharding
        from repro_torch.distributed.sharding import place, without_data
        from repro_torch.distributed.tensor_parallel import ModelParallel

        with torch.no_grad():
            compute = {k: place(v, NamedSharding(
                self.mesh, without_data(master_sh[k].spec)))
                for k, v in cp.leaves.items()}
        return [ModelParallel.of(self.mesh, row, compute, requires_grad=True)
                for row in rows]

    def _model_parallel_work(self, cp: ShardedParams, master_sh: dict,
                             parts: list) -> list:
        """The parts dealt out over the data positions, each with its
        position's compute copy over the ``model`` axis (one a distinct
        row of devices)."""
        keys = list(dict.fromkeys(tuple(str(d) for d in r) for r in
                                  self.rows))
        firsts = [next(r for r in self.rows if tuple(str(d) for d in r) == key)
                  for key in keys]
        replicas = {key: (mp, mp.leaves) for key, mp in zip(
            keys, self._model_parallel_copies(cp, master_sh, firsts))}
        rows = (r for r in self.rows for _ in range(self.per_shard))
        return [(*replicas[tuple(str(d) for d in row)], _to(part, row[0]))
                for part, row in zip(parts, rows)]

    def _row_split_work(self, cp: ShardedParams, master_sh: dict,
                        parts: list) -> list:
        """Each part's rows split over the row positions
        (``data_parallel.split_rows``), with one compute copy a position
        (a ``data_parallel.RowSplit``), so that each position's gradient
        is its own and the positions' add in position order. A compute
        copy below float32 (ZeRO-1's bf16) is widened, an exact copy the
        model reads as it reads the copy: each position's gradient stays
        float32, and the sum is rounded once."""
        from repro_torch.distributed.data_parallel import RowSplit, split_rows
        from repro_torch.distributed.sharding import map_pieces

        with torch.no_grad():
            cp = map_params(lambda k, v: map_pieces(
                lambda t: t.float() if t.is_floating_point() else t, v), cp)
        copies = (self._model_parallel_copies(cp, master_sh, self.rows)
                  if self.tp else self._replicas(cp, self.devices))
        leaves = [m.leaves if self.tp else param_leaves(m) for m in copies]
        split = RowSplit(tuple(copies), self.devices)
        return [(split, leaves, split_rows(part, self.batch_sh, self.devices,
                                           self.mesh))
                for part in parts]

    def _adamw(self, state: dict, grads: dict) -> dict:
        """``adamw_update`` once per distinct device over the pieces that
        live there (the moments' pieces beside their leaf's), with the
        global norm of the whole leaves, each gathered on the first data
        position's device."""
        from repro_torch.distributed.sharding import Replicated, pieces, whole

        dev0 = self.devices[0]
        gnorm = global_norm(grads, whole=lambda x: whole(x, dev0))
        params, opt = state["params"].leaves, state["opt"]
        groups = {}
        for k, p in params.items():
            ps = [pieces(x) for x in (p, grads[k], opt["m"][k], opt["v"][k])]
            if len({len(x) for x in ps}) != 1 or any(
                    a.device != b.device or a.shape != b.shape
                    for x in ps[1:] for a, b in zip(ps[0], x)):
                raise ValueError(f"{k}: the leaf, its gradient and moments "
                                 "are laid out differently")
            for i, quad in enumerate(zip(*ps)):
                g = groups.setdefault(str(quad[0].device), ({}, {}, {}, {}))
                for d, x in zip(g, quad):
                    d[f"{k}#{i}"] = x
        steps, metrics = {}, {}
        for dev, (p, g, m, v) in groups.items():
            o = {"m": m, "v": v, "step": opt["step"].on(dev)}
            _, o, metrics[dev] = adamw_update(p, g, o, self.step.opt_cfg,
                                              gnorm=gnorm.to(dev))
            steps[dev] = o["step"]
        opt["step"] = Replicated(self.mesh, {
            k: steps.get(k, v) for k, v in opt["step"].copies.items()})
        return metrics[str(dev0)]


def jit_train_step(train_step, *, in_shardings=None, out_shardings=None):
    """``train_step`` over the mesh of ``in_shardings`` (``(state
    shardings, batch shardings)``, ``distributed.sharding.to_named`` of
    the specs): a :class:`ShardedTrainStep`. Without shardings, the step
    itself (one device, nothing to place). A ``model`` axis larger than 1
    computes over the rule's splits; a microbatch count that the row
    positions do not divide splits each microbatch's rows over them."""
    if in_shardings is None:
        return train_step
    return ShardedTrainStep(train_step, in_shardings, out_shardings)
