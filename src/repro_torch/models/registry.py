"""Architecture × shape registry: configs, abstract inputs, step
functions, shardings.

The port of ``repro/models/registry.py`` for the LM, GNN and recsys
families: ``list_archs``, ``family_of``, ``skips_of``, ``shapes_of``,
``all_cells`` (the 40 cells), ``resolve_config``, ``reduced_config``,
the families' ``_family_init``, and ``build_cell(arch, shape)``: a
:class:`Cell` with the shape's step function, its abstract arguments and
their sharding specs. Abstract arguments are tensors on the ``meta``
device (:func:`abstract_params`, :func:`abstract_train_state`, the batch
and cache builders), so every cell builds at full width with no memory;
``Cell.in_shardings(mesh)`` gives the shardings that
``train.jit_train_step`` takes, and :func:`run_cell` runs an LM serving
cell (prefill, chunked prefill, decode) over a mesh, the counterpart of
the reference's ``jax.jit(cell.fn, in_shardings=...)``. The port keeps uint32 leaves
(``bases``, ``row_gap_bases``) as int32 holding their bits, so those
abstract leaves are int32. Concrete batches with the reference's leaves
and dtypes: :func:`lm_batch_for`, :func:`recsys_batch_for`.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import importlib
from dataclasses import dataclass
from typing import Any, Callable

from repro_torch.configs.shapes import (GNN_SHAPES, LM_SHAPES, RECSYS_SHAPES,
                                        ShapeDef)

ARCH_IDS = {
    "olmoe-1b-7b": "repro_torch.configs.olmoe_1b_7b",
    "mixtral-8x7b": "repro_torch.configs.mixtral_8x7b",
    "h2o-danube-1.8b": "repro_torch.configs.h2o_danube_1_8b",
    "yi-6b": "repro_torch.configs.yi_6b",
    "glm4-9b": "repro_torch.configs.glm4_9b",
    "gin-tu": "repro_torch.configs.gin_tu",
    "sasrec": "repro_torch.configs.sasrec",
    "two-tower-retrieval": "repro_torch.configs.two_tower_retrieval",
    "bert4rec": "repro_torch.configs.bert4rec",
    "bst": "repro_torch.configs.bst",
}


def _module(arch_id: str):
    if arch_id not in ARCH_IDS:
        raise ValueError(f"unknown architecture {arch_id!r}; expected one "
                         f"of {tuple(ARCH_IDS)}")
    return importlib.import_module(ARCH_IDS[arch_id])


def list_archs() -> list[str]:
    return list(ARCH_IDS)


def family_of(arch_id: str) -> str:
    return _module(arch_id).FAMILY


def skips_of(arch_id: str) -> dict[str, str]:
    return dict(_module(arch_id).SKIPS)


def shapes_of(arch_id: str) -> dict[str, ShapeDef]:
    return {"lm": LM_SHAPES, "gnn": GNN_SHAPES,
            "recsys": RECSYS_SHAPES}[family_of(arch_id)]


def all_cells(include_skipped: bool = False):
    """Yield ``(arch_id, shape_name, skip_reason or None)`` for the 40
    cells."""
    for arch in list_archs():
        skips = skips_of(arch)
        for shape in shapes_of(arch):
            reason = skips.get(shape)
            if reason is None or include_skipped:
                yield arch, shape, reason


def resolve_config(arch_id: str, shape_name: str, *, dp_degree: int = 1,
                   overrides=None):
    """The architecture's config for one shape: a GNN takes ``d_feat``,
    ``n_classes``, ``task`` and the adjacency mode from the shape; an MoE
    LM dispatches in ``max(dp_degree, 1)`` groups. ``overrides`` replace
    fields; a key ``"moe.<field>"`` replaces a field of the MoE
    settings."""
    mod = _module(arch_id)
    cfg = mod.CONFIG
    shape = shapes_of(arch_id)[shape_name]
    if mod.FAMILY == "gnn":
        cfg = dataclasses.replace(
            cfg, d_feat=shape.dims["d_feat"],
            n_classes=shape.dims["n_classes"],
            task=shape.dims.get("task", "node"),
            compressed_adjacency=shape.dims.get("compressed_adjacency", False))
    if mod.FAMILY == "lm" and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, dispatch_groups=max(dp_degree, 1)))
    if overrides:
        moe_over = {k[4:]: v for k, v in overrides.items()
                    if k.startswith("moe.")}
        flat_over = {k: v for k, v in overrides.items() if "." not in k}
        if moe_over and getattr(cfg, "moe", None) is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, **moe_over))
        if flat_over:
            cfg = dataclasses.replace(cfg, **flat_over)
    return cfg


def _family_init(fam: str):
    """The family's ``init_params(cfg, *, seed, device)`` for a train
    state."""
    if fam == "lm":
        from repro_torch.models import lm

        return lm.init_params
    if fam == "gnn":
        from repro_torch.models import gnn

        return gnn.init_params
    from repro_torch.models import recsys

    return recsys.init_params


@contextlib.contextmanager
def _on_meta():
    """Every tensor made inside on the ``meta`` device, a ``device=``
    argument included (the initialisers draw on their generator's
    device): a full-width model with no memory."""
    import torch
    from torch.overrides import TorchFunctionMode

    class Mode(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = dict(kwargs or {})
            if "device" in kwargs:
                kwargs["device"] = torch.device("meta")
            return func(*args, **kwargs)

    with torch.device("meta"), Mode():
        yield


def abstract_params(cfg, fam: str, *, dtype=None):
    """The family's parameters for ``cfg`` on the ``meta`` device (shapes
    and dtypes, no memory); floating leaves in ``dtype`` if given."""
    import torch

    from repro_torch.train.train_state import map_params

    with _on_meta():
        params = _family_init(fam)(cfg, generator=torch.Generator("cpu"))
    if dtype is not None:
        params = map_params(lambda k, p: p.to(dtype) if p.is_floating_point()
                            else p, params)
    return params


def abstract_train_state(cfg, fam: str) -> dict:
    """``init_train_state`` of :func:`abstract_params` (``meta``)."""
    from repro_torch.train import init_train_state

    return init_train_state(abstract_params(cfg, fam))


# ----------------------------------------------------------------------------
# batch builders: (abstract batch, spec tree)
# ----------------------------------------------------------------------------
def _meta(shape, dtype):
    import torch

    return torch.empty(shape, dtype=getattr(torch, dtype), device="meta")


def _entries(entries: dict) -> tuple[dict, dict]:
    """``{name: (shape, dtype name, spec)}`` as (meta batch, specs)."""
    return ({k: _meta(s, d) for k, (s, d, _) in entries.items()},
            {k: p for k, (_, _, p) in entries.items()})


def _lm_batch(cfg, shape: ShapeDef):
    from repro_torch.distributed.sharding import DP

    B, S = shape.dims["global_batch"], shape.dims["seq_len"]
    if shape.step == "train":
        return _entries({"tokens": ((B, S + 1), "int32", (DP, None))})
    if shape.step == "prefill":
        return _entries({"tokens": ((B, S), "int32", (DP, None))})
    if shape.step == "decode":
        return _entries({"tokens": ((B,), "int32",
                                    (DP,) if B >= 16 else (None,))})
    raise ValueError(shape.step)


def _lm_cache(cfg, shape: ShapeDef, mesh_dp: int):
    from repro_torch.distributed.sharding import lm_cache_spec
    from repro_torch.models import lm

    B, S = shape.dims["global_batch"], shape.dims["seq_len"]
    kv = (cfg.n_layers, B, lm.cache_size(cfg, S), cfg.n_kv_heads, cfg.dh)
    spec = lm_cache_spec(cfg, B, mesh_dp)
    return ({"k": _meta(kv, "bfloat16"), "v": _meta(kv, "bfloat16"),
             "index": _meta((), "int32")},
            {"k": spec, "v": spec, "index": ()})


def _abstract_compressed(leaves: dict, *, format: str, differential: bool,
                         n: int, block_size: int = 128):
    """A ``CompressedIntArray`` of ``meta`` leaves (an abstract batch
    entry)."""
    from repro_torch.core.compressed_array import CompressedIntArray

    return CompressedIntArray(
        counts_host=None, format=format, block_size=block_size,
        differential=differential, n=n,
        **{k: _meta(s, d) for k, (s, d) in leaves.items()})


def _gnn_batch(cfg, shape: ShapeDef):
    from repro_torch.distributed.sharding import ALL, compressed_array_specs

    d = shape.dims
    N, E, F = d["n_nodes"], d["n_edges"], d["d_feat"]
    shard = d.get("task", "node") == "node"  # a molecule batch: replicated
    nspec = (ALL, None) if shard else (None, None)
    espec = (ALL,) if shard else (None,)
    node = cfg.task == "node"
    entries = {
        "feats": ((N, F), "bfloat16" if cfg.feats_dtype == "bf16"
                  else "float32", nspec),
        "labels": ((N if node else d["batch_graphs"],), "int32",
                   espec if node else (None,)),
        "edge_valid": ((E,), "bool", espec),
    }
    if node:
        entries["label_mask"] = ((N,), "bool", espec)
    else:
        entries["graph_ids"] = ((N,), "int32", (None,))
    if cfg.compressed_adjacency:
        nb = -(-(-(-E // 128)) // 512) * 512  # block-shardable
        entries.update({"row_gap_bases": ((N,), "int32", (None,)),
                        "row_offsets": ((N + 1,), "int32", (None,))})
        batch, specs = _entries(entries)
        batch["gaps"] = _abstract_compressed(
            {"payload": ((nb, d["payload_stride"]), "uint8"),
             "counts": ((nb,), "int32"), "bases": ((nb,), "int32")},
            format="vbyte", differential=True, n=E)
        specs["gaps"] = compressed_array_specs(batch["gaps"], axis=ALL)
        return batch, specs
    entries.update({"edge_src": ((E,), "int32", espec),
                    "edge_dst": ((E,), "int32", espec)})
    return _entries(entries)


def _recsys_batch(cfg, shape: ShapeDef):
    from repro_torch.distributed.sharding import (ALL, DP,
                                                  compressed_array_specs)

    B, L, k = shape.dims["batch"], cfg.seq_len, cfg.kind
    rows = (DP, None)
    if shape.step == "train":
        if k == "sasrec":
            return _entries({"hist": ((B, L + 1), "int32", rows),
                             "neg": ((B, L), "int32", rows)})
        if k == "bert4rec":
            return _entries({
                "hist": ((B, L), "int32", rows),
                "mask_pos": ((B, cfg.n_mask), "int32", rows),
                "targets": ((B, cfg.n_mask), "int32", rows),
                "negatives": ((cfg.n_negatives,), "int32", (None,))})
        if k == "bst":
            return _entries({"hist": ((B, L), "int32", rows),
                             "target": ((B,), "int32", (DP,)),
                             "label": ((B,), "int32", (DP,))})
        if k == "two_tower":
            return _entries({"user_id": ((B,), "int32", (DP,)),
                             "hist": ((B, L), "int32", rows),
                             "item_id": ((B,), "int32", (DP,))})
    if shape.step == "serve":
        C = cfg.serve_candidates
        if k == "bst":
            return _entries({"hist": ((B, L), "int32", rows),
                             "target": ((B,), "int32", (DP,))})
        if k == "two_tower":
            return _entries({"user_id": ((B,), "int32", (DP,)),
                             "hist": ((B, L), "int32", rows),
                             "cands": ((C,), "int32", (None,))})
        return _entries({"hist": ((B, L), "int32", rows),
                         "cands": ((B, C), "int32", rows)})
    if shape.step == "retrieval":
        nc = shape.dims["n_candidates"]
        nb = nc // 128
        entries = {"hist": ((1, L), "int32", (None, None))}
        if k == "two_tower":
            entries["user_id"] = ((1,), "int32", (None,))
        batch, specs = _entries(entries)
        batch["cands"] = _abstract_compressed(
            {"payload": ((nb, shape.dims["payload_stride"]), "uint8"),
             "counts": ((nb,), "int32"), "bases": ((nb,), "int32")},
            format="vbyte", differential=True, n=nc)
        specs["cands"] = compressed_array_specs(batch["cands"], axis=ALL)
        return batch, specs
    raise ValueError((cfg.kind, shape.step))


# ----------------------------------------------------------------------------
# cells
# ----------------------------------------------------------------------------
@dataclass
class Cell:
    arch_id: str
    shape: ShapeDef
    family: str
    cfg: Any
    fn: Callable  # positional-args step function
    args: tuple  # abstract args (meta tensors)
    arg_specs: tuple  # spec trees matching args
    donate: tuple[int, ...] = ()
    assembly: dict = None  # step-assembly options (e.g. zero1)

    def in_shardings(self, mesh):
        from repro_torch.distributed.sharding import to_named

        return to_named(mesh, self.arg_specs)


# overrides that configure the *step assembly*, not the model config
_STEP_OVERRIDES = ("zero1", "prefill_impl", "prefill_chunk", "grad_bf16")


def zero1_hooks(params, base_rule):
    """The reference's ZeRO-1 assembly: ``(master_spec, compute_cast,
    grad_transform)`` for ``params`` under ``base_rule``. The master and
    moments take :func:`~repro_torch.distributed.sharding.zero1_extend` of
    the rule (split over the data axes); ``compute_cast`` casts the
    master to bf16 laid out by the rule (one gather a step);
    ``grad_transform`` casts gradients to bf16 laid out as the master."""
    import torch

    from repro_torch.distributed import constrain
    from repro_torch.distributed import sharding as shd
    from repro_torch.train import map_params

    master_spec = shd.tree_specs(
        params, lambda p, leaf: shd.zero1_extend(base_rule(p, leaf), leaf))
    compute_spec = shd.tree_specs(params, base_rule)

    def compute_cast(master):  # one bf16 gather a step
        return map_params(lambda k, p: constrain(p.to(torch.bfloat16),
                                                 *compute_spec[k]), master)

    def grad_transform(g):  # bf16, laid out as the master
        return {k: constrain(x.to(torch.bfloat16), *master_spec[k])
                for k, x in g.items()}

    return master_spec, compute_cast, grad_transform


def build_cell(arch_id: str, shape_name: str, *, mesh_dp: int = 32,
               overrides: dict[str, Any] | None = None,
               opt_cfg=None) -> Cell:
    """The cell ``(arch_id, shape_name)``: its config at ``mesh_dp`` data
    shards, step function, abstract arguments and specs. ``overrides``
    replace config fields, and ``zero1``, ``prefill_impl``,
    ``prefill_chunk``, ``grad_bf16`` configure the step's assembly."""
    import torch

    from repro_torch.distributed import sharding as shd
    from repro_torch.train import OptimizerConfig, make_train_step

    opt_cfg = opt_cfg or OptimizerConfig()
    fam = family_of(arch_id)
    shape = shapes_of(arch_id)[shape_name]
    overrides = dict(overrides or {})
    step_over = {k: overrides.pop(k) for k in _STEP_OVERRIDES
                 if k in overrides}
    cfg = resolve_config(arch_id, shape_name, dp_degree=mesh_dp,
                         overrides=overrides)

    if fam == "lm":
        from repro_torch.models import lm

        batch, bspec = _lm_batch(cfg, shape)
        if shape.step == "train":
            zero1 = bool(step_over.get("zero1", False))
            state = abstract_train_state(cfg, fam)
            sspec = shd.state_specs(state["params"],
                                    shd.lm_param_spec(cfg, zero1=zero1))
            compute_cast = grad_transform = None
            if zero1:
                _, compute_cast, grad_transform = zero1_hooks(
                    state["params"], shd.lm_param_spec(cfg))
            step = make_train_step(
                functools.partial(lm.loss_fn, cfg=cfg), opt_cfg,
                microbatch=cfg.microbatch, compute_cast=compute_cast,
                grad_transform=grad_transform)
            return Cell(arch_id, shape, fam, cfg, step, (state, batch),
                        (sspec, bspec), donate=(0,), assembly={"zero1": zero1})
        params = abstract_params(cfg, fam, dtype=torch.bfloat16)
        pspec = shd.tree_specs(params, shd.lm_param_spec(cfg))
        if shape.step == "prefill":
            if step_over.get("prefill_impl") == "chunked":
                fn = functools.partial(
                    _lm_prefill_chunked_fn, cfg=cfg,
                    chunk=int(step_over.get("prefill_chunk", 4096)))
            else:
                fn = functools.partial(_lm_prefill_fn, cfg=cfg,
                                       seq=shape.dims["seq_len"])
            return Cell(arch_id, shape, fam, cfg, fn,
                        (params, batch["tokens"]), (pspec, bspec["tokens"]))
        cache, cspec = _lm_cache(cfg, shape, mesh_dp)
        fn = functools.partial(_lm_decode_fn, cfg=cfg)
        return Cell(arch_id, shape, fam, cfg, fn,
                    (params, cache, batch["tokens"]),
                    (pspec, cspec, bspec["tokens"]), donate=(1,))

    if fam == "gnn":
        from repro_torch.models import gnn

        batch, bspec = _gnn_batch(cfg, shape)
        state = abstract_train_state(cfg, fam)
        sspec = shd.state_specs(state["params"], shd.gnn_param_spec(cfg))
        step = make_train_step(functools.partial(gnn.loss_fn, cfg=cfg),
                               opt_cfg)
        return Cell(arch_id, shape, fam, cfg, step, (state, batch),
                    (sspec, bspec), donate=(0,))

    from repro_torch.models import recsys

    batch, bspec = _recsys_batch(cfg, shape)
    if shape.step == "train":
        state = abstract_train_state(cfg, fam)
        base_rule = shd.recsys_param_spec(cfg)
        sspec = shd.state_specs(state["params"], base_rule)
        zero1 = bool(step_over.get("zero1", False))
        compute_cast = grad_transform = None
        if zero1:
            master_spec, compute_cast, grad_transform = zero1_hooks(
                state["params"], base_rule)
            sspec = {"params": master_spec,
                     "opt": {"m": dict(master_spec), "v": dict(master_spec),
                             "step": ()}}
        step = make_train_step(functools.partial(recsys.loss_fn, cfg=cfg),
                               opt_cfg, compute_cast=compute_cast,
                               grad_transform=grad_transform)
        return Cell(arch_id, shape, fam, cfg, step, (state, batch),
                    (sspec, bspec), donate=(0,), assembly={"zero1": zero1})
    params = abstract_params(cfg, fam, dtype=torch.bfloat16)
    pspec = shd.tree_specs(params, shd.recsys_param_spec(cfg, serving=True))
    fn = functools.partial(_recsys_serve_fn if shape.step == "serve"
                           else _recsys_retrieval_fn, cfg=cfg)
    return Cell(arch_id, shape, fam, cfg, fn, (params, batch), (pspec, bspec))


def _replica(params, row: tuple, mesh):
    """One data position's compute copy of placed parameters: the model on
    its home device (a ``model`` axis of 1), else a ``ModelParallel``."""
    from repro_torch.distributed.tensor_parallel import ModelParallel

    if len(row) == 1:
        return params.on(row[0])
    return ModelParallel.of(mesh, row, params.leaves)


def _per_position(fn, n: int):
    """``fn`` (a cell's partial) for one of ``n`` data positions that
    split its rows: an MoE config's ``dispatch_groups`` divided among them
    (the reference keeps its dispatch groups batch-sharded: each data
    position holds ``G / n`` of them, over its own rows)."""
    cfg = fn.keywords.get("cfg")
    if n == 1 or cfg is None or cfg.moe is None:
        return fn
    G = cfg.moe.dispatch_groups
    if G % n:
        raise ValueError(f"{G} MoE dispatch groups do not split over {n} "
                         "data positions")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch_groups=G // n))
    return functools.partial(fn.func, *fn.args, **{**fn.keywords,
                                                   "cfg": cfg})


def _view(x, d: int, k: int, dim: int):
    """Data position ``d``'s part of a placed value whose dimension ``dim``
    is split over the data axes: its ``model`` slices, or its shard."""
    from dataclasses import replace

    from repro_torch.distributed.sharding import BlockSharded, Replicated

    if isinstance(x, Replicated):  # one device holds it: write it there
        return x.first
    if not isinstance(x, BlockSharded) or x.dim != dim:
        return x
    if x.dim2 is None:
        return x.shards[d]
    return BlockSharded(x.mesh, x.axes2, x.shards[d * k:(d + 1) * k], x.dim2)


def _join(parts: list, dim: int, mesh, spec: tuple):
    """The data positions' outputs (each a tensor, or a ``BlockSharded``
    over ``model``) joined along ``dim``, laid out by ``spec``."""
    from repro_torch.distributed.api import named_sharding
    from repro_torch.distributed.sharding import BlockSharded, DP, place

    dp = tuple(a for a in DP if mesh.shape.get(a, 1) > 1)
    if len(parts) == 1:
        out = parts[0]
    elif isinstance(parts[0], BlockSharded):
        out = BlockSharded(mesh, dp, tuple(s for p in parts for s in p.shards),
                           dim, parts[0].dim, parts[0].axes)
    else:
        out = BlockSharded(mesh, dp, tuple(parts), dim)
    return place(out, named_sharding(mesh, *spec))


def _placed(params, specs: dict):
    """``params`` (a model, or a ``ShardedParams`` a previous call
    returned) laid out by ``specs`` (a value already so placed stays as it
    is)."""
    import torch

    from repro_torch.distributed.sharding import place
    from repro_torch.train.train_state import (ShardedParams, param_leaves,
                                               with_leaves)

    leaves = param_leaves(params)
    if not isinstance(params, ShardedParams):
        skeleton = with_leaves(params, {
            key: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for key, v in leaves.items()})
    else:
        skeleton = params.skeleton
    out = {key: place(v.detach() if isinstance(v, torch.Tensor) else v,
                      specs[key]) for key, v in leaves.items()}
    if isinstance(params, ShardedParams) and all(
            out[key] is v for key, v in leaves.items()):
        return params  # as placed, with what was derived from it
    return ShardedParams(skeleton, out)


def run_cell(cell: Cell, mesh, *args):
    """``cell.fn`` over ``mesh`` for a serving cell: the counterpart of
    the reference's ``jax.jit(cell.fn, in_shardings=cell.in_shardings(
    mesh))(*args)``. The LM prefill, chunked prefill and decode cells run
    here; the recsys ``serve_p99``, ``serve_bulk`` and ``retrieval_cand``
    cells in :func:`_run_recsys_cell`.

    ``args`` are the cell's: the parameters (a model, or the
    ``ShardedParams`` a previous call returned placed), then the cache
    (decode) and the tokens. The runner places the parameters and the
    cache by the cell's specs (a value already so placed stays as it is,
    so a decode loop places once), activates the mesh and runs ``cell.fn``
    once a data position, on its rows (where the specs split the batch
    over the data axes; else the whole batch on the first data position)
    and its compute copy over the ``model`` axis. Returns ``cell.fn``'s
    outputs in the reference's boundary layouts: logits ``(DP, TP)`` (a
    batch the data positions do not split whole over them), a
    prefill's cache split along the sequence ``(None, DP, TP, None,
    None)``, a decode's cache as placed (written in place), and the placed
    parameters as ``(outputs, params)``."""
    import torch

    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.api import activate_mesh
    from repro_torch.distributed.sharding import DP, TP, BlockSharded, place

    if cell.shape.step == "train":
        raise ValueError(f"run_cell serves the LM and recsys serving cells, "
                         f"not {cell.arch_id}/{cell.shape.name} (a train "
                         "cell runs through train.jit_train_step)")
    if cell.family == "recsys":
        return _run_recsys_cell(cell, mesh, *args)
    k = mesh.shape.get(tp.MODEL, 1)
    sh = cell.in_shardings(mesh)
    params = _placed(args[0], sh[0])
    rows = tp.data_rows(mesh)
    n = len(rows)
    decode = cell.shape.step == "decode"
    tokens = args[-1]
    cache = None
    if decode:
        cache = {key: place(v, sh[1][key]) if key != "index" else v
                 for key, v in args[1].items()}
        split_rows = (isinstance(cache["k"], BlockSharded)
                      and cache["k"].dim == 1)
    else:
        split_rows = n > 1
    B = tokens.shape[0]
    if split_rows and B % n:
        raise ValueError(f"{B} rows do not split over {n} data positions")
    fn = _per_position(cell.fn, n) if split_rows else cell.fn
    outs = []
    with activate_mesh(mesh), torch.no_grad():
        for d, row in enumerate(rows if split_rows else rows[:1]):
            per = B // n if split_rows else B
            toks = tokens[d * per:(d + 1) * per].to(row[0])
            replica = _replica(params, row, mesh)
            if decode:
                c = {key: _view(v, d, k, 1) if key != "index" else v
                     for key, v in cache.items()}
                if not split_rows:
                    c = {key: _view(v, d, k, 1) for key, v in
                         _whole_over_data(c, mesh).items()}
                outs.append(fn(replica, c, toks))
                if not split_rows:
                    _write_back(outs[-1][1], cache)
            else:
                outs.append(fn(replica, toks))
    # rows the data positions do not split stay whole over them
    logits = _join([o[0] for o in outs], 0, mesh,
                   (DP if split_rows else None, TP))
    if decode:
        return (logits, {"k": cache["k"], "v": cache["v"],
                         "index": outs[0][1]["index"]}), params
    out_cache = {key: _join([o[1][key] for o in outs], 1, mesh,
                            (None, DP, TP, None, None))
                 for key in ("k", "v")}
    out_cache["index"] = outs[0][1]["index"]
    return (logits, out_cache), params


def _run_recsys_cell(cell: Cell, mesh, params, batch):
    """A recsys serving cell over ``mesh`` (:func:`run_cell`): the
    parameters placed by the serving rule (tables split by rows or
    columns over ``model``, the MLPs' column / row splits), each data
    position's compute copy a ``ModelParallel`` over its row of devices.

    * ``serve_p99`` / ``serve_bulk``: the rows split over the data
      positions (the batch specs), ``cell.fn`` once a position on its
      rows; the scores joined ``(DP, ...)``.
    * ``retrieval_cand``: the candidates' blocks split over every position
      (``("pod", "data", "model")``, count-0 blocks padding the last) and
      decoded where they lie, one launch a shard. SASRec and BERT4Rec
      score in kernel 2's ``dot_score``, which reads one whole table: the
      item table is placed whole once on each distinct device (the
      serving engine's layout over a mesh) in the cell's dtype, made at
      the first request and kept with the placed parameters
      (``ShardedParams.derived``). BST and two-tower decode (kernel 1),
      then each shard's candidates run through the ranker or the item
      tower of the data position that holds the shard. The query is
      computed once at home, and the ids and scores gathered there, cut
      to the request's own blocks, for one top-k: ``cell.fn`` itself,
      scoring through ``recsys.score_candidates`` a shard at a time.

    Returns ``(outputs, params)``: ``cell.fn``'s outputs and the placed
    parameters."""
    import torch

    from repro_torch.distributed import data_parallel as dp
    from repro_torch.distributed import tensor_parallel as tp
    from repro_torch.distributed.api import NamedSharding, activate_mesh
    from repro_torch.distributed.sharding import DP, place

    sh = cell.in_shardings(mesh)
    params = _placed(params, sh[0])
    rows = tp.data_rows(mesh)
    home = rows[0][0]
    replicas = {}

    def replica(r):
        if r not in replicas:
            replicas[r] = _replica(params, rows[r], mesh)
        return replicas[r]

    with activate_mesh(mesh), torch.no_grad():
        if cell.shape.step == "serve":
            parts = dp.split_rows(batch, sh[1], tuple(r[0] for r in rows),
                                  mesh)
            out = torch.cat([cell.fn(replica(r), part).to(home)
                             for r, part in enumerate(parts)])
            return place(out, NamedSharding(mesh, (DP,) + (None,) * (
                out.dim() - 1))), params
        return _recsys_retrieval(cell, mesh, params, batch, sh[1], rows,
                                 replica), params


def _recsys_retrieval(cell, mesh, params, batch, bsh, rows, replica):
    """``retrieval_cand`` over ``mesh`` (:func:`_run_recsys_cell`):
    ``cell.fn`` at home on the first data position's copy, its candidates
    scored a shard at a time (``recsys.score_candidates``): ``(scores,
    (top scores, top ids))`` as ``cell.fn`` returns them."""
    import torch

    from repro_torch.distributed import data_parallel as dp
    from repro_torch.distributed.api import NamedSharding
    from repro_torch.distributed.sharding import place
    from repro_torch.models import recsys

    cfg = cell.cfg
    home, k = rows[0][0], len(rows[0])
    devices = dp.row_devices(mesh, bsh["cands"].counts.spec[0])

    def table(dtype):
        """The item table whole in ``dtype``, one copy a distinct device:
        made once, kept with the placed parameters."""
        key = ("item_emb/emb", dtype)
        if key not in params.derived:
            params.derived[key] = place(
                params.leaves["item_emb/emb"],
                NamedSharding(mesh, ())).map(lambda t: t.to(dtype))
        return params.derived[key]

    def score(_, query, cands, cfg, *, plan, dtype):
        whole = table(dtype) if cfg.kind in ("sasrec", "bert4rec") else None
        out = [recsys.score_candidates(
            recsys.view(replica(i // k)), query.to(rows[i // k][0]), shard,
            cfg, table=whole.on(dev) if whole is not None else None,
            plan=plan, dtype=dtype)
            for i, (shard, dev) in enumerate(zip(dp.block_shards(
                cands, len(devices), devices), devices))]
        n_slots = cands.n_blocks * cands.block_size
        return tuple(torch.cat([o[j].to(home) for o in out])[:n_slots]
                     for j in (0, 1))

    local = {key: v.to(home) if isinstance(v, torch.Tensor) else v
             for key, v in batch.items()}
    return cell.fn(replica(0), local, score_fn=score)


def _whole_over_data(cache: dict, mesh) -> dict:
    """A cache whose data split is not its batch (the sequence: a batch the
    data positions do not divide) gathered along the data axes, its
    ``model`` split kept."""
    from repro_torch.distributed.api import NamedSharding
    from repro_torch.distributed.sharding import (DP, BlockSharded, place,
                                                  without_data)

    out = dict(cache)
    for key in ("k", "v"):
        x = cache[key]
        if isinstance(x, BlockSharded) and any(
                a in DP for _, axes in x.splits for a in axes):
            spec = [None] * len(x.shape)
            for dim, axes in x.splits:
                spec[dim] = axes
            out[key] = place(x, NamedSharding(mesh, without_data(spec)))
    return out


def _write_back(computed: dict, cache: dict) -> None:
    """The decode's cache, computed gathered over the data axes, copied
    into the placed cache's own shards."""
    from repro_torch.distributed.api import NamedSharding
    from repro_torch.distributed.sharding import BlockSharded, place

    for key in ("k", "v"):
        x = cache[key]
        if computed[key] is x or not isinstance(x, BlockSharded):
            continue
        spec = [None] * len(x.shape)
        for dim, axes in x.splits:
            spec[dim] = axes[0] if len(axes) == 1 else axes
        laid = place(computed[key], NamedSharding(x.mesh, tuple(spec)))
        for dst, src in zip(x.shards, laid.shards):
            if dst is not src:
                dst.copy_(src)


# top-level partials (picklable)
def _lm_prefill_fn(params, tokens, *, cfg, seq):
    from repro_torch.models import lm

    return lm.prefill(params, tokens, cfg, cache_capacity=seq)


def _lm_prefill_chunked_fn(params, tokens, *, cfg, chunk):
    from repro_torch.models import lm

    return lm.prefill_chunked(params, tokens, cfg, chunk=chunk)


def _lm_decode_fn(params, cache, tokens, *, cfg):
    from repro_torch.models import lm

    return lm.decode_step(params, cache, tokens, cfg)


def _recsys_serve_fn(params, batch, *, cfg):
    from repro_torch.models import recsys

    return recsys.serve_scores(params, batch, cfg)


def _recsys_retrieval_fn(params, batch, *, cfg, **kw):
    from repro_torch.models import recsys

    return recsys.retrieval_scores_compressed(params, batch, cfg, **kw)


def lm_batch_for(cfg, shape: ShapeDef, rng, *, device) -> dict:
    """A concrete batch of the LM ``shape`` for ``cfg``, token ids drawn
    uniformly from ``[0, vocab)`` by the numpy generator ``rng``: the
    leaves and dtypes of the reference's ``_lm_batch`` (int32 tensors on
    ``device``): ``tokens [B, S+1]`` (train), ``[B, S]`` (prefill) or
    ``[B]`` (decode), at the shape's ``global_batch`` and ``seq_len``."""
    import numpy as np
    import torch

    B, S = shape.dims["global_batch"], shape.dims["seq_len"]
    dims = {"train": (B, S + 1), "prefill": (B, S), "decode": (B,)}
    if shape.step not in dims:
        raise ValueError(shape.step)
    toks = rng.integers(0, cfg.vocab, size=dims[shape.step])
    return {"tokens": torch.as_tensor(toks.astype(np.int32), device=device)}


def recsys_batch_for(cfg, shape: ShapeDef, rng, *, device) -> dict:
    """A concrete batch of ``shape`` for the recsys config ``cfg``, drawn
    from the numpy generator ``rng``: the leaves and dtypes of the
    reference's ``_recsys_batch`` (int32 tensors on ``device``).

    * train — ``data.synthetic.recsys_batch`` at the shape's batch;
    * serve — ``hist [B, L]`` and ``target [B]`` (BST), ``user_id [B]``,
      ``hist`` and one candidate list ``cands [C]`` (two-tower), else
      ``hist`` and ``cands [B, C]``: the reference's ``serve_recsys``
      draws, in its order;
    * retrieval — ``hist [1, L]`` (and ``user_id [1]`` for two-tower) and
      ``cands``, a ``CompressedIntArray`` of the shape's ``n_candidates``
      distinct sorted ids drawn from the table's rows ``[1,
      vocab_rows)``: vbyte, differential, block 128, its payload stride a
      multiple of the shape's ``payload_stride``.
    """
    import numpy as np
    import torch

    from repro_torch.data.synthetic import recsys_batch

    def t(x):
        return torch.as_tensor(np.asarray(x, np.int32), device=device)

    B, L, k = shape.dims["batch"], cfg.seq_len, cfg.kind
    if shape.step == "train":
        b = recsys_batch(rng, k, B, L, cfg.n_items, n_mask=cfg.n_mask,
                         n_negatives=cfg.n_negatives, n_users=cfg.n_users)
        return {name: t(v) for name, v in b.items()}
    if shape.step == "serve":
        C = cfg.serve_candidates
        if k == "bst":
            return {"hist": t(rng.integers(1, cfg.n_items, (B, L))),
                    "target": t(rng.integers(1, cfg.n_items, B))}
        if k == "two_tower":
            return {"user_id": t(rng.integers(1, 100, B)),
                    "hist": t(rng.integers(1, cfg.n_items, (B, L))),
                    "cands": t(rng.integers(1, cfg.n_items, C))}
        return {"hist": t(rng.integers(1, cfg.n_items, (B, L))),
                "cands": t(rng.integers(1, cfg.n_items, (B, C)))}
    if shape.step == "retrieval":
        from repro_torch.core import CompressedIntArray

        n = shape.dims["n_candidates"]
        batch = {"hist": t(rng.integers(1, cfg.n_items, (1, L)))}
        if k == "two_tower":
            batch["user_id"] = t(rng.integers(1, max(cfg.n_users, 2), 1))
        ids = np.sort(rng.choice(np.arange(1, cfg.vocab_rows, dtype=np.int64),
                                 n, replace=False))
        batch["cands"] = CompressedIntArray.encode(
            ids.astype(np.uint64), differential=True,
            stride_multiple=shape.dims["payload_stride"], device=device)
        return batch
    raise ValueError((k, shape.step))


def reduced_config(arch_id: str):
    """Tiny same-family config: a few layers and experts, small dims and
    tables."""
    mod = _module(arch_id)
    cfg, fam = mod.CONFIG, mod.FAMILY
    if fam == "lm":
        moe = cfg.moe and dataclasses.replace(
            cfg.moe, n_experts=min(cfg.moe.n_experts, 4),
            top_k=min(cfg.moe.top_k, 2), d_ff=64, capacity_factor=2.0,
        )
        return dataclasses.replace(
            cfg, n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)), head_dim=16,
            d_ff=128, vocab=512, moe=moe, window=cfg.window and 16,
            q_chunk=16, kv_chunk=16, loss_chunk=8,
        )
    if fam == "gnn":
        return dataclasses.replace(cfg, n_layers=2, d_hidden=16,
                                   d_feat=12, n_classes=3)
    return dataclasses.replace(
        cfg, n_items=1000, n_users=max(cfg.n_users and 1000, 0),
        embed_dim=16, id_dim=16, seq_len=min(cfg.seq_len, 12),
        n_blocks=1, n_heads=2 if cfg.kind != "sasrec" else 1,
        mlp_dims=(32, 16) if cfg.mlp_dims else (),
        n_mask=min(cfg.n_mask, 3) if cfg.n_mask else 0, n_negatives=16,
        serve_candidates=32,
    )
