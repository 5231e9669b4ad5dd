"""Dry run of every (arch × shape × mesh) cell on the ``meta`` device.

The port's analogue of ``repro/launch/dryrun.py``. The reference lowers
and compiles each cell for 512 forced host devices and reads XLA's memory
and cost analyses. The port compiles nothing: it builds each cell with
``registry.build_cell`` on ``meta`` tensors (shapes and dtypes, no
memory), over a mesh of ``meta`` positions, and no card is used or
needed. A record a cell:

* ``argument_bytes_per_device`` — the bytes of the placed arguments at
  the largest position: each leaf laid out by its spec over the mesh as
  ``distributed/sharding.py::split_of`` splits it (a split dimension
  rounded up to whole rows per position, a replicated leaf whole), split
  by part in ``argument_bytes_by_part``: ``params``, ``optimizer`` (the
  moments and step; ZeRO-1's split where the overrides ask for it),
  ``batch`` and ``cache``;
* ``fits_80GB`` — those bytes below one H100's 80 GB (arguments only:
  activations and temporaries are not counted);
* ``corrected_flops_per_device``, ``corrected_bytes_per_device``,
  ``wire_bytes_per_device`` — ``launch/cost_model.py::cell_cost``;
* ``model_flops_per_device`` and ``roofline`` —
  ``launch/roofline_math.py`` over one H100's datasheet peaks;
* ``not_carried_over`` — the reference's fields with no counterpart
  here, and why.

``distributed/hlo_analysis.py`` (the reference's parser of XLA's HLO text
for collectives) has no counterpart: the port produces no HLO, and the
wire term is the cost model's.

The default mesh is the reference's production mesh, ``(16, 16)``
``("data", "model")`` or ``(2, 16, 16)`` with ``--multi-pod``
(``repro/launch/mesh.py``), so the two packages' records compare per
device; ``--cards N`` gives an H100 host's ``(N, 1)`` (``(1, N, 1)`` with
``--multi-pod``), every card on ``data``. Usage::

    python -m repro_torch.launch.dryrun --all --cards 1
    python -m repro_torch.launch.dryrun --arch h2o-danube-1.8b \\
        --shape train_4k --cards 4 --override zero1=true
    python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--out experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import math
import os
import traceback

CARD_BYTES = 80e9  # one H100's HBM (NVIDIA datasheet)
NOT_CARRIED_OVER = {
    "lower_s, compile_s": "nothing is lowered or compiled",
    "hlo_flops_per_device, hlo_bytes_per_device": "no HLO: the cost "
    "model's corrected terms stand alone",
    "output_size_in_bytes, temp_size_in_bytes, alias_size_in_bytes, "
    "generated_code_size_in_bytes, peak_bytes_per_device": "no compiler "
    "memory analysis: only the arguments' bytes are counted",
    "collectives, wire_bytes_parsed": "no HLO to parse "
    "(distributed/hlo_analysis.py is not ported): the wire term is the "
    "cost model's",
}


def _parse_overrides(items):
    out = {}
    for kv in items or []:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                out[k] = cast(v)
                break
            except ValueError:
                continue
        else:
            out[k] = {"true": True, "false": False}.get(v.lower(), v)
    return out


def meta_mesh(shape: tuple):
    """A mesh of ``meta`` positions: ``("data", "model")``, or ``("pod",
    "data", "model")`` for a 3-axis shape."""
    from repro_torch.distributed import make_mesh

    axes = (("pod", "data", "model") if len(shape) == 3
            else ("data", "model"))
    return make_mesh(tuple(shape), axes, devices=["meta"] * math.prod(shape))


def _pairs(arg, spec):
    """``(tensor, spec)`` for every leaf of an argument and its spec tree:
    models by their leaves' paths, dicts, tuples and ``CompressedIntArray``
    leaves by name."""
    import torch

    from repro_torch.core.compressed_array import (FORMAT_LEAVES,
                                                   CompressedIntArray)
    from repro_torch.distributed.sharding import _is_spec
    from repro_torch.train.train_state import ShardedParams, param_leaves

    if _is_spec(spec):
        yield arg, spec
        return
    if isinstance(arg, (torch.nn.Module, ShardedParams)):
        arg = param_leaves(arg)
    if isinstance(arg, CompressedIntArray):
        for k in FORMAT_LEAVES[arg.format]:
            yield getattr(arg, k), getattr(spec, k)
    elif isinstance(arg, dict):
        for k, v in arg.items():
            yield from _pairs(v, spec[k])
    elif isinstance(arg, (tuple, list)):
        for a, s in zip(arg, spec, strict=True):
            yield from _pairs(a, s)
    else:
        raise TypeError(f"not an argument tree: {type(arg).__name__}")


def position_bytes(t, spec: tuple, mesh) -> int:
    """The bytes of ``t`` at the largest position of ``mesh`` when laid
    out by ``spec``: each split dimension divided by its positions,
    rounded up."""
    from repro_torch.distributed.api import resolved_spec
    from repro_torch.distributed.sharding import split_of

    shape = list(t.shape)
    for dim, axes in split_of(resolved_spec(spec, mesh), mesh):
        n = math.prod(mesh.shape[a] for a in axes)
        shape[dim] = -(-shape[dim] // n)
    return math.prod(shape) * t.element_size()


def argument_parts(cell) -> dict:
    """The cell's arguments and specs by part: ``{part: [(arg, spec)]}``
    for ``params``, ``optimizer``, ``batch`` and ``cache``."""
    args, specs = cell.args, cell.arg_specs
    parts = {"params": [], "optimizer": [], "batch": [], "cache": []}
    if isinstance(args[0], dict) and "opt" in args[0]:  # a train state
        state, sspec = args[0], specs[0]
        for k, v in state.items():
            parts["params" if k == "params" else "optimizer"].append(
                (v, sspec[k]))
        parts["batch"].append((args[1], specs[1]))
        return parts
    parts["params"].append((args[0], specs[0]))
    if cell.family == "lm" and cell.shape.step == "decode":
        parts["cache"].append((args[1], specs[1]))
        parts["batch"].append((args[2], specs[2]))
    else:
        parts["batch"].extend(zip(args[1:], specs[1:]))
    return parts


def argument_bytes(cell, mesh) -> dict:
    """Bytes a position holds of each part (:func:`argument_parts`), each
    leaf at its largest position."""
    return {part: sum(position_bytes(t, s, mesh)
                      for arg, spec in pairs for t, s in _pairs(arg, spec))
            for part, pairs in argument_parts(cell).items()}


def run_cell(arch: str, shape: str, *, mesh_shape: tuple | None = None,
             multi_pod: bool = False, overrides: dict | None = None) -> dict:
    """One cell's record (module docstring) over a ``meta`` mesh of
    ``mesh_shape`` (default: the reference's production mesh)."""
    from repro_torch.launch import cost_model as cm
    from repro_torch.launch import roofline_math as rm
    from repro_torch.launch.mesh import dp_degree
    from repro_torch.models import registry

    if mesh_shape is None:
        mesh_shape = (2, 16, 16) if multi_pod else (16, 16)
    mesh = meta_mesh(mesh_shape)
    n = mesh.size
    dp, tp = dp_degree(mesh), mesh.shape["model"]
    cell = registry.build_cell(arch, shape, mesh_dp=dp, overrides=overrides)
    record = {
        "arch": arch, "shape": shape, "step": cell.shape.step,
        "mesh": "x".join(str(mesh.shape[a]) for a in mesh.axis_names),
        "n_chips": n, "overrides": overrides or {}, "device": "meta",
    }
    parts = argument_bytes(cell, mesh)
    total = sum(parts.values())
    record.update(argument_bytes_per_device=total,
                  argument_bytes_by_part=parts,
                  fits_80GB=total < CARD_BYTES)
    corr = cm.cell_cost(cell, n_chips=n, dp=dp, tp=tp)
    record["corrected_flops_per_device"] = corr.flops
    record["corrected_bytes_per_device"] = corr.bytes
    record["wire_bytes_per_device"] = corr.wire_bytes
    mf = rm.model_flops_global(cell) / n
    record["model_flops_per_device"] = mf
    record["roofline"] = rm.make_roofline(corr.flops, corr.bytes,
                                          corr.wire_bytes, mf).to_dict()
    record["not_carried_over"] = dict(NOT_CARRIED_OVER)
    return record


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--cards", type=int, default=None,
                    help="an H100 host's mesh: (N, 1), (1, N, 1) with "
                         "--multi-pod (default: the reference's (16, 16))")
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    from repro_torch.models import registry

    overrides = _parse_overrides(args.override)
    os.makedirs(args.out, exist_ok=True)
    cells = ([(a, s) for a, s, _ in registry.all_cells()] if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    print("dry run on the meta device: no card is used and nothing is "
          "allocated", flush=True)

    failures = 0
    for arch, shape in cells:
        for mp in meshes:
            mesh_shape = None
            tag = "multi" if mp else "single"
            if args.cards is not None:
                mesh_shape = ((1, args.cards, 1) if mp
                              else (args.cards, 1))
                tag += f"_{args.cards}cards"
            tag += f"_{args.tag}" if args.tag else ""
            name = f"{arch}__{shape}__{tag}"
            path = os.path.join(args.out, name + ".json")
            try:
                rec = run_cell(arch, shape, mesh_shape=mesh_shape,
                               multi_pod=mp, overrides=overrides)
                rec["tag"] = args.tag
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1)
                r = rec["roofline"]
                print(f"[OK] {name}: mesh={rec['mesh']} "
                      f"args/dev={rec['argument_bytes_per_device'] / 1e9:.3f}"
                      f"GB fits_80GB={rec['fits_80GB']} "
                      f"dominant={r['dominant']} "
                      f"bound={r['step_time_bound_s']:.3e}s "
                      f"roofline_frac={r['roofline_fraction']:.3f}",
                      flush=True)
            except Exception as e:  # a failing cell is a bug: record it
                failures += 1
                with open(path + ".err", "w") as f:
                    f.write(traceback.format_exc())
                print(f"[FAIL] {name}: {type(e).__name__}: {e}", flush=True)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
