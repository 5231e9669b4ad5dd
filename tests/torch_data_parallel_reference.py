"""The reference's train cells over ``(data, model)`` meshes, run once for
the port's tests.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        PYTHONPATH=src python tests/torch_data_parallel_reference.py \
        OUT.npz [CASE ...]

Runs under 8 forced host devices, on ``jax.sharding.Mesh`` meshes of
``Auto`` axes (the reference's own ``jax.make_mesh`` mesh makes its axes
``Explicit`` under jax 0.9, where its ``constrain`` raises: ROADMAP queue
3 item 11), for each case of ``CASES`` (all by default), and writes to
``OUT.npz``:

* ``<case>/init/<path>``: the reduced config's train state (seed 0:
  ``init_train_state`` of ``init_params``), as the reference's tree;
* ``<case>/batch/<leaf>``: the one batch every step takes (a GIN
  graph's edges, from which both packages build its compressed
  adjacency);
* ``<case>/<mesh><z>/…``: ``loss`` and ``grad_norm`` a step and the
  parameters after ``STEPS`` steps of the train cell's step at float32
  compute (``loss_fn(dtype=float32)``; ``z`` ``z1`` with ``build_cell``'s
  ZeRO-1 specs and hooks) under ``jax.jit(step, in_shardings=
  cell.in_shardings(mesh))``, for each mesh of the case.

The cells step at microbatch 1 (the LM case at 2 over 4 positions), so
each microbatch's rows split over the data positions (GIN's node batch
over every position) and the loss reduces across them.
``tests/test_torch_data_parallel.py`` holds the port against them (its
subprocesses add ``XLA_FAST_COMPILE`` to ``XLA_FLAGS``). Nothing of the
reference changes.
"""
import sys

import numpy as np

N_DEVICES = 8
# XLA's CPU compiler at optimization level 0 (the tests' subprocesses set
# it): the same functions, compiled in about three quarters of the time
XLA_FAST_COMPILE = ("--xla_backend_optimization_level=0 "
                    "--xla_llvm_disable_expensive_passes=true")
STEPS = 2
PEAK_LR = 1e-2
ROWS = 16  # recsys rows a batch
GRAPH = (64, 1000)  # GIN nodes, edges: 8 gap blocks, the last ragged
MOLECULE = (8, 8, 16)  # graphs, nodes and edges a graph
LM_ROWS, LM_SEQ = 8, 32
MESHES = {"2x1": (2, 1), "4x1": (4, 1), "2x2": (2, 2)}
# every rule of the recsys tables bites at 2^16 items (rows >= 2^16,
# ZeRO-1's 2^20 elements at width 16)
RECSYS_OVER = dict(n_items=1 << 16, n_users=1 << 16, embed_dim=16,
                   id_dim=16, seq_len=12, n_blocks=1, mlp_dims=(32, 16),
                   n_negatives=16, serve_candidates=32)
GIN_OVER = dict(n_layers=2, d_hidden=16, d_feat=12, n_classes=3)
LM_OVER = dict(n_layers=2, d_model=64, n_heads=8, n_kv_heads=4, head_dim=16,
               d_ff=128, vocab=1 << 10, window=None, q_chunk=16,
               kv_chunk=16, loss_chunk=8, microbatch=2)
# case: (arch, shape, overrides, runs: ((mesh, zero1), ...))
_ALL3 = (("2x1", False), ("4x1", False), ("2x2", False))
CASES = {
    "sasrec": ("sasrec", "train_batch", dict(RECSYS_OVER, n_heads=1),
               _ALL3 + (("2x2", True),)),
    "bert4rec": ("bert4rec", "train_batch", dict(RECSYS_OVER, n_heads=2,
                                                 n_mask=3),
                 _ALL3 + (("2x2", True),)),
    "bst": ("bst", "train_batch", dict(RECSYS_OVER, n_heads=2),
            _ALL3 + (("2x2", True),)),
    "two_tower": ("two-tower-retrieval", "train_batch", dict(RECSYS_OVER),
                  _ALL3 + (("2x2", True),)),
    "gin_full": ("gin-tu", "full_graph_sm", GIN_OVER, _ALL3),
    "gin_raw": ("gin-tu", "minibatch_lg", GIN_OVER, _ALL3),
    "gin_molecule": ("gin-tu", "molecule", GIN_OVER, _ALL3),
    "lm": ("h2o-danube-1.8b", "train_4k", LM_OVER, (("4x1", False),)),
}


def path_str(path) -> str:
    parts = []
    for p in path:
        for attr in ("key", "idx", "name"):
            if hasattr(p, attr):
                parts.append(str(getattr(p, attr)))
                break
    return "/".join(parts)


def flat(tree) -> dict:
    import jax

    return {path_str(p): np.asarray(x)
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def make_batch(case: str) -> dict:
    """The case's batch as numpy arrays (a GIN graph's raw edges; the
    compressed adjacency is built from them)."""
    from repro.data.synthetic import (molecule_batch, random_graph,
                                      recsys_batch)
    from repro.models import registry

    arch, shape, over, _ = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    if registry.family_of(arch) == "recsys":
        cfg = registry.build_cell(arch, shape, mesh_dp=1,
                                  overrides=dict(over)).cfg
        return recsys_batch(rng, cfg.kind, ROWS, cfg.seq_len, cfg.n_items,
                            n_mask=cfg.n_mask, n_negatives=cfg.n_negatives,
                            n_users=cfg.n_users)
    if arch == "gin-tu" and shape == "molecule":
        g, n, e = MOLECULE
        b = molecule_batch(rng, g, n, e, GIN_OVER["d_feat"],
                           GIN_OVER["n_classes"])
        return {"feats": b["feats"], "labels": b["labels"],
                "edge_valid": np.ones(g * e, bool),
                "graph_ids": b["graph_ids"], "edge_src": b["edge_src"],
                "edge_dst": b["edge_dst"]}
    if arch == "gin-tu":
        n, e = GRAPH
        g = random_graph(rng, n, e, GIN_OVER["d_feat"], GIN_OVER["n_classes"])
        return {"feats": g["feats"], "labels": g["labels"],
                "label_mask": rng.random(n) < 0.7,
                "edge_valid": rng.random(e) < 0.9,
                "edge_src": g["edge_src"], "edge_dst": g["edge_dst"]}
    return {"tokens": rng.integers(0, 1 << 10, (LM_ROWS, LM_SEQ + 1))
            .astype(np.int32)}


def compressed_graph(b: dict, *, pad_to: int, device=None, torch=False):
    """A node batch's compressed adjacency from its edges (``CSRGraph``
    sorts each node's neighbours; ``edge_valid`` masks the CSR slots),
    its gap blocks padded with count-0 blocks to a multiple of ``pad_to``:
    the reference's fields, or the port's with ``torch``."""
    if torch:
        from repro_torch.data.graph import compress_adjacency
        from repro_torch.data.sampler import CSRGraph
    else:
        from repro.data.graph import compress_adjacency
        from repro.data.sampler import CSRGraph
    n = b["feats"].shape[0]
    csr = CSRGraph.from_edges(b["edge_src"], b["edge_dst"], n)
    out = (compress_adjacency(csr, device=device) if torch
           else compress_adjacency(csr))
    out.pop("_bits_per_edge")
    gaps = out["gaps"]
    nb = -(-gaps.n_blocks // pad_to) * pad_to
    out["gaps"] = gaps.take_blocks(np.arange(gaps.n_blocks), pad_to=nb)
    batch = {k: v for k, v in b.items()
             if k not in ("edge_src", "edge_dst", "edge_valid")}
    batch.update(out)
    batch["edge_valid"] = b["edge_valid"]
    return batch


def run_case(case: str, out: dict) -> None:
    import functools

    import jax
    import jax.numpy as jnp

    from repro.distributed import sharding as shd
    from repro.distributed.api import activate_mesh, constrain
    from repro.models import gnn, lm, recsys, registry
    from repro.train import OptimizerConfig, init_train_state, make_train_step

    arch, shape, over, runs = CASES[case]
    fam = registry.family_of(arch)
    mod = {"lm": lm, "gnn": gnn, "recsys": recsys}[fam]
    opt = OptimizerConfig(peak_lr=PEAK_LR, warmup_steps=1, total_steps=STEPS)
    cfg = registry.build_cell(arch, shape, mesh_dp=1,
                              overrides=dict(over)).cfg
    params = mod.init_params(jax.random.PRNGKey(0), cfg)
    for k, v in flat(init_train_state(params)).items():
        out[f"{case}/init/{k}"] = v
    raw = make_batch(case)
    for k, v in raw.items():
        out[f"{case}/batch/{k}"] = np.asarray(v)
    if fam == "gnn" and cfg.compressed_adjacency:
        raw = compressed_graph(raw, pad_to=4)
    batch = jax.tree.map(jnp.asarray, raw)
    for mesh_name, zero1 in runs:
        shape_m = MESHES[mesh_name]
        mesh = jax.sharding.Mesh(
            np.asarray(jax.devices()[:np.prod(shape_m)]).reshape(shape_m),
            ("data", "model"))
        over_z = dict(over, zero1=True) if zero1 else dict(over)
        cell = registry.build_cell(arch, shape, mesh_dp=shape_m[0],
                                   overrides=over_z, opt_cfg=opt)
        hooks = {}
        if zero1:  # build_cell's hooks (the step's own are not reachable)
            master = cell.arg_specs[0]["params"]
            compute = shd.tree_specs(params, shd.recsys_param_spec(cell.cfg))

            def cast(ps, compute=compute):
                return jax.tree.map(
                    lambda p, s: constrain(p.astype(jnp.bfloat16), *tuple(s)),
                    ps, compute, is_leaf=lambda x: hasattr(x, "dtype"))

            def transform(g, master=master):
                return jax.tree.map(
                    lambda x, s: constrain(x.astype(jnp.bfloat16), *tuple(s)),
                    g, master, is_leaf=lambda x: hasattr(x, "dtype"))

            hooks = dict(compute_cast=cast, grad_transform=transform)
        step = make_train_step(
            functools.partial(mod.loss_fn, cfg=cell.cfg, dtype=jnp.float32),
            opt, microbatch=getattr(cell.cfg, "microbatch", 1), **hooks)
        specs = cell.arg_specs
        if "gaps" in raw:  # the graph's own stream (its n), as the cell's
            specs = (specs[0], dict(specs[1], gaps=shd.compressed_array_specs(
                raw["gaps"], axis=shd.ALL)))
        shardings = shd.to_named(mesh, specs)
        jitted = jax.jit(step, in_shardings=shardings)
        state = init_train_state(params)
        losses, norms = [], []
        with activate_mesh(mesh):
            for _ in range(STEPS):
                state = jax.device_put(state, shardings[0])
                state, m = jitted(state, batch)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        tag = f"{case}/{mesh_name}{'z1' if zero1 else ''}"
        out[f"{tag}/loss"] = np.asarray(losses, np.float64)
        out[f"{tag}/grad_norm"] = np.asarray(norms, np.float64)
        for k, v in flat(state["params"]).items():
            out[f"{tag}/params/{k}"] = v


def main(path: str, cases) -> None:
    import jax

    if len(jax.devices()) < N_DEVICES:
        raise SystemExit(f"needs {N_DEVICES} host devices, found "
                         f"{len(jax.devices())}")
    out: dict = {}
    for case in cases:
        run_case(case, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:] or list(CASES))
