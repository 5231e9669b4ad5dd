"""The reference's compute over a ``(data, model)`` mesh, run once for the
port's tests.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        PYTHONPATH=src python tests/torch_model_parallel_reference.py \
        OUT.npz [CASE ...]

Runs under 8 forced host devices, on a ``jax.sharding.Mesh`` of ``Auto``
axes over the first 4 (the reference's own ``jax.make_mesh`` mesh makes
its axes ``Explicit`` under jax 0.9, where its ``constrain`` raises:
ROADMAP queue 3 item 11), for each case of ``CASES`` (all by default) and
each mesh of ``MESHES``, and writes to ``OUT.npz``:

* ``<case>/init/<path>``: the reduced config's parameters (seed 0);
  ``<case>/tokens`` (``STEPS`` train batches ``[ROWS, SEQ + 1]``),
  ``<case>/prompt`` (``[ROWS, SEQ]``) and ``<case>/next``
  (``[DECODE, ROWS]``, the decode steps' tokens);
* ``<case>/<mesh>/train<z>/…`` for each ``(mesh, z)`` of ``TRAIN``:
  ``loss`` and ``grad_norm`` a step and the parameters after ``STEPS``
  steps of the train cell's step at float32 compute
  (``loss_fn(dtype=float32)``), ``z`` 1 with ``build_cell``'s ZeRO-1
  specs and hooks, 0 without, under ``jax.jit(step, in_shardings=...)``;
* ``<case>/<mesh>/{prefill,chunked}/…``: the logits and the cache of the
  prefill cell (``cache_capacity`` ``CAPACITY``) and of the chunked one
  (``prefill_impl="chunked"``, chunk ``CHUNK``), float32 compute, under
  ``jax.jit(fn, in_shardings=cell.in_shardings(mesh))``, and the cache's
  layout (``splits``: its split dimensions and their axes of size > 1, as
  JSON);
* ``<case>/<mesh>/decode/…``: the decode cell's logits for each of
  ``DECODE`` steps from the prefill's cache, laid out by the cell's spec
  before each step (the tokens of ``next``, fed whatever the logits say),
  and its cache and layout after them.

``tests/test_torch_model_parallel.py`` holds the port against them.
Nothing of the reference changes.
"""
import json
import sys

import numpy as np

N_DEVICES = 8
MESHES = {"2x2": (2, 2), "1x4": (1, 4)}
# the train runs (mesh, ZeRO-1): over (1, 4) ZeRO-1 splits nothing over
# the data axis, so only the (2, 2) mesh runs it (its leaves grids)
TRAIN = (("2x2", False), ("2x2", True), ("1x4", False))
STEPS = 3
ROWS, SEQ = 4, 32
CAPACITY = 48  # the prefill's cache slots: the prompt and 16 more
CHUNK = 16
DECODE = 4
PEAK_LR = 1e-2
COMMON = dict(n_layers=2, d_model=64, head_dim=16, d_ff=128, vocab=1 << 14,
              q_chunk=16, kv_chunk=16, loss_chunk=8, microbatch=2)
MOE = {"moe.n_experts": 8, "moe.top_k": 2, "moe.d_ff": 64}
# every rule bites: a dense GQA model with replicated K/V and a head-dim
# cache; olmoe-like experts over ``model`` (ep_shard), its 16 K/V heads
# split and its cache split by heads; mixtral-like (no ep_shard) with each
# expert's hidden units split, 2 K/V heads shared by the 4 positions, a
# sliding window and a head-dim cache
CASES = {
    "dense": ("h2o-danube-1.8b", dict(COMMON, n_heads=8, n_kv_heads=4,
                                      window=None)),
    "olmoe": ("olmoe-1b-7b", dict(COMMON, n_heads=16, n_kv_heads=16,
                                  head_dim=8, **MOE)),
    "mixtral": ("mixtral-8x7b", dict(COMMON, n_heads=8, n_kv_heads=2,
                                     window=16, **MOE)),
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


def splits(x, mesh) -> str:
    """The split dimensions of ``x``'s sharding and their axes of size > 1,
    as JSON."""
    out = []
    for i, entry in enumerate(tuple(x.sharding.spec)):
        names = (() if entry is None else (entry,) if isinstance(entry, str)
                 else tuple(entry))
        names = [a for a in names if mesh.shape[a] > 1]
        if names:
            out.append([i, names])
    return json.dumps(out)


def cell_inputs(case: str, out: dict):
    import jax

    from repro.models import lm, registry

    arch, over = CASES[case]
    cfg = registry.build_cell(arch, "train_4k", mesh_dp=1,
                              overrides=dict(over)).cfg
    params = lm.init_params(jax.random.PRNGKey(0), cfg)
    for k, v in flat(params).items():
        out[f"{case}/init/{k}"] = v
    rng = np.random.default_rng(11)
    out[f"{case}/tokens"] = rng.integers(
        0, cfg.vocab, (STEPS, ROWS, SEQ + 1)).astype(np.int32)
    out[f"{case}/prompt"] = rng.integers(0, cfg.vocab,
                                         (ROWS, SEQ)).astype(np.int32)
    out[f"{case}/next"] = rng.integers(0, cfg.vocab,
                                       (DECODE, ROWS)).astype(np.int32)
    return params


def train_case(case: str, tag: str, mesh, params, zero1: bool, out: dict):
    import functools

    import jax
    import jax.numpy as jnp

    from repro.distributed.api import activate_mesh, constrain
    from repro.distributed import sharding as shd
    from repro.models import lm, registry
    from repro.train import OptimizerConfig, init_train_state, make_train_step

    arch, over = CASES[case]
    n = mesh.shape["data"]
    opt = OptimizerConfig(peak_lr=PEAK_LR, warmup_steps=1, total_steps=STEPS)
    cell = registry.build_cell(arch, "train_4k", mesh_dp=n,
                               overrides=dict(over, zero1=zero1), opt_cfg=opt)
    cfg = cell.cfg
    hooks = {}
    if zero1:  # build_cell's hooks (the step's own are not reachable)
        master = cell.arg_specs[0]["params"]
        compute = shd.tree_specs(params, shd.lm_param_spec(cfg))

        def cast(ps):
            return jax.tree.map(
                lambda p, s: constrain(p.astype(jnp.bfloat16), *tuple(s)),
                ps, compute, is_leaf=lambda x: hasattr(x, "dtype"))

        def transform(g):
            return jax.tree.map(
                lambda x, s: constrain(x.astype(jnp.bfloat16), *tuple(s)),
                g, master, is_leaf=lambda x: hasattr(x, "dtype"))

        hooks = dict(compute_cast=cast, grad_transform=transform)
    step = make_train_step(
        functools.partial(lm.loss_fn, cfg=cfg, dtype=jnp.float32), opt,
        microbatch=cfg.microbatch, **hooks)
    shardings = cell.in_shardings(mesh)
    jitted = jax.jit(step, in_shardings=shardings)
    state = init_train_state(params)
    losses, norms = [], []
    with activate_mesh(mesh):
        for t in out[f"{case}/tokens"]:
            state = jax.device_put(state, shardings[0])
            state, m = jitted(state, {"tokens": jnp.asarray(t)})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[f"{tag}/loss"] = np.asarray(losses, np.float64)
    out[f"{tag}/grad_norm"] = np.asarray(norms, np.float64)
    for k, v in flat(state["params"]).items():
        out[f"{tag}/params/{k}"] = v


def serve_case(case: str, tag: str, mesh, params, out: dict):
    import functools

    import jax
    import jax.numpy as jnp

    from repro.distributed.api import activate_mesh
    from repro.models import lm, registry

    arch, over = CASES[case]
    n = mesh.shape["data"]
    f32 = jnp.float32
    prefill = registry.build_cell(arch, "prefill_32k", mesh_dp=n,
                                  overrides=dict(over))
    cfg = prefill.cfg
    decode = registry.build_cell(arch, "decode_32k", mesh_dp=n,
                                 overrides=dict(over))
    prompt = jnp.asarray(out[f"{case}/prompt"])
    fns = {"prefill": functools.partial(lm.prefill, cfg=cfg,
                                        cache_capacity=CAPACITY, dtype=f32),
           "chunked": functools.partial(lm.prefill_chunked, cfg=cfg,
                                        chunk=CHUNK, dtype=f32)}
    with activate_mesh(mesh):
        for name, fn in fns.items():
            lg, cache = jax.jit(fn, in_shardings=prefill.in_shardings(mesh))(
                params, prompt)
            out[f"{tag}/{name}/logits"] = np.asarray(lg)
            for k in ("k", "v"):
                out[f"{tag}/{name}/{k}"] = np.asarray(cache[k])
            out[f"{tag}/{name}/splits"] = np.asarray(splits(cache["k"], mesh))
            if name == "prefill":
                first = cache
        shardings = decode.in_shardings(mesh)
        step = jax.jit(functools.partial(lm.decode_step, cfg=cfg, dtype=f32),
                       in_shardings=shardings)
        cache = first
        for i, t in enumerate(out[f"{case}/next"]):
            # the cache laid out by the cell's spec (the prefill leaves it
            # split along the sequence)
            cache = jax.device_put(cache, shardings[1])
            lg, cache = step(params, cache, jnp.asarray(t))
            out[f"{tag}/decode/logits/{i}"] = np.asarray(lg)
        for k in ("k", "v"):
            out[f"{tag}/decode/{k}"] = np.asarray(cache[k])
        out[f"{tag}/decode/splits"] = np.asarray(splits(cache["k"], mesh))


def main(path: str, cases) -> None:
    import jax

    if len(jax.devices()) < N_DEVICES:
        raise SystemExit(f"needs {N_DEVICES} host devices, found "
                         f"{len(jax.devices())}")
    out: dict = {}
    for case in cases:
        params = cell_inputs(case, out)
        for name, shape in MESHES.items():
            mesh = jax.sharding.Mesh(
                np.asarray(jax.devices()[:4]).reshape(shape),
                ("data", "model"))
            tag = f"{case}/{name}"
            for zero1 in (z for m, z in TRAIN if m == name):
                train_case(case, f"{tag}/train{int(zero1)}", mesh, params,
                           zero1, out)
            serve_case(case, tag, mesh, params, out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:] or list(CASES))
