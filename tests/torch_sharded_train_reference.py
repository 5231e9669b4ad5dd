"""The reference's sharded training, run once for the port's tests.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        PYTHONPATH=src python tests/torch_sharded_train_reference.py OUT.npz

Runs under 8 forced host devices and writes to ``OUT.npz``:

* ``psum/in``, ``psum/out``: ``compressed_psum`` inside ``shard_map``
  over a mesh of the 8 devices on one axis, each shard an ``[8, 300]``
  block of ``psum/in`` (``[64, 300]``), the answer laid out the same way;
* ``init/<path>``: the reduced h2o-danube's parameters (seed 0) at
  ``CELL_OVERRIDES``, and ``tokens``: ``STEPS`` batches;
* ``single/…`` and ``mesh/…``: ``loss``, ``grad_norm`` a step and the
  parameters after ``STEPS`` steps of ``build_cell``'s ZeRO-1 train step,
  under ``jax.jit`` alone and under ``jax.jit(step, in_shardings=
  cell.in_shardings(mesh))`` on a ``(4, 1)`` ``("data", "model")`` mesh
  of ``Auto`` axes with the mesh active; ``mesh/error`` holds the text of
  the exception the same lowering raises on ``jax.make_mesh``'s mesh (the
  reference's own, whose axes jax 0.9 makes ``Explicit``);
* ``b4r/init/<path>``, ``b4r/batch/<leaf>``: the reduced BERT4Rec's
  parameters (seed 0) and one ``B4R_ROWS``-row train batch (its
  ``negatives`` shared by every row), and ``b4r/<n>x<mb>/…``: ``loss``,
  ``grad_norm`` a step and the parameters after ``STEPS`` steps of its
  float32 train step at microbatch ``mb`` under ``jax.jit(step,
  in_shardings=...)`` on an ``(n, 1)`` mesh, with the registry's state
  and batch specs, for each ``(n, mb)`` of ``B4R_RUNS``.

``tests/test_torch_sharded_train.py`` holds the port against them.
Nothing of the reference changes.
"""
import sys

import numpy as np

N_DEVICES = 8
STEPS = 3
ROWS, SEQ = 8, 32
CELL_OVERRIDES = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      head_dim=16, d_ff=128, vocab=1 << 15, window=None,
                      q_chunk=16, kv_chunk=16, loss_chunk=8, microbatch=4)
PEAK_LR = 1e-2
B4R_ROWS = 12
B4R_RUNS = ((2, 1), (2, 2), (3, 3))


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


def psum_case(out: dict) -> None:
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.train.grad_compress import compressed_psum

    try:
        from jax import shard_map
    except ImportError:  # older jax
        from jax.experimental.shard_map import shard_map
    rng = np.random.default_rng(21)
    x = np.concatenate([rng.standard_normal((8, 300)) * s for s in
                        (1e-3, 2.0, 0.5, 7.0, 3e-2, 1.0, 40.0, 0.25)])
    x = x.astype(np.float32)
    mesh = jax.make_mesh((N_DEVICES,), ("data",))
    f = shard_map(lambda v: compressed_psum(v, "data"), mesh=mesh,
                  in_specs=P("data"), out_specs=P("data"))
    out["psum/in"] = x
    out["psum/out"] = np.asarray(jax.jit(f)(x))


def train_case(out: dict) -> None:
    import jax

    from repro.distributed.api import activate_mesh
    from repro.models import lm, registry
    from repro.train import OptimizerConfig, init_train_state

    opt = OptimizerConfig(peak_lr=PEAK_LR, warmup_steps=1, total_steps=STEPS)
    cell = registry.build_cell("h2o-danube-1.8b", "train_4k", mesh_dp=4,
                               overrides=dict(CELL_OVERRIDES, zero1=True),
                               opt_cfg=opt)
    params = lm.init_params(jax.random.PRNGKey(0), cell.cfg)
    for k, v in flat(params).items():
        out[f"init/{k}"] = v
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cell.cfg.vocab, (STEPS, ROWS, SEQ + 1))
    out["tokens"] = toks.astype(np.int32)

    def run(step, tag, shardings=None):
        state = init_train_state(lm.init_params(jax.random.PRNGKey(0),
                                                cell.cfg))
        losses, norms = [], []
        for t in out["tokens"]:
            if shardings is not None:  # the step leaves XLA's layout
                state = jax.device_put(state, shardings)
            state, m = step(state, {"tokens": jax.numpy.asarray(t)})
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
        out[f"{tag}/loss"] = np.asarray(losses, np.float64)
        out[f"{tag}/grad_norm"] = np.asarray(norms, np.float64)
        for k, v in flat(state["params"]).items():
            out[f"{tag}/params/{k}"] = v

    run(jax.jit(cell.fn), "single")
    # the reference's own meshes come from jax.make_mesh, whose axes are
    # Explicit under jax 0.9: its constrain raises there (recorded); a Mesh
    # of Auto axes runs the same step
    mesh = jax.make_mesh((4, 1), ("data", "model"),
                         devices=jax.devices()[:4])
    try:
        with activate_mesh(mesh):
            jax.jit(cell.fn, in_shardings=cell.in_shardings(mesh)).lower(
                *cell.args)
    except Exception as e:  # recorded for the tests (ROADMAP queue 3)
        out["mesh/error"] = np.asarray(f"{type(e).__name__}: {e}")
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:4]).reshape(4, 1),
                             ("data", "model"))
    shardings = cell.in_shardings(mesh)
    with activate_mesh(mesh):
        run(jax.jit(cell.fn, in_shardings=shardings), "mesh", shardings[0])


def bert4rec_case(out: dict) -> None:
    import dataclasses
    import functools

    import jax
    import jax.numpy as jnp

    from repro.data.synthetic import recsys_batch
    from repro.distributed import sharding as shd
    from repro.distributed.api import activate_mesh
    from repro.models import recsys, registry
    from repro.train import (OptimizerConfig, init_train_state,
                             make_train_step)

    cfg = registry.reduced_config("bert4rec")
    shape = dataclasses.replace(registry.shapes_of("bert4rec")["train_batch"],
                                dims={"batch": B4R_ROWS})
    opt = OptimizerConfig(peak_lr=PEAK_LR, warmup_steps=1, total_steps=STEPS)
    params = recsys.init_params(jax.random.PRNGKey(0), cfg)
    for k, v in flat(params).items():
        out[f"b4r/init/{k}"] = v
    batch = recsys_batch(np.random.default_rng(8), "bert4rec", B4R_ROWS,
                         cfg.seq_len, cfg.n_items, n_mask=cfg.n_mask,
                         n_negatives=cfg.n_negatives, n_users=cfg.n_users)
    for k, v in batch.items():
        out[f"b4r/batch/{k}"] = np.asarray(v)
    sspec = shd.state_specs(params, shd.recsys_param_spec(cfg))
    _, bspec = registry._recsys_batch(cfg, shape)
    loss = functools.partial(recsys.loss_fn, cfg=cfg, dtype=jnp.float32)
    for n, mb in B4R_RUNS:
        mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:n]).reshape(n, 1),
                                 ("data", "model"))
        shardings = shd.to_named(mesh, (sspec, bspec))
        step = jax.jit(make_train_step(loss, opt, microbatch=mb),
                       in_shardings=shardings)
        state = init_train_state(params)
        losses, norms = [], []
        with activate_mesh(mesh):
            for _ in range(STEPS):
                state = jax.device_put(state, shardings[0])
                state, m = step(state, {k: jnp.asarray(v)
                                        for k, v in batch.items()})
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
        tag = f"b4r/{n}x{mb}"
        out[f"{tag}/loss"] = np.asarray(losses, np.float64)
        out[f"{tag}/grad_norm"] = np.asarray(norms, np.float64)
        for k, v in flat(state["params"]).items():
            out[f"{tag}/params/{k}"] = v


def main(path: str) -> None:
    import jax

    if len(jax.devices()) < N_DEVICES:
        raise SystemExit(f"needs {N_DEVICES} host devices, found "
                         f"{len(jax.devices())}")
    out: dict = {}
    psum_case(out)
    train_case(out)
    bert4rec_case(out)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
