"""The reference's recsys serving cells over ``(data, model)`` meshes, run
once for the port's tests.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        PYTHONPATH=src python tests/torch_recsys_model_parallel_reference.py \
        OUT.npz [CASE ...]

Runs under 8 forced host devices, on ``jax.sharding.Mesh`` meshes of
``Auto`` axes over the first 4 (ROADMAP queue 3 item 11), for each case
of ``CASES`` (all by default), and writes to ``OUT.npz``:

* ``<case>/init/<path>``: the reduced config's parameters (seed 0);
* ``<case>/<shape>/batch/<leaf>``: the request (``retrieval_cand``: the
  sorted candidate ids, which both packages encode alike);
* ``<case>/serve_p99/<mesh>/scores``: the scores of ``serve_scores`` at
  float32 compute under ``jax.jit(fn, in_shardings=cell.in_shardings(
  mesh))``;
* ``<case>/retrieval_cand/<mesh>/{scores,top_s,top_ids}``:
  ``retrieval_scores_compressed`` at float32 compute under
  ``jax.jit(fn, in_shardings=...)`` over the mesh, with the cell's specs
  for the parameters and the request's own stream (its blocks padded
  with count-0 blocks to a multiple of 4, as the cell's are padded to a
  multiple of 512) split over ``("pod", "data", "model")``.

``tests/test_torch_recsys_model_parallel.py`` holds the port against them
(its subprocesses add ``XLA_FAST_COMPILE`` of
``tests/torch_data_parallel_reference.py`` to ``XLA_FLAGS``).
Nothing of the reference changes.
"""
import sys

import numpy as np

N_DEVICES = 8
MESHES = {"1x4": (1, 4), "2x2": (2, 2)}
SERVE_ROWS = 8
# tables of at least 2^16 rows split over ``model``; the retrieval configs
# hold 4,093 candidate blocks of distinct ids (BST's ranker: 61)
SERVE_OVER = dict(n_items=1 << 16, n_users=1 << 16, embed_dim=16, id_dim=16,
                  seq_len=12, n_blocks=1, mlp_dims=(32, 16), n_negatives=16,
                  serve_candidates=32)
RETRIEVAL_ITEMS = 600_000
CASES = {
    "sasrec": ("sasrec", dict(SERVE_OVER, n_heads=1), 4093),
    "bert4rec": ("bert4rec", dict(SERVE_OVER, n_heads=2, n_mask=3), 4093),
    "bst": ("bst", dict(SERVE_OVER, n_heads=2), 61),
    "two_tower": ("two-tower-retrieval", dict(SERVE_OVER), 4093),
    "sasrec_col": ("sasrec", dict(SERVE_OVER, n_heads=1,
                                  serve_table_mode="column"), 0),
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


def requests(case: str, cfg, n_blocks: int) -> dict:
    """``serve_p99``'s request at ``SERVE_ROWS`` rows, and
    ``retrieval_cand``'s (the candidate ids sorted, ``n_blocks`` blocks of
    128 but the last, which holds 78): the draws of the port's
    ``registry.recsys_batch_for``."""
    rng = np.random.default_rng(sum(map(ord, case)))
    B, L, C = SERVE_ROWS, cfg.seq_len, cfg.serve_candidates
    if cfg.kind == "bst":
        serve = {"hist": rng.integers(1, cfg.n_items, (B, L)),
                 "target": rng.integers(1, cfg.n_items, B)}
    elif cfg.kind == "two_tower":
        serve = {"user_id": rng.integers(1, 100, B),
                 "hist": rng.integers(1, cfg.n_items, (B, L)),
                 "cands": rng.integers(1, cfg.n_items, C)}
    else:
        serve = {"hist": rng.integers(1, cfg.n_items, (B, L)),
                 "cands": rng.integers(1, cfg.n_items, (B, C))}
    out = {"serve_p99": {k: v.astype(np.int32) for k, v in serve.items()}}
    if n_blocks:
        n = n_blocks * 128 - 50
        ret = {"hist": rng.integers(1, RETRIEVAL_ITEMS, (1, L)),
               "ids": np.sort(rng.choice(np.arange(
                   1, RETRIEVAL_ITEMS, dtype=np.int64), n, replace=False))}
        if cfg.kind == "two_tower":
            ret["user_id"] = rng.integers(1, 100, 1)
        out["retrieval_cand"] = {k: v.astype(np.int32) if k != "ids" else v
                                 for k, v in ret.items()}
    return out


def run_case(case: str, out: dict) -> None:
    import functools

    import jax
    import jax.numpy as jnp

    from repro.core.compressed_array import CompressedIntArray
    from repro.distributed import sharding as shd
    from repro.distributed.api import activate_mesh
    from repro.models import recsys, registry

    arch, over, n_blocks = CASES[case]
    f32 = jnp.float32
    cfg = registry.build_cell(arch, "serve_p99", mesh_dp=1,
                              overrides=dict(over)).cfg
    params = recsys.init_params(jax.random.PRNGKey(0), cfg)
    for k, v in flat(params).items():
        out[f"{case}/init/{k}"] = v
    reqs = requests(case, cfg, n_blocks)
    for shape, req in reqs.items():
        for k, v in req.items():
            out[f"{case}/{shape}/batch/{k}"] = v
    batch = {k: jnp.asarray(v) for k, v in reqs["serve_p99"].items()}
    fn = functools.partial(recsys.serve_scores, cfg=cfg, dtype=f32)
    for name, shape in MESHES.items():
        mesh = jax.sharding.Mesh(
            np.asarray(jax.devices()[:4]).reshape(shape), ("data", "model"))
        cell = registry.build_cell(arch, "serve_p99", mesh_dp=shape[0],
                                   overrides=dict(over))
        with activate_mesh(mesh):
            scores = jax.jit(fn, in_shardings=cell.in_shardings(mesh))(
                params, batch)
        out[f"{case}/serve_p99/{name}/scores"] = np.asarray(scores)
    if not n_blocks:
        return
    # the retrieval configs' tables hold every candidate id
    rcfg = registry.build_cell(arch, "retrieval_cand", mesh_dp=1, overrides=dict(
        over, n_items=RETRIEVAL_ITEMS)).cfg
    rparams = recsys.init_params(jax.random.PRNGKey(0), rcfg)
    for k, v in flat(rparams).items():
        out[f"{case}/retrieval_init/{k}"] = v
    req = reqs["retrieval_cand"]
    cands = CompressedIntArray.encode(req["ids"].astype(np.uint64),
                                      differential=True, stride_multiple=256)
    rbatch = {k: jnp.asarray(v) for k, v in req.items() if k != "ids"}
    rbatch["cands"] = cands
    rfn = functools.partial(recsys.retrieval_scores_compressed, cfg=rcfg,
                            dtype=f32)
    for name, shape in MESHES.items():
        mesh = jax.sharding.Mesh(
            np.asarray(jax.devices()[:4]).reshape(shape), ("data", "model"))
        cell = registry.build_cell(arch, "retrieval_cand", mesh_dp=shape[0],
                                   overrides=dict(over,
                                                  n_items=RETRIEVAL_ITEMS))
        # the request's own stream (its n), its blocks padded with count-0
        # ones to a multiple of the positions, as the cell's are
        padded = cands.take_blocks(np.arange(cands.n_blocks),
                                   pad_to=-(-cands.n_blocks // 4) * 4)
        specs = (cell.arg_specs[0], dict(
            cell.arg_specs[1], cands=shd.compressed_array_specs(
                padded, axis=shd.ALL)))
        with activate_mesh(mesh):
            scores, (top_s, top_ids) = jax.jit(
                rfn, in_shardings=shd.to_named(mesh, specs))(
                rparams, dict(rbatch, cands=padded))
        tag = f"{case}/retrieval_cand/{name}"
        out[f"{tag}/scores"] = np.asarray(scores)
        out[f"{tag}/top_s"] = np.asarray(top_s)
        out[f"{tag}/top_ids"] = np.asarray(top_ids)


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
