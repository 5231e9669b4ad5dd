"""The reference's own sharded path, run once for the port's sharded tests.

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        PYTHONPATH=src python tests/torch_sharded_reference.py OUT.npz

Runs under 8 forced host devices, as the reference's sharded CI job does,
and writes to ``OUT.npz`` the inputs it drew and what the reference's
8-shard path answered: block-sharded decodes (``dispatch.decode`` on
``CompressedIntArray.shard``: the stream and the fused epilogues),
``SearchEngine(index, mesh=...)`` answers with their ``QueryStats`` for 3
formats, and ``ServingEngine(mesh=...)``'s sharded ``dot_score`` and its
top-k. ``tests/
test_torch_sharded_decode.py`` holds the port's 8-shard results against
them bit for bit. Nothing of the reference changes.
"""
import dataclasses
import json
import sys

import numpy as np

B = 32
U = 100_000
N_DEVICES = 8
FMTS = ("vbyte", "streamvbyte", "binpack")
SEARCH_SIZES = (45, 300, 700)
SEARCH_TERMS = ([0, 1], [0, 1, 2])
SEARCH_MODES = ("and", "or", "topk", "topk_driver", "topk_maxscore")
DECODE_N = {"n40": 40 * B + 3, "n2": 2 * B + 7, "n1": B - 1}


def stats_json(st) -> str:
    """A ``QueryStats`` as JSON: sets as sorted lists, dict keys as str."""
    def conv(v):
        if isinstance(v, (set, frozenset)):
            return sorted(int(x) for x in v)
        if isinstance(v, dict):
            return {str(k): conv(x) for k, x in v.items()}
        if isinstance(v, list):
            return [conv(x) for x in v]
        return v

    return json.dumps({f.name: conv(getattr(st, f.name))
                       for f in dataclasses.fields(st)}, sort_keys=True)


def decode_cases(out: dict, mesh) -> None:
    import jax.numpy as jnp

    from repro.core import CompressedIntArray
    from repro.kernels.vbyte_decode import dispatch

    rng = np.random.default_rng(11)
    for fmt in FMTS:
        for diff in (False, True):
            for tag, n in DECODE_N.items():
                key = f"dec/{fmt}/{int(diff)}/{tag}"
                vals = (np.sort(rng.integers(0, 2**20, n)) if diff
                        else rng.integers(0, 2**32, n)).astype(np.uint64)
                arr = CompressedIntArray.encode(vals, format=fmt,
                                                block_size=B,
                                                differential=diff)
                sh = arr.shard(mesh)
                out[key + "/vals"] = vals
                out[key + "/stream"] = np.asarray(
                    dispatch.decode(sh, plan="sharded"))
        # the fused epilogues on one differential array
        key = f"fused/{fmt}"
        vals = np.sort(rng.integers(0, 512, 10 * B + 9)).astype(np.uint64)
        table = rng.standard_normal((512, 16)).astype(np.float32)
        q4 = rng.standard_normal((4, 16)).astype(np.float32)
        arr = CompressedIntArray.encode(vals, format=fmt, block_size=B,
                                        differential=True)
        sh = arr.shard(mesh)
        eb = rng.integers(0, 512, (sh.n_blocks, B)).astype(np.int32)
        out.update({key + "/vals": vals, key + "/table": table,
                    key + "/q4": q4, key + "/edge_base": eb})
        t = jnp.asarray(table)
        cases = {"bag_sum": {"table": t},
                 "dot_score1": {"table": t, "query": jnp.asarray(q4[:1])},
                 "dot_score4": {"table": t, "query": jnp.asarray(q4)},
                 "adjacency_rebase": {"edge_base": jnp.asarray(eb)}}
        for name, eops in cases.items():
            ep = name.rstrip("14")
            res = dispatch.decode(sh, epilogue=ep, epilogue_operands=eops,
                                  plan="jnp")
            res = res if isinstance(res, tuple) else (res,)
            for i, r in enumerate(res):
                out[f"{key}/{name}/{i}"] = np.asarray(r)


def search_cases(out: dict, mesh) -> None:
    from repro.index import QueryStats, build_index
    from repro.launch.serve import SearchEngine

    rng = np.random.default_rng(0)
    for fmt in FMTS:
        lists = {t: np.sort(rng.choice(U, size=s, replace=False))
                 .astype(np.uint32) for t, s in enumerate(SEARCH_SIZES)}
        idx = build_index(lists, format=fmt, block_size=B, n_docs=U)
        engine = SearchEngine(idx, mesh=mesh, top_k=8)
        for t, v in lists.items():
            out[f"search/{fmt}/list{t}"] = v
        for terms in SEARCH_TERMS:
            for mode in SEARCH_MODES:
                key = f"search/{fmt}/{'-'.join(map(str, terms))}/{mode}"
                st = QueryStats()
                res = engine.search(terms, mode, stats=st)
                res = res if isinstance(res, tuple) else (res,)
                for i, r in enumerate(res):
                    out[f"{key}/{i}"] = np.asarray(r)
                out[key + "/stats"] = np.array(stats_json(st))
        out[f"search/{fmt}/index_stats"] = np.array(
            json.dumps(engine.index.stats(), sort_keys=True))


def serving_cases(out: dict, mesh) -> None:
    import jax
    import jax.numpy as jnp

    from repro.core import CompressedIntArray
    from repro.launch.serve import ServingEngine
    from repro.models import recsys
    from repro.models.registry import reduced_config

    from repro.kernels.vbyte_decode import dispatch

    cfg = reduced_config("two-tower-retrieval")
    params = recsys.init_params(jax.random.PRNGKey(0), cfg)
    rng = np.random.default_rng(3)
    cands = np.sort(rng.choice(np.arange(1, cfg.n_items), 300,
                               replace=False)).astype(np.uint64)
    engine = ServingEngine(params, cfg,
                           CompressedIntArray.encode(cands, differential=True),
                           mesh=mesh, top_k=5)
    out["serve/cands"] = cands
    out["serve/n_blocks"] = np.array(engine.corpus.n_blocks)
    for b in (1, 2, 4):
        uid = rng.integers(1, cfg.n_users, b).astype(np.int32)
        hist = rng.integers(1, cfg.n_items, (b, cfg.seq_len)).astype(np.int32)
        # ServingEngine.retrieve on the mesh, step by step: under jax 0.9
        # its jitted top-k raises on the block-sharded scores (a
        # ShardingTypeError at the reshape or the id gather), so the
        # engine's own _mask_and_topk runs on the gathered decode outputs
        u = engine._user_fn(params, jnp.asarray(uid), jnp.asarray(hist))
        ids, scores = dispatch.decode(
            engine.corpus, epilogue="dot_score",
            epilogue_operands={"table": engine.item_table, "query": u},
            plan=engine.plan)
        top_s, top_i = engine._topk_fn(jnp.asarray(np.asarray(ids)),
                                       jnp.asarray(np.asarray(scores)))
        out.update({f"serve/{b}/uid": uid, f"serve/{b}/hist": hist,
                    f"serve/{b}/scores": np.asarray(top_s, np.float32),
                    f"serve/{b}/ids": np.asarray(top_i)})


def main(path: str) -> None:
    import jax

    if len(jax.devices()) != N_DEVICES:
        raise SystemExit(f"needs {N_DEVICES} devices, got "
                         f"{len(jax.devices())}: set XLA_FLAGS=--xla_force_"
                         f"host_platform_device_count={N_DEVICES}")
    mesh = jax.make_mesh((N_DEVICES,), ("data",))
    out = {}
    decode_cases(out, mesh)
    search_cases(out, mesh)
    serving_cases(out, mesh)
    np.savez(path, **out)


if __name__ == "__main__":
    main(sys.argv[1])
