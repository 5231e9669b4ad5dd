"""``SearchEngine.run_workload`` on the port (CPU) gives the reference
engine's accounting on the same index and query mix, and the port's entry
points refuse to run without a card unless the CPU is asked for. Over a
mesh of 8 logical cpu shards: ``ServingEngine(mesh=...)`` against direct
scoring and its own single-device twin, the embedding-bag endpoint, and
the shard-loss drill on a mesh ``SearchEngine``."""
import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference runs on the CPU backend)

from repro.index import build_index as r_build
from repro.launch.serve import SearchEngine as RSearchEngine
from repro.launch.serve import search_queries as r_search_queries
from repro_torch.core import CompressedIntArray
from repro_torch.index import build_index as t_build
from repro_torch.launch import serve as tserve
from repro_torch.launch.serve import SearchEngine, search_queries

ACCOUNTING = ("n_queries", "n_results", "blocks_decoded", "block_skip_rate",
              "pruned_block_rate", "pruned_impact_rate", "probes_pruned",
              "rows_gathered", "ints_decoded", "impact_ints_decoded", "index")


def _lists(rng):
    from repro.data.synthetic import posting_list_group, posting_tfs

    lists = dict(enumerate(posting_list_group(rng, 8, 6, universe=1 << 16)
                           + posting_list_group(rng, 10, 4, universe=1 << 16)))
    tfs = {t: posting_tfs(rng, len(v)) for t, v in lists.items()}
    return lists, tfs


def test_run_workload_accounting_matches_reference():
    lists, tfs = _lists(np.random.default_rng(0))
    ri = r_build(lists, tfs=tfs, n_docs=1 << 16)
    ti = t_build(lists, tfs=tfs, n_docs=1 << 16, device="cpu")
    qs = r_search_queries(np.random.default_rng(1), ri, 25)
    assert qs == search_queries(np.random.default_rng(1), ti, 25)
    r_eng = RSearchEngine(ri, top_k=10, plan="jnp")
    t_eng = SearchEngine(ti, top_k=10, device="cpu")
    r_stats = r_eng.run_workload(qs)
    t_stats = t_eng.run_workload(qs)
    for key in ACCOUNTING:
        assert r_stats[key] == t_stats[key], key
    assert t_stats["device"] == "cpu" and t_stats["qps"] > 0
    for mode, terms in qs[:10]:
        a, b = r_eng.search(terms, mode), t_eng.search(terms, mode)
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(x, y, err_msg=f"{mode} {terms}")
    empty = t_eng.search([], "topk")
    assert empty[0].size == 0 and empty[1].dtype == np.int32
    with pytest.raises(ValueError, match="unknown query mode"):
        t_eng.search([0], "nope")


def test_serve_search_cli_on_cpu(capsys):
    tserve.main(["--arch", "search", "--requests", "10", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 10 queries on cpu" in out


def test_entry_points_need_a_card_unless_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    lists = {0: np.array([1, 5, 9]), 1: np.array([5, 7])}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_build(lists)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CompressedIntArray.encode(np.arange(10))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_build(lists, device="cuda")
    index = t_build(lists, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SearchEngine(index)
    assert SearchEngine(index, device="cpu").search([0, 1], "and").tolist() == [5]


# ---------------------------------------------------------------------------
# the engines over a mesh of 8 logical cpu shards
# ---------------------------------------------------------------------------
def _mesh():
    from repro_torch.distributed import make_mesh

    return make_mesh((8,), ("data",), devices=["cpu"] * 8)


@pytest.fixture(scope="module")
def two_tower():
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.models import recsys
    from repro_torch.models.registry import reduced_config

    cfg = reduced_config("two-tower-retrieval")
    params = recsys.init_params(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    cands = np.sort(rng.choice(np.arange(1, cfg.n_items), 300,
                               replace=False)).astype(np.uint64)
    corpus = CompressedIntArray.encode(cands, differential=True, device="cpu")
    sharded = ServingEngine(params, cfg, corpus, mesh=_mesh(), top_k=5)
    single = ServingEngine(params, cfg, corpus, top_k=5, device="cpu")
    return cfg, cands, sharded, single


def test_serving_engine_on_a_mesh_matches_direct_scoring(two_tower):
    from repro_torch.models import recsys

    cfg, cands, engine, single = two_tower
    assert engine.corpus.sharding is not None and engine.corpus.n_blocks == 8
    engine.warmup()
    rng = np.random.default_rng(1)
    uid = torch.tensor([7, 3], dtype=torch.int32)
    hist = torch.as_tensor(rng.integers(1, cfg.n_items, (2, cfg.seq_len))
                           .astype(np.int32))
    top_s, top_i = engine.retrieve(uid, hist)
    assert top_s.shape == (2, 5) and top_i.shape == (2, 5)
    assert np.isin(top_i.numpy(), cands).all()  # pad slots masked out
    assert (top_s[:, 1:] <= top_s[:, :-1]).all()  # descending
    s1, i1 = single.retrieve(uid, hist)  # the per-block body is the same
    assert torch.equal(top_i, i1) and torch.equal(top_s, s1)
    # direct: the same user vectors against the same item table, each
    # f32 sum of bf16 products rounded once to bf16 (the epilogue's)
    with torch.inference_mode():
        u = recsys.user_tower(engine.params, uid, hist, cfg,
                              dtype=engine.dtype)
    vecs = engine.item_table[torch.as_tensor(cands.astype(np.int64))]
    direct = (vecs.float() @ u.float().T).to(torch.bfloat16).float()
    for r in range(2):
        order = torch.argsort(-direct[:, r], stable=True)[:5]
        assert torch.equal(top_s[r].float(), direct[order, r])
    stats = engine.run_workload(
        [(1, rng.integers(1, cfg.n_items, cfg.seq_len).astype(np.int32))
         for _ in range(9)], max_batch=16)  # above the largest bucket
    assert stats["n_requests"] == 9 and stats["qps"] > 0
    assert stats["p99_ms"] >= stats["p50_ms"] > 0
    assert stats["n_devices"] == 8
    assert single.run_workload([(1, hist[0].numpy())])["n_devices"] == 1


def test_engine_embedding_bag_endpoint_on_a_mesh(two_tower):
    from repro_torch.nn.embedding_bag import bag_from_padded

    cfg, _, engine, single = two_tower
    rng = np.random.default_rng(2)
    bags = [np.sort(rng.choice(np.arange(1, cfg.n_items), size=k,
                               replace=False)) for k in (4, 1, cfg.seq_len)]
    out = engine.embed_bags(bags)
    assert out.shape == (3, cfg.id_dim)
    assert torch.equal(out, single.embed_bags(bags))
    padded = np.zeros((3, cfg.seq_len), np.int32)
    for i, ids in enumerate(bags):
        padded[i, : len(ids)] = ids
    ref = bag_from_padded(engine.params.item_id_emb, torch.as_tensor(padded),
                          mode="mean", dtype=engine.dtype)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               rtol=1e-2, atol=1e-2)


def test_serving_engine_on_a_one_shard_mesh(two_tower):
    """A 1-device mesh (``make_host_mesh``) leaves the corpus unsharded:
    the engine serves it as the single-device engine does, as the
    reference's engine does on a 1-device mesh."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.serve import ServingEngine

    cfg, cands, _, single = two_tower
    corpus = CompressedIntArray.encode(cands, differential=True, device="cpu")
    engine = ServingEngine(single.params, cfg, corpus,
                           mesh=make_host_mesh("cpu"), top_k=5)
    assert engine.corpus.sharding is None
    rng = np.random.default_rng(4)
    uid = torch.tensor([2, 9, 4], dtype=torch.int32)
    hist = torch.as_tensor(rng.integers(1, cfg.n_items, (3, cfg.seq_len))
                           .astype(np.int32))
    top_s, top_i = engine.retrieve(uid, hist)
    s1, i1 = single.retrieve(uid, hist)
    assert torch.equal(top_i, i1) and torch.equal(top_s, s1)
    assert engine.run_workload([(1, hist[0].numpy())])["n_devices"] == 1


def test_shard_loss_drill_on_a_mesh_engine():
    """The drill on a mesh engine (``validate=True``, 8 logical shards):
    the single-device drill's healthy answers and degraded count, every
    check of the drill passing on both."""
    from repro_torch.launch.serve import SimClock, shard_loss_drill

    rng = np.random.default_rng(3)
    lists, tfs = _lists(rng)
    index = t_build(lists, tfs=tfs, n_docs=1 << 16, checksum=True,
                    device="cpu")
    qs = search_queries(rng, index, 12)
    drills = []
    for mesh in (None, _mesh()):
        clock = SimClock()
        engine = SearchEngine(index, mesh=mesh, top_k=10, validate=True,
                              n_shards=8, clock=clock, device="cpu")
        assert not engine.quarantined and not engine.bound_unsafe
        lo, _ = engine.shards[3]
        drills.append(shard_loss_drill(
            engine, qs + [("or", [engine.term_order[lo]])], clock))
    single, sharded = drills
    assert sharded["degraded_responses"] == single["degraded_responses"] > 0
    assert sharded["healed_shards"] == single["healed_shards"] == 7
    for a, b in zip(sharded["healthy"], single["healthy"]):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert x.dtype == y.dtype and np.array_equal(x, y)
