"""Two-tower retrieval in the port against the reference at the
reference's ``reduced_config("two-tower-retrieval")``, with the
reference's parameters carried across by
``convert.recsys_params_from_numpy``: the towers, compressed scoring, and
``ServingEngine`` (retrieval top-k with its lower-index tie-break, the
embedding-bag endpoint, the workload loop).

Tolerance: on the CPU both packages compute each bf16 matmul, sum and
norm as one rounding of a float32 result, so these come out equal; the
tests hold ids bit for bit and float outputs within one bf16 ulp (the
float32 sums may be taken in another order)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import CompressedIntArray as RArr
from repro.launch.serve import ServingEngine as RServingEngine
from repro.models import recsys as R
from repro.models import registry as Rreg
from repro_torch.convert import recsys_params_from_numpy
from repro_torch.core import CompressedIntArray as TArr
from repro_torch.launch.serve import ServingEngine, main as serve_main
from repro_torch.models import recsys as T
from repro_torch.models import registry as Treg

from torch_parity import assert_same, bf16_ulps

ARCH = "two-tower-retrieval"


@pytest.fixture(scope="module")
def model():
    cfg = Rreg.reduced_config(ARCH)
    tcfg = Treg.reduced_config(ARCH)
    params = R.init_params(jax.random.PRNGKey(0), cfg)
    tp = recsys_params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                  tcfg, device="cpu")
    return cfg, tcfg, params, tp


@pytest.fixture(scope="module")
def engines(model):
    cfg, tcfg, params, tp = model
    rng = np.random.default_rng(5)
    cands = np.sort(rng.choice(np.arange(1, cfg.n_items), 600,
                               replace=False)).astype(np.uint64)
    ref = RServingEngine(params, cfg, RArr.encode(cands, differential=True),
                         top_k=10)
    port = ServingEngine(tp, tcfg, TArr.encode(cands, differential=True,
                                               device="cpu"),
                         top_k=10, device="cpu")
    return ref, port


def _f32(x):
    return np.asarray(jnp.asarray(x, jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def _close_bf16(ref, port, msg=""):
    r, p = _f32(ref), _f32(port)
    assert r.shape == p.shape, msg
    assert bf16_ulps(torch.tensor(r), torch.tensor(p)) <= 1, msg


def _batch(cfg, b, seed):
    rng = np.random.default_rng(seed)
    uid = rng.integers(1, cfg.n_users, b).astype(np.int32)
    hist = rng.integers(0, cfg.n_items, (b, cfg.seq_len)).astype(np.int32)
    return uid, hist


def test_config_and_registry(model):
    cfg, tcfg, _, _ = model
    assert tcfg == Treg.reduced_config(ARCH)
    for f in ("name", "kind", "n_items", "n_users", "embed_dim", "id_dim",
              "seq_len", "mlp_dims", "serve_candidates"):
        assert getattr(tcfg, f) == getattr(cfg, f), f
    assert (tcfg.vocab_rows, tcfg.user_rows, tcfg.param_count(),
            tcfg.dense_flops_per_example()) == (
        cfg.vocab_rows, cfg.user_rows, cfg.param_count(),
        cfg.dense_flops_per_example())
    full = Treg.resolve_config(ARCH, "retrieval_cand")
    assert full.param_count() == Rreg.resolve_config(
        ARCH, "retrieval_cand").param_count()
    assert Treg.family_of(ARCH) == Rreg.family_of(ARCH) == "recsys"
    with pytest.raises(NotImplementedError, match="item 14"):
        Treg.family_of("sasrec")
    with pytest.raises(NotImplementedError, match="item 14"):
        T.init_params(T.RecSysConfig("s", "sasrec", 10, 8, 4), device="cpu")


@pytest.mark.parametrize("b", [1, 8])
def test_towers_match_reference(model, b):
    cfg, tcfg, params, tp = model
    uid, hist = _batch(cfg, b, b)
    _close_bf16(R.user_tower(params, jnp.asarray(uid), jnp.asarray(hist), cfg),
                T.user_tower(tp, torch.tensor(uid), torch.tensor(hist), tcfg))
    ids = np.arange(cfg.vocab_rows, dtype=np.int32)
    _close_bf16(R.item_tower(params, jnp.asarray(ids), cfg),
                T.item_tower(tp, torch.tensor(ids), tcfg))
    # the engine's item table, computed in row chunks, is the same tower
    table = T.item_table(tp, tcfg, chunk=300)
    _close_bf16(R.item_tower(params, jnp.asarray(ids), cfg), table)


@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_user_tower_compressed_matches_reference(model, fmt):
    """The bag_sum history path equals the padded one and the reference."""
    cfg, tcfg, params, tp = model
    rng = np.random.default_rng(3)
    hists = [np.sort(rng.choice(np.arange(1, cfg.n_items), int(k),
                                replace=False))
             for k in rng.integers(0, cfg.seq_len + 1, 6)]
    uid = rng.integers(1, cfg.n_users, 6).astype(np.int32)
    padded = np.zeros((6, cfg.seq_len), np.int32)
    for i, h in enumerate(hists):
        padded[i, :len(h)] = h
    block = cfg.seq_len if fmt != "streamvbyte" else 12  # a multiple of 4
    r_arr = RArr.encode_ragged(hists, format=fmt, block_size=block)
    t_arr = TArr.encode_ragged(hists, format=fmt, block_size=block,
                               device="cpu")
    ref = R.user_tower_compressed(params, jnp.asarray(uid), r_arr, cfg,
                                  plan="unfused")
    out = T.user_tower_compressed(tp, torch.tensor(uid), t_arr, tcfg)
    _close_bf16(ref, out, fmt)
    _close_bf16(T.user_tower(tp, torch.tensor(uid), torch.tensor(padded),
                             tcfg), out, "padded")


def test_retrieval_scores_compressed_matches_reference(model):
    cfg, tcfg, params, tp = model
    rng = np.random.default_rng(4)
    cands = np.sort(rng.choice(np.arange(1, cfg.n_items), 300,
                               replace=False)).astype(np.uint64)
    uid, hist = _batch(cfg, 1, 9)
    r_s, (r_ts, r_ti) = R.retrieval_scores_compressed(
        params, {"cands": RArr.encode(cands, differential=True),
                 "user_id": jnp.asarray(uid), "hist": jnp.asarray(hist)},
        cfg, top_k=20, plan="unfused")
    t_s, (t_ts, t_ti) = T.retrieval_scores_compressed(
        tp, {"cands": TArr.encode(cands, differential=True, device="cpu"),
             "user_id": torch.tensor(uid), "hist": torch.tensor(hist)},
        tcfg, top_k=20)
    _close_bf16(r_s, t_s)
    _close_bf16(r_ts, t_ts)
    assert_same(r_ti, t_ti)


def test_topk_breaks_ties_by_lower_index():
    s = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0, 1.0]])
    vals, idx = T.topk_lower_index(s, 4)
    assert idx.tolist() == [[1, 2, 4, 3]]
    r_vals, r_idx = jax.lax.top_k(jnp.asarray(s.numpy()), 4)
    assert np.asarray(r_idx).tolist() == idx.tolist()


@pytest.mark.parametrize("b", [1, 2, 5, 8])
def test_serving_engine_retrieve_matches_reference(model, engines, b):
    cfg, _, _, _ = model
    ref, port = engines
    uid, hist = _batch(cfg, b, 20 + b)
    r_s, r_i = ref.retrieve(jnp.asarray(uid), jnp.asarray(hist))
    t_s, t_i = port.retrieve(torch.tensor(uid), torch.tensor(hist))
    assert_same(r_i, t_i, f"bucket {b}")
    _close_bf16(r_s, t_s, f"bucket {b}")


def test_serving_engine_ties_and_pad_mask(model, engines):
    """Every score tied: both engines return the lowest-index candidates;
    the pad slots (id 0) never appear."""
    ref, port = engines
    ids = torch.tensor([[0, 5, 7, 3, 0, 9, 2, 11],
                        [4, 0, 8, 6, 1, 12, 0, 0]], dtype=torch.int32)
    for scores in (torch.ones(2, 8, 2), torch.ones(2, 8)):
        t_s, t_i = port._mask_and_topk(ids, scores)
        r_s, r_i = ref._mask_and_topk(jnp.asarray(ids.numpy()),
                                      jnp.asarray(scores.numpy()))
        assert_same(r_i, t_i)
        assert t_i[0].tolist() == [5, 7, 3, 9, 2, 11, 4, 8, 6, 1]
        assert (t_s == 1).all()


def test_serving_engine_embed_bags_matches_reference(model, engines):
    cfg, _, _, _ = model
    ref, port = engines
    rng = np.random.default_rng(6)
    for n_bags in (1, 3, 8, 11):
        bags = [np.sort(rng.choice(np.arange(1, cfg.n_items), int(k),
                                   replace=False))
                for k in rng.integers(0, cfg.seq_len + 1, n_bags)]
        r = ref.embed_bags(bags)
        t = port.embed_bags(bags)
        assert t.shape == (n_bags, cfg.id_dim) and t.dtype == torch.bfloat16
        _close_bf16(r, t, str(n_bags))


def test_run_workload_clamps_max_batch_and_matches(model, engines):
    """max_batch above the largest bucket is clamped to it (no bucket
    shape the engine lacks), every request is served, and the results
    equal ``retrieve`` on the same microbatches."""
    cfg, _, _, _ = model
    _, port = engines
    rng = np.random.default_rng(7)
    reqs = [(int(rng.integers(1, cfg.n_users)),
             rng.integers(1, cfg.n_items, cfg.seq_len).astype(np.int32))
            for _ in range(19)]
    rec = []
    stats = port.run_workload(reqs, max_batch=64, record=rec)
    assert stats["n_requests"] == 19 and stats["buckets"] == [1, 2, 4, 8]
    assert stats["n_devices"] == 1 and stats["device"] == "cpu"
    assert stats["stragglers"] == {} and stats["corpus_n"] == 600
    assert [len(r[1]) for r in rec] == [8, 8, 3]
    for i, (s, ids) in enumerate(rec):
        chunk = reqs[8 * i:8 * i + 8]
        b = port.bucket_of(len(chunk))
        uid = np.ones(b, np.int32)
        hist = np.ones((b, cfg.seq_len), np.int32)
        for j, (u, h) in enumerate(chunk):
            uid[j], hist[j] = u, h
        want_s, want_i = port.retrieve(torch.tensor(uid), torch.tensor(hist))
        assert torch.equal(ids, want_i[:len(chunk)])
        assert torch.equal(s, want_s[:len(chunk)])
    for k, b in ((1, 1), (3, 4), (8, 8), (9, 8)):
        assert port.bucket_of(k) == b


def test_serve_cli_on_the_cpu(capsys):
    serve_main(["--arch", "two-tower-retrieval", "--device", "cpu",
                "--requests", "5", "--candidates", "300"])
    out = capsys.readouterr().out
    assert "served 5 requests on cpu" in out and "(5, 16)" in out


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
@pytest.mark.parametrize("masked", [False, True])
def test_embedding_bag_matches_reference(mode, masked):
    """The decoded-ids path: gather + segment sum / mean / max, with
    per-sample weights (sum) and a validity mask, in float32."""
    from repro.nn.embedding_bag import embedding_bag as r_bag
    from repro_torch.nn.embedding_bag import embedding_bag as t_bag

    rng = np.random.default_rng(11)
    table = rng.standard_normal((100, 8)).astype(np.float32)
    ids = rng.integers(0, 100, 40).astype(np.int32)
    seg = np.sort(rng.integers(0, 7, 40)).astype(np.int32)  # bag 6 may be empty
    valid = rng.random(40) < 0.8 if masked else None
    weights = rng.random(40).astype(np.float32) if mode == "sum" else None
    kw = dict(mode=mode, dtype=jnp.float32)
    ref = r_bag(jnp.asarray(table), jnp.asarray(ids), jnp.asarray(seg), 8,
                weights=None if weights is None else jnp.asarray(weights),
                valid=None if valid is None else jnp.asarray(valid), **kw)
    out = t_bag(torch.tensor(table), torch.tensor(ids), torch.tensor(seg), 8,
                weights=None if weights is None else torch.tensor(weights),
                valid=None if valid is None else torch.tensor(valid),
                mode=mode, dtype=torch.float32)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_bag_from_padded_and_compressed_dict_match_reference(model, mode):
    from repro.nn.embedding_bag import bag_from_padded as r_padded
    from repro.nn.embedding_bag import embedding_bag_compressed as r_comp
    from repro_torch.nn.embedding_bag import (bag_from_padded,
                                              embedding_bag_compressed)

    cfg, _, params, tp = model
    rng = np.random.default_rng(12)
    lists = [np.sort(rng.choice(np.arange(1, cfg.n_items), int(k),
                                replace=False))
             for k in rng.integers(0, cfg.seq_len + 1, 5)]
    padded = np.zeros((5, cfg.seq_len), np.int32)
    for i, l in enumerate(lists):
        padded[i, :len(l)] = l
    emb = params["item_id_emb"]["emb"]
    _close_bf16(r_padded(emb, jnp.asarray(padded), mode=mode),
                bag_from_padded(tp.item_id_emb, torch.tensor(padded),
                                mode=mode))
    r_arr = RArr.encode_ragged(lists, block_size=cfg.seq_len,
                               differential=True)
    t_arr = TArr.encode_ragged(lists, block_size=cfg.seq_len,
                               differential=True, device="cpu")
    meta = dict(format="vbyte", block_size=cfg.seq_len, differential=True)
    _close_bf16(r_comp(emb, r_arr.device_operands(), mode=mode,
                       plan="unfused", **meta),
                embedding_bag_compressed(tp.item_id_emb,
                                         t_arr.device_operands(), mode=mode,
                                         **meta))


def test_initialisers_follow_the_reference_distribution():
    """Truncated normal at ±2σ, not rescaled (std 0.8796σ), as
    ``jax.random.truncated_normal``; dense stddev 1/√in; zero biases."""
    from repro.nn import layers as RL
    from repro_torch.nn import layers as TL

    g = torch.Generator().manual_seed(0)
    t = TL.truncated_normal_init((200_000,), 0.02, generator=g)
    r = np.asarray(RL.truncated_normal_init(jax.random.PRNGKey(0),
                                            (200_000,), 0.02))
    assert float(t.abs().max()) <= 0.04 and np.abs(r).max() <= 0.04
    assert abs(float(t.std()) - float(r.std())) < 2e-4
    assert abs(float(t.mean())) < 2e-4
    m = TL.mlp_init((16, 32, 8), generator=g)
    assert [tuple(w.shape) for w in m.w] == [(16, 32), (32, 8)]
    assert all(float(b.abs().max()) == 0 for b in m.b)
    assert float(m.w[0].abs().max()) <= 2 / 4 + 1e-6
    x = torch.randn(3, 16)
    assert torch.equal(m(x), TL.mlp(m, x))
