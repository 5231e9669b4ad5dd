"""GIN over VByte-compressed adjacency in the port against the reference
at ``reduced_config("gin-tu")`` on small seeded CSR graphs, with the
reference's parameters carried across by ``convert.gnn_params_from_numpy``:
``compress_adjacency`` bytes, both ``decode_compressed_edges`` paths (the
fused ``adjacency_rebase`` one and the legacy global one) and the decoded
edges bit for bit; ``forward`` logits and ``loss_fn`` within the stated
tolerance.

Tolerance: torch's defaults on the CPU (float32 matmuls in full float32,
``torch.backends.cuda.matmul.allow_tf32`` irrelevant here). Both packages
gather, sum the messages by owner in edge order, and round every bf16
matmul once, so on these graphs the logits come out equal; node tasks
are held within 2^-8 relative to each node's largest logit (one bf16
ulp), the graph readout bit for bit."""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data.graph import adjacency_gaps as r_gaps
from repro.data.graph import compress_adjacency as r_compress
from repro.data.sampler import CSRGraph as RCSR
from repro.data.synthetic import molecule_batch, random_graph
from repro.models import gnn as R
from repro.models import registry as Rreg
from repro.nn.gnn import decode_compressed_edges as r_decode
from repro_torch.convert import gnn_params_from_numpy
from repro_torch.data.graph import adjacency_gaps, compress_adjacency
from repro_torch.data.sampler import CSRGraph
from repro_torch.data.synthetic import random_graph as t_random_graph
from repro_torch.kernels.vbyte_decode.dispatch import DecodePlan
from repro_torch.models import gnn as T
from repro_torch.models import registry as Treg
from repro_torch.nn.gnn import decode_compressed_edges

ARCH = "gin-tu"
RTOL = 2.0**-8
PLANS = ("auto", "torch", "unfused", "cuda", DecodePlan("cuda", fused=False),
         "ref")


def _graph(seed, n, e):
    g = random_graph(np.random.default_rng(seed), n, e, 12, 3)
    return g, RCSR.from_edges(g["edge_src"], g["edge_dst"], n)


@pytest.mark.parametrize("seed,n,e", [(0, 80, 400), (1, 300, 2000),
                                      (2, 40, 37), (4, 7, 500)])
def test_compress_adjacency_bytes_match_reference(seed, n, e):
    g, rcsr = _graph(seed, n, e)
    tcsr = CSRGraph.from_edges(g["edge_src"], g["edge_dst"], n)
    np.testing.assert_array_equal(tcsr.indptr, rcsr.indptr)
    np.testing.assert_array_equal(tcsr.indices, rcsr.indices)
    np.testing.assert_array_equal(adjacency_gaps(tcsr), r_gaps(rcsr))
    r, t = r_compress(rcsr), compress_adjacency(tcsr, device="cpu")
    lv = t["gaps"].leaves_numpy()
    np.testing.assert_array_equal(lv["payload"], np.asarray(r["gaps"].payload))
    np.testing.assert_array_equal(lv["counts"], np.asarray(r["gaps"].counts))
    np.testing.assert_array_equal(
        lv["bases"], np.asarray(r["gaps"].bases).astype(np.uint32))
    np.testing.assert_array_equal(
        t["row_gap_bases"].numpy().view(np.uint32), r["row_gap_bases"])
    np.testing.assert_array_equal(t["row_offsets"].numpy(), r["row_offsets"])
    assert t["edge_valid"].all() and t["edge_valid"].numel() == rcsr.n_edges
    assert t["_bits_per_edge"] == r["_bits_per_edge"]


def test_random_graph_matches_reference():
    a = random_graph(np.random.default_rng(3), 50, 300, 4, 5)
    b = t_random_graph(np.random.default_rng(3), 50, 300, 4, 5)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("seed,n,e", [(0, 80, 400), (1, 300, 2000)])
def test_decode_compressed_edges_matches_reference_and_raw(seed, n, e, fused):
    g, rcsr = _graph(seed, n, e)
    tcsr = CSRGraph.from_edges(g["edge_src"], g["edge_dst"], n)
    r, t = r_compress(rcsr), compress_adjacency(tcsr, device="cpu")
    r_kw = {"row_gap_bases": jnp.asarray(r["row_gap_bases"])} if fused else {}
    t_kw = {"row_gap_bases": t["row_gap_bases"]} if fused else {}
    r_src, r_dst = r_decode(r["gaps"], jnp.asarray(r["row_offsets"]),
                            rcsr.n_edges, **r_kw)
    own = np.repeat(np.arange(n), np.diff(rcsr.indptr))
    for plan in PLANS:
        src, dst = decode_compressed_edges(t["gaps"], t["row_offsets"],
                                           tcsr.n_edges, plan=plan, **t_kw)
        assert src.dtype == dst.dtype == torch.int32
        np.testing.assert_array_equal(src.numpy(), np.asarray(r_src))
        np.testing.assert_array_equal(dst.numpy(), np.asarray(r_dst))
        np.testing.assert_array_equal(src.numpy(), rcsr.indices)
        np.testing.assert_array_equal(dst.numpy(), own)


def test_decode_wraps_like_uint32():
    """Neighbor ids near 2^31 and a gap running sum past 2^32: the rebase
    is mod 2^32 on both paths, as the reference's uint32 arithmetic."""
    big = 2**31 - 1
    rows = [np.array([5, big - 3, big], np.int64),
            np.array([big - 1, big], np.int64),
            np.array([], np.int64), np.array([big], np.int64)]
    indptr = np.concatenate([[0], np.cumsum([len(x) for x in rows])])
    indices = np.concatenate(rows).astype(np.int32)
    rcsr = RCSR(indptr=indptr, indices=indices)
    t = compress_adjacency(CSRGraph(indptr=indptr, indices=indices),
                           block_size=4, device="cpu")
    r = r_compress(rcsr, block_size=4)
    assert int(np.cumsum(r_gaps(rcsr), dtype=np.uint64)[-1]) > 2**32
    for fused in (True, False):
        kw = {"row_gap_bases": t["row_gap_bases"]} if fused else {}
        src, dst = decode_compressed_edges(t["gaps"], t["row_offsets"],
                                           len(indices), **kw)
        np.testing.assert_array_equal(src.numpy(), indices)
        r_src, _ = r_decode(r["gaps"], jnp.asarray(r["row_offsets"]),
                            len(indices), **({"row_gap_bases": jnp.asarray(
                                r["row_gap_bases"])} if fused else {}))
        np.testing.assert_array_equal(src.numpy(), np.asarray(r_src))


def _params(cfg, tcfg, seed):
    params = R.init_params(jax.random.PRNGKey(seed), cfg)
    return params, gnn_params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), tcfg, device="cpu")


def _assert_logits_close(ref, out, msg="", rtol=RTOL):
    ref, out = np.asarray(ref), out.numpy()
    assert ref.shape == out.shape and out.dtype == np.float32, msg
    scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-6)
    assert (np.abs(ref - out) / scale).max() <= rtol, msg


@pytest.mark.parametrize("compressed,fused", [(True, True), (True, False),
                                              (False, False)])
def test_forward_and_loss_match_reference(compressed, fused):
    n, e = 300, 2000
    g, rcsr = _graph(1, n, e)
    tcsr = CSRGraph.from_edges(g["edge_src"], g["edge_dst"], n)
    cfg = dataclasses.replace(Rreg.reduced_config(ARCH),
                              compressed_adjacency=compressed)
    tcfg = dataclasses.replace(Treg.reduced_config(ARCH),
                               compressed_adjacency=compressed)
    params, tp = _params(cfg, tcfg, 1)
    mask = np.random.default_rng(9).random(n) < 0.5
    rb = {"feats": jnp.asarray(g["feats"]), "labels": jnp.asarray(g["labels"]),
          "label_mask": jnp.asarray(mask)}
    tb = {"feats": torch.tensor(g["feats"]), "labels": torch.tensor(g["labels"]),
          "label_mask": torch.tensor(mask)}
    if compressed:
        r, t = r_compress(rcsr), compress_adjacency(tcsr, device="cpu")
        if not fused:
            r.pop("row_gap_bases"), t.pop("row_gap_bases")
        rb.update({k: v if k == "gaps" else jnp.asarray(v)
                   for k, v in r.items() if not k.startswith("_")})
        tb.update({k: v for k, v in t.items() if not k.startswith("_")})
    else:
        own = np.repeat(np.arange(n), np.diff(rcsr.indptr)).astype(np.int32)
        for bt, conv in ((rb, jnp.asarray), (tb, torch.tensor)):
            bt.update(edge_src=conv(rcsr.indices), edge_dst=conv(own),
                      edge_valid=conv(np.ones(len(own), bool)))
    _assert_logits_close(R.forward(params, rb, cfg), T.forward(tp, tb, tcfg))
    (r_loss, r_m), (t_loss, t_m) = (R.loss_fn(params, rb, cfg),
                                    T.loss_fn(tp, tb, tcfg))
    assert abs(float(r_loss) - float(t_loss)) <= RTOL * abs(float(r_loss))
    assert float(r_m["accuracy"]) == pytest.approx(float(t_m["accuracy"]))


def test_edge_valid_masks_messages():
    """Masked edges carry no message (masked in place in the port)."""
    n, e = 80, 400
    g, rcsr = _graph(0, n, e)
    cfg, tcfg = Rreg.reduced_config(ARCH), Treg.reduced_config(ARCH)
    params, tp = _params(cfg, tcfg, 2)
    valid = np.random.default_rng(1).random(e) < 0.7
    rb = {"feats": jnp.asarray(g["feats"]), "labels": jnp.asarray(g["labels"]),
          "edge_src": jnp.asarray(g["edge_src"]),
          "edge_dst": jnp.asarray(g["edge_dst"]),
          "edge_valid": jnp.asarray(valid)}
    tb = {k: torch.tensor(np.asarray(v)) for k, v in rb.items()}
    _assert_logits_close(R.forward(params, rb, cfg), T.forward(tp, tb, tcfg))


def test_graph_task_readout_matches_reference():
    """Graph classification: sum-pool readout per graph, no label mask.

    The reference's bf16 ``segment_sum`` rounds to bf16 after every add on
    the CPU, in node order; the port's ``owner_sum`` readout does the same
    adds in the same order, so the logits and the loss are equal bit for
    bit (this case was held within 2^-5 while the port summed in float32
    and rounded once)."""
    rng = np.random.default_rng(4)
    mb = molecule_batch(rng, 6, 10, 20, 12, 3)
    cfg = dataclasses.replace(Rreg.reduced_config(ARCH), task="graph")
    tcfg = dataclasses.replace(Treg.reduced_config(ARCH), task="graph")
    params, tp = _params(cfg, tcfg, 3)
    rb = {k: jnp.asarray(v) for k, v in mb.items()}
    tb = {k: torch.tensor(np.asarray(v)) for k, v in mb.items()}
    np.testing.assert_array_equal(T.forward(tp, tb, tcfg).numpy(),
                                  np.asarray(R.forward(params, rb, cfg)))
    (r_loss, _), (t_loss, _) = R.loss_fn(params, rb, cfg), T.loss_fn(tp, tb,
                                                                       tcfg)
    assert float(r_loss) == float(t_loss)


def test_configs_and_init():
    cfg, tcfg = Rreg.reduced_config(ARCH), Treg.reduced_config(ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(tcfg)
    full = Treg.resolve_config(ARCH, "ogb_products")
    assert (full.d_feat, full.n_classes, full.compressed_adjacency) == (
        100, 47, True)
    assert full.param_count() == Rreg.resolve_config(
        ARCH, "ogb_products").param_count()
    tp = T.init_params(tcfg, seed=0, device="cpu")
    assert len(tp.layers) == tcfg.n_layers
    assert tp.layers[0].mlp1.shape == (tcfg.d_feat, tcfg.d_hidden)
    assert tp.head_w.shape == (tcfg.d_hidden, tcfg.n_classes)
    w = tp.layers[1].mlp1
    assert float(w.abs().max()) <= 2.0 / np.sqrt(tcfg.d_hidden) + 1e-6
