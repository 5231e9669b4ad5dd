"""``SearchEngine.run_workload`` on the port (CPU) gives the reference
engine's accounting on the same index and query mix, and the port's entry
points refuse to run without a card unless the CPU is asked for."""
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
