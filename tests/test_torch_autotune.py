"""The port's measured autotune cache (``kernels/vbyte_decode/dispatch.py``)
against the reference's, on the CPU.

The reference's cache tests (``tests/test_dispatch.py``,
``tests/test_banded_decode.py``) run against the port, whose cache is its
own file (``REPRO_TORCH_AUTOTUNE_CACHE``, else
``experiments/autotune_torch.json``) keyed by the device (``cpu`` or the
card's name) in place of the JAX backend. Then: an entry keyed to a card
never picks the plan for CPU operands; card operands read no cache at
all (``auto`` is the kernels there); ``plan="auto"`` on a hit gives the
bits of the recorded plan named explicitly, and counts
``plan_cache_total`` in the call's one ``decode`` record; the synthetic
workload's operands equal the reference's ``_synthetic_workload`` bit for
bit for each format. Every test points the cache at a file of its own
and leaves ``dispatch``'s loaded cache re-read from the default path.
"""
import json

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the reference runs on the CPU backend)

from torch_parity import CPU, assert_same, np_u32

from repro.kernels.vbyte_decode import dispatch as rdispatch
from repro_torch import obs
from repro_torch.core import CompressedIntArray
from repro_torch.kernels.vbyte_decode import dispatch
from repro_torch.kernels.vbyte_decode.dispatch import DecodePlan

CARD_NAME = "NVIDIA H100 80GB HBM3"


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    """A cache file of the test's own, named by the environment as a
    user would; the loaded cache is re-read from the default path after
    the test."""
    path = tmp_path / "autotune_torch.json"
    monkeypatch.setenv("REPRO_TORCH_AUTOTUNE_CACHE", str(path))
    yield path
    monkeypatch.delenv("REPRO_TORCH_AUTOTUNE_CACHE")
    dispatch.load_cache(reload=True)


def _auto(fmt, epilogue, block_size):
    return dispatch.resolve_plan("auto", format=fmt, epilogue=epilogue,
                                 block_size=block_size, device=CPU)


def _entry(plan: dict) -> dict:
    return {"schema": dispatch.CACHE_SCHEMA, "plan": plan,
            "candidates_ms": {}}


def test_default_path_is_the_ports_own():
    assert dispatch.DEFAULT_CACHE_PATH.endswith(
        "experiments/autotune_torch.json")
    assert dispatch.DEFAULT_CACHE_PATH != rdispatch.DEFAULT_CACHE_PATH


def test_autotune_persists_and_auto_plan_reads_cache(cache_file):
    cache = dispatch.autotune(
        formats=("vbyte",), epilogue_names=("bag_sum",), block_size=32,
        n_blocks=8, vocab=256, d=8, reps=1, warmup=1,
        cache_file=str(cache_file), device="cpu")
    key = dispatch.cache_key("vbyte", "bag_sum", 32, device="cpu")
    assert key == "cpu/vbyte/bag_sum/bs32"
    assert key in cache and "plan" in cache[key]
    on_disk = json.loads(cache_file.read_text())
    entry = on_disk[key]
    assert set(entry) == {"schema", "plan", "candidates_ms", "device",
                          "workload", "measured_at"}
    assert entry["device"] == "cpu"
    # on the CPU the cuda plans are left out, and the torch decoder's
    # fused and unfused forms are one program: one candidate
    assert set(entry["candidates_ms"]) == {"torch_fused"}

    # "auto" resolves to the measured best, not the default
    dispatch.load_cache(str(cache_file), reload=True)
    assert _auto("vbyte", "bag_sum", 32) == DecodePlan(**entry["plan"])
    # unmeasured workloads fall back to the default
    assert _auto("streamvbyte", "dot_score", 32) == \
        dispatch.default_plan(CPU)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_candidates_one_program_a_label(device):
    """One candidate a distinct program: the torch decoder once (its fused
    and unfused forms run the same ops), ``ref`` for vbyte's ``stream``,
    and the kernels on the card only (one for ``stream``)."""
    dev = torch.device(device)
    got = {(fmt, ep): [c.label for c in dispatch._candidates(fmt, ep, dev)]
           for fmt in ("vbyte", "binpack") for ep in ("stream", "checksum")}
    kernels = ({"stream": ["cuda_fused"],
                "checksum": ["cuda_fused", "cuda_unfused"]}
               if device == "cuda" else {"stream": [], "checksum": []})
    assert got == {
        ("vbyte", "stream"): kernels["stream"] + ["torch_fused",
                                                  "ref_unfused"],
        ("binpack", "stream"): kernels["stream"] + ["torch_fused"],
        ("vbyte", "checksum"): kernels["checksum"] + ["torch_fused"],
        ("binpack", "checksum"): kernels["checksum"] + ["torch_fused"]}


def test_card_operands_read_no_cache(cache_file):
    """``auto`` for operands on the card is the kernels whatever the cache
    names for this card or the CPU, and counts no ``plan_cache_total``
    (the cache is not read)."""
    torch_plan = _entry({"path": "torch", "fused": True})
    cache_file.write_text(json.dumps({
        f"{CARD_NAME}/vbyte/bag_sum/bs128": torch_plan,
        "cpu/vbyte/bag_sum/bs128": torch_plan}))
    dispatch.load_cache(reload=True)
    tele = obs.Telemetry()
    with obs.install(tele):
        got = dispatch.resolve_plan("auto", format="vbyte",
                                    epilogue="bag_sum", block_size=128,
                                    device=torch.device("cuda"))
    assert got == DecodePlan("cuda", fused=True)
    assert tele.registry.snapshot()["metrics"] == {}


def test_cache_migration_drops_stale_schema_entries(cache_file):
    """An untagged entry, an old schema, junk, and an entry whose plan
    names no port path (a reference entry) are dropped on load; each
    falls back to the default."""
    key = dispatch.cache_key("vbyte", "bag_sum", 32, device="cpu")
    old_key = dispatch.cache_key("streamvbyte", "dot_score", 32,
                                 device="cpu")
    ref_key = dispatch.cache_key("binpack", "bag_sum", 32, device="cpu")
    cache_file.write_text(json.dumps({
        key: {"plan": {"path": "torch", "fused": False, "chunk": 64}},
        old_key: {"schema": 1,
                  "plan": {"path": "cuda", "fused": True, "chunk": 64}},
        ref_key: _entry({"path": "jnp", "fused": True, "chunk": None}),
        "garbage": "not-a-dict",
    }))
    cache = dispatch.load_cache(str(cache_file), reload=True)
    assert cache == {}

    for fmt, epi in (("vbyte", "bag_sum"), ("streamvbyte", "dot_score"),
                     ("binpack", "bag_sum")):
        assert _auto(fmt, epi, 32) == dispatch.default_plan(CPU)

    # current-schema entries survive the same pass untouched
    good = _entry({"path": "torch", "fused": True, "chunk": None})
    cache_file.write_text(json.dumps({key: good, old_key: {"schema": 0}}))
    assert dispatch.load_cache(str(cache_file), reload=True) == {key: good}


def test_plan_resolution_with_chunk_cache_entry(cache_file):
    cache_file.write_text(json.dumps({"cpu/vbyte/stream/bs128": _entry(
        {"path": "torch", "fused": True, "block_tile": 8, "chunk": 32})}))
    dispatch.load_cache(str(cache_file), reload=True)
    assert _auto("vbyte", "stream", 128).chunk == 32
    # a workload without an entry resolves to the default, dense
    assert _auto("vbyte", "dot_score", 128).chunk is None


def test_card_key_never_picks_a_cpu_plan(cache_file):
    """An entry measured on a card names a plan for that card only: CPU
    operands miss it, and the CPU's own entry is a hit."""
    arr = CompressedIntArray.encode(
        np.arange(0, 3000, 7, dtype=np.uint64), differential=True,
        device=CPU)
    card = _entry({"path": "ref", "fused": False})
    cache_file.write_text(json.dumps(
        {f"{CARD_NAME}/vbyte/stream/bs128": card}))
    tele = obs.Telemetry()
    with obs.install(tele):
        dispatch.decode(arr)
    assert [s["attrs"]["plan"] for s in tele.tracer.spans] == ["torch_fused"]
    m = tele.registry.snapshot()["metrics"]
    assert m["plan_cache_total{result=miss}"]["value"] == 1
    assert "plan_cache_total{result=hit}" not in m

    cache_file.write_text(json.dumps({
        f"{CARD_NAME}/vbyte/stream/bs128": card,
        "cpu/vbyte/stream/bs128": _entry({"path": "ref", "fused": False})}))
    dispatch.load_cache(reload=True)
    tele = obs.Telemetry()
    with obs.install(tele):
        dispatch.decode(arr)
    assert [s["attrs"]["plan"] for s in tele.tracer.spans] == ["ref_unfused"]
    assert "plan_cache_total{result=hit}" in tele.registry.snapshot()[
        "metrics"]


@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_auto_hit_runs_the_recorded_plan(cache_file, fmt):
    """On a hit, every epilogue's output under ``auto`` has the bits of
    the recorded plan named explicitly; each call is one ``decode``
    record counting ``decode_calls_total`` and ``plan_cache_total``."""
    ops, extras, _ = dispatch._synthetic_workload(
        fmt, n_blocks=8, block_size=32, vocab=256, d=8, seed=3, device=CPU)
    recorded = DecodePlan("torch", fused=False)
    eps = sorted(extras)
    cache_file.write_text(json.dumps({
        dispatch.cache_key(fmt, ep, 32, device="cpu"): _entry(
            {"path": "torch", "fused": False, "block_tile": 8,
             "chunk": None}) for ep in eps}))
    dispatch.load_cache(reload=True)
    tele = obs.Telemetry()
    for ep in eps:
        kw = dict(format=fmt, block_size=32, differential=True, epilogue=ep,
                  epilogue_operands=extras[ep])
        with obs.install(tele):
            got = dispatch.decode(ops, plan="auto", **kw)
        want = dispatch.decode(ops, plan=recorded, **kw)
        assert_same(want, got, f"{fmt}/{ep}")
    spans = tele.tracer.spans
    assert len(spans) == len(eps)
    assert {s["attrs"]["plan"] for s in spans} == {"torch_unfused"}
    m = tele.registry.snapshot()["metrics"]
    assert m["plan_cache_total{result=hit}"]["value"] == len(eps)
    assert sum(v["value"] for k, v in m.items()
               if k.startswith("decode_calls_total")) == len(eps)


def test_resolve_plan_counts_once_and_named_plans_not_at_all(cache_file):
    tele = obs.Telemetry()
    with obs.install(tele):
        _auto("vbyte", "stream", 128)
        dispatch.resolve_plan("torch", format="vbyte", epilogue="stream",
                              block_size=128, device=CPU)
        dispatch.resolve_plan(DecodePlan("ref", False), format="vbyte",
                              epilogue="stream", block_size=128, device=CPU)
    m = tele.registry.snapshot()["metrics"]
    assert {k: v["value"] for k, v in m.items()} == {
        "plan_cache_total{result=miss}": 1}


@pytest.mark.parametrize("fmt", ["vbyte", "streamvbyte", "binpack"])
def test_synthetic_workload_equals_reference(fmt):
    kw = dict(n_blocks=64, block_size=128, vocab=4096, d=64, seed=0)
    r_ops, r_extras, r_bits = rdispatch._synthetic_workload(fmt, **kw)
    t_ops, t_extras, t_bits = dispatch._synthetic_workload(fmt, device=CPU,
                                                           **kw)
    assert t_bits == r_bits
    assert list(t_ops) == list(r_ops)
    for k in r_ops:
        assert_same(r_ops[k], t_ops[k], k)
    assert list(t_extras) == list(r_extras)
    for ep, r_ex in r_extras.items():
        assert list(t_extras[ep]) == list(r_ex), ep
        for k, r in r_ex.items():
            t = t_extras[ep][k]
            r = np.asarray(r)
            if r.dtype == np.float32:
                assert t.dtype == torch.float32
                np.testing.assert_array_equal(t.numpy(), r, err_msg=k)
            else:
                assert tuple(t.shape) == r.shape, (ep, k)
                np.testing.assert_array_equal(np_u32(t), np_u32(r),
                                              err_msg=f"{ep}/{k}")
