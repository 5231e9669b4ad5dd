"""The port's ``ft`` (elastic re-meshing, heartbeats) and
``robustness.atomic_io`` against the reference's copies: the same plans,
intervals and classifications, and byte-identical files."""
import json
import os

import numpy as np
import pytest

from repro.ft import StragglerDetector as RDetector
from repro.ft import plan_mesh as r_plan_mesh
from repro.ft import reshard_plan as r_reshard_plan
from repro.ft import shard_intervals as r_shard_intervals
from repro.robustness import atomic_io as r_io
from repro_torch import ft as tft
from repro_torch import robustness as trob
from repro_torch.robustness import atomic_io as t_io


@pytest.mark.parametrize("n_chips", [16, 17, 48, 256, 257, 512, 1000, 4096])
@pytest.mark.parametrize("mp", [4, 16])
def test_plan_mesh_matches_reference(n_chips, mp):
    r, t = (r_plan_mesh(n_chips, model_parallel=mp),
            tft.plan_mesh(n_chips, model_parallel=mp))
    assert (r.shape, r.axis_names, r.n_chips) == \
        (t.shape, t.axis_names, t.n_chips)


def test_plan_mesh_too_few_chips_raises():
    with pytest.raises(ValueError, match="at least 16"):
        tft.plan_mesh(8)


@pytest.mark.parametrize("dim,parts", [(48, 8), (48, 7), (10, 3), (7, 7),
                                       (5, 8), (1000, 13)])
def test_shard_intervals_match_reference(dim, parts):
    t = tft.shard_intervals(dim, parts)
    assert t == r_shard_intervals(dim, parts)
    covered = np.zeros(dim, int)
    for lo, hi in t:
        covered[lo:hi] += 1
    assert (covered == 1).all()


@pytest.mark.parametrize("dim,old,new", [(48, 8, 7), (48, 7, 5), (100, 3, 8),
                                         (17, 5, 2), (9, 9, 1)])
def test_reshard_plan_matches_reference(dim, old, new):
    plan = tft.reshard_plan(dim, old, new)
    assert plan == r_reshard_plan(dim, old, new)
    data = np.arange(dim)
    olds = [data[lo:hi] for lo, hi in tft.shard_intervals(dim, old)]
    rebuilt = np.concatenate([olds[s][a:b] for srcs in plan
                              for s, a, b in srcs])
    np.testing.assert_array_equal(rebuilt, data)


def test_straggler_detector_matches_reference():
    rng = np.random.default_rng(0)
    r, t = RDetector(), tft.StragglerDetector()
    now = 0.0
    for step in range(30):
        for h in range(6):
            if h == 4 and step > 20:
                continue  # host 4 goes silent
            dt = 0.5 if h == 2 else 0.1  # host 2 is slow
            now += dt * rng.random()
            r.heartbeat(f"h{h}", step, now)
            t.heartbeat(f"h{h}", step, now)
    assert r.median_step_time() == t.median_step_time()
    assert r.stragglers(now + 1.0) == t.stragglers(now + 1.0)


def _writes(io, root):
    io.atomic_write_bytes(os.path.join(root, "a.bin"), b"\x00\x01payload")
    io.atomic_write_json(os.path.join(root, "m.json"),
                         {"segments": [1, 2], "n": 3})

    def fill(d):
        with open(os.path.join(d, "x.npy"), "wb") as f:
            np.save(f, np.arange(7))

    io.atomic_write_dir(os.path.join(root, "seg"), fill)
    io.atomic_write_dir(os.path.join(root, "seg"), fill)  # replaces
    return {name: open(os.path.join(root, name), "rb").read()
            for name in ("a.bin", "m.json", "seg/x.npy")}


def test_atomic_writes_match_reference(tmp_path):
    (tmp_path / "r").mkdir()
    (tmp_path / "t").mkdir()
    r = _writes(r_io, str(tmp_path / "r"))
    t = _writes(t_io, str(tmp_path / "t"))
    assert r == t
    assert json.loads(t["m.json"]) == {"segments": [1, 2], "n": 3}
    for name in ("a.bin", "m.json", "seg/x.npy"):
        assert (t_io.crc32_file(str(tmp_path / "t" / name))
                == r_io.crc32_file(str(tmp_path / "r" / name)))
    assert sorted(os.listdir(tmp_path / "t")) == ["a.bin", "m.json", "seg"]


def test_clean_tmp_removes_orphans_only(tmp_path):
    for d in ("r", "t"):
        root = tmp_path / d
        root.mkdir()
        (root / f"{t_io.TMP_PREFIX}orphan_1").write_bytes(b"x")
        (root / f"{t_io.TMP_PREFIX}dir_2").mkdir()
        (root / "keep.bin").write_bytes(b"y")
    assert t_io.TMP_PREFIX == r_io.TMP_PREFIX
    assert (t_io.clean_tmp(str(tmp_path / "t"))
            == r_io.clean_tmp(str(tmp_path / "r")) == 2)
    assert os.listdir(tmp_path / "t") == ["keep.bin"]
    assert t_io.clean_tmp(str(tmp_path / "missing")) == 0


def test_failed_fill_leaves_no_final_name(tmp_path):
    def fill(d):
        with open(os.path.join(d, "part"), "wb") as f:
            f.write(b"half")
        raise RuntimeError("crash mid-write")

    with pytest.raises(RuntimeError, match="crash"):
        t_io.atomic_write_dir(str(tmp_path / "seg"), fill)
    assert os.listdir(tmp_path) == []


def test_robustness_exports_every_reference_name():
    import repro.robustness as rrob

    names = [n for n in dir(rrob) if not n.startswith("_")
             and n not in ("atomic_io", "validate", "faultgen")]
    assert names and all(hasattr(trob, n) for n in names), \
        [n for n in names if not hasattr(trob, n)]
    for n in ("MeshPlan", "plan_mesh", "shard_intervals", "reshard_plan",
              "StragglerDetector"):
        assert hasattr(tft, n)
