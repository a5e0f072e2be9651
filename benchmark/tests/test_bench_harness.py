"""The harness on the CPU: a dry run of every cell at tiny sizes through
the harness's own loading by name, the import check, a new cell and a
new metric as new files only, the refusal without a card, and faults
planted under the timed path that the check must catch."""

import json
import shutil
import sys

import pytest
import torch

from benchmark import harness
from benchmark import run as brun
from direct_lidar_odometry_tpu_torch.odometry import pipeline
from direct_lidar_odometry_tpu_torch.odometry.state import clone_state

TINY = {
    "config": {"sensor": {"n_beams": 16, "n_azimuth": 256, "max_range": 13.0},
               "world": {"speed_m_per_frame": 0.4, "corridor_m": 7.0},
               "dlo": {"shapes": {"n_raw": 8192, "n_scan": 2048, "n_keyframe": 1024,
                                  "max_keyframes": 64, "max_submap_kf": 4, "n_submap_flat": 4096}}},
    "traffic": {"world_seeds": [1, 2], "drive_frames": 25, "chunk": 4, "judged_chunks": 3,
                "profile_chunks": 2, "profile_from_chunk": 1,
                "profile_from_step": 2, "lap_frames": 40, "warmup_frames": 6, "judged_frames": 3,
                "warmup_steps": 2, "capture_every": 2, "judged_steps": 2,
                "profile_steps": 2},
    # the tiny world's sparse scans leave the S2M minimum less sharp than
    # the cells' own: the faults below move poses by decimetres or more
    "limits": {"pose_gap_max_m": 0.03, "pose_gap_median_m": 0.03},
}
CELLS = ["os1_offline", "kitti_live", "os1_fleet8"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def dry_run(cell, seconds=2.0, trace=False, scale=TINY, bench=None):
    c = harness.load_cell(cell, bench or harness.with_candidates(), scale=scale)
    return brun.run_cell(c, 2**33 + 17, seconds, trace, device="cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_dry_run(cell):
    res = dry_run(cell)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True, res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0 and res["judged_frames"] > 0
    bench = harness.with_candidates()
    want = {m["name"] for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}
    assert set(res["metrics"]) == want
    json.dumps(res)
    assert harness.forbidden_modules() == []


def test_traced_dry_run_reports_counters():
    res = dry_run("os1_offline", trace=True)
    got = set(res["metrics"])
    assert {"host_prep_ms_per_frame.offline", "host_reads_per_frame.offline",
            "gicp_iters_per_frame.offline"} <= got
    # no device on the CPU: the trace's metrics are left out, never 0
    assert "device_idle_pct.offline" not in got


def test_forbidden_modules_compares_whole_top_level_names():
    names = ["direct_lidar_odometry_tpu_torch", "direct_lidar_odometry_tpu_torch.ops.voxel",
             "jaxtyping", "numpy", "direct_lidar_odometry_tpu.config", "jax.numpy", "jaxlib",
             "tools_torch.devprof", "flax"]
    assert harness.forbidden_modules(names) == [
        "direct_lidar_odometry_tpu.config", "flax", "jax.numpy", "jaxlib", "tools_torch.devprof"]


def test_refuses_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc = brun.main(["--workload", "os1_offline", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert rc == 2 and out.out == "" and "needs 1 NVIDIA card" in out.err


def test_new_cell_and_metric_are_new_files(tmp_path, monkeypatch):
    root = tmp_path / "repo"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    conf = harness.load_json(harness.HERE / "configs" / "dlo_os1_64.json")
    conf["world"]["speed_m_per_frame"] = 0.3
    (root / "benchmark" / "configs" / "dlo_os1_64_slow.json").write_text(json.dumps(conf))
    traffic = harness.load_json(harness.HERE / "traffic" / "offline.json")
    traffic["world_seeds"] = [3]
    (root / "benchmark" / "traffic" / "offline_one.json").write_text(json.dumps(traffic))
    (root / "benchmark" / "limits" / "slow_offline.json").write_text(
        (harness.HERE / "limits" / "os1_offline.json").read_text())
    (root / "benchmark" / "metrics" / "drive_passes_offline.py").write_text(
        "def read(log, cell):\n    return len(log.rec.spans.get('runner_init', [])) or None\n")
    bench["configs"].append({"name": "dlo_os1_64_slow", "source": "x", "reduced": [],
                             "file": "benchmark/configs/dlo_os1_64_slow.json", "why": "x"})
    bench["workloads"].append({"name": "slow_offline", "config": "dlo_os1_64_slow",
                               "traffic": "offline_one", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "drive_passes.offline", "unit": "passes", "better": "lower",
                               "source": "program_span", "layer": "feed",
                               "moves": "frames_per_s", "workloads": ["slow_offline"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "HERE", root / "benchmark")
    monkeypatch.setattr(harness, "ROOT", root)
    monkeypatch.delitem(sys.modules, "benchmark.metrics.drive_passes_offline", raising=False)
    res = dry_run("slow_offline", trace=True)
    assert res["metrics"]["drive_passes.offline"]["value"] >= 1
    assert res["correct"] is True


# -- faults under the timed path: the check must say not correct ---------------

def _unchanged(real):
    """A step that returns its state unchanged (and so the same pose)."""
    def step(cfg, directions, state, *args, **kw):
        old = clone_state(state)
        _, res = real(cfg, directions, state, *args, **kw)
        return old, res._replace(pose=old.pose.clone())
    return step


def _altered(real):
    """A pose altered where it is produced: 0.2 m off along x."""
    def step(*args, **kw):
        state, res = real(*args, **kw)
        pose = res.pose.clone()
        pose[..., 0, 3] += 0.2
        return state, res._replace(pose=pose)
    return step


def _half_batch(real):
    """Half of the lanes left out: their state and pose stay as they were."""
    def step(cfg, directions, state, *args, **kw):
        old = clone_state(state)
        new, res = real(cfg, directions, state, *args, **kw)
        half = res.pose.shape[0] // 2

        def keep(a, b):
            if a is None:
                return None
            if isinstance(a, tuple):
                return type(a)(*(keep(x, y) for x, y in zip(a, b)))
            if a.dim() == 0:
                return a
            out = a.clone()
            out[half:] = b[half:]
            return out

        return keep(new, old), res._replace(pose=keep(res.pose, old.pose))
    return step


@pytest.mark.parametrize("cell,fault", [
    ("os1_offline", "unchanged"), ("os1_offline", "altered"),
    ("kitti_live", "unchanged"), ("kitti_live", "altered"),
    ("os1_fleet8", "unchanged"), ("os1_fleet8", "altered"), ("os1_fleet8", "half_batch"),
])
def test_fault_is_not_correct(cell, fault, monkeypatch):
    name = "odom_frame_batched" if cell == "os1_fleet8" else "odom_frame"
    real = getattr(pipeline, name)
    monkeypatch.setattr(pipeline, name, {"unchanged": _unchanged, "altered": _altered,
                                         "half_batch": _half_batch}[fault](real))
    res = dry_run(cell)
    assert res["correct"] is False, res["checks"]


def test_candidates_are_apart_from_the_benchmark():
    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cand = harness.load_json(harness.HERE / "candidates.json")
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        ours = {e["name"] for e in bench[key]}
        assert not ours & {e["name"] for e in cand.get(key, [])}, key
    for w in cand["workloads"]:
        assert (harness.HERE / "limits" / f"{w['name']}.json").exists()
        assert (harness.HERE / "traffic" / f"{w['traffic']}.json").exists()
