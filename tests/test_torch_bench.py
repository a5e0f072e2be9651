"""``bench_torch.py`` and ``tools_torch/run_baseline.py`` on the CPU.

- ``production_cfg`` (with and without a ``--set`` override) equals the
  JAX package's ``bench.production_cfg`` field for field, and
  ``make_bench_world`` with the port's renderer gives the JAX bench's world
  and scans bit for bit.
- ``measured_loop``: the pre-staged and the stream protocols give the same
  trajectory bit for bit, within 1e-5 m of a ``process_scan(sync=True)``
  drive, at tiny shapes ("pallas", plain versions).
- ``main`` prints one JSON line with ``bench.py``'s keys for its mode
  (read from ``bench.py``'s source), within the ATE gate; ``--batch``
  prints the batched metric; without a card and without ``--cpu`` it
  raises. ``loop_closure_check`` returns ``bench.py``'s keys, finite.
- ``run_baseline``: ``dump_scans`` writes the bytes of ``cpp/run_baseline.py``,
  ``load_traj`` reads the binary's format back, and one build and run
  scores a finite ATE without writing into ``cpp/``.
"""

import ast
import dataclasses
import importlib.util
import json
import math
import struct
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import bench as jbench
import bench_torch
from direct_lidar_odometry_tpu import config as jconfig
from direct_lidar_odometry_tpu.cli import _parse_override as j_parse_override
from direct_lidar_odometry_tpu.io import synthetic as jsynthetic
from direct_lidar_odometry_tpu_torch.io import synthetic as tsynthetic
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
from tests.test_torch_stages import MICRO
from tools_torch import run_baseline

REPO = Path(__file__).resolve().parent.parent
CHUNK = 4
# 5 warm-up frames, the first chunk, two measured chunks and a one-frame tail
LOOP_FRAMES = bench_torch.WARMUP + 3 * CHUNK + 1
POSE_TOL = 1e-5
MICRO_SETS = [a for f in dataclasses.fields(MICRO)
              for a in ("--set", f"shapes.{f.name}={getattr(MICRO, f.name)}")]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the other drive tests (a thread pool over
    every core in two xdist workers spins them to a crawl)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bench_py_keys(function: str) -> tuple[set, set]:
    """The keys of the dict literal assigned to ``out`` in ``bench.py``'s
    ``function`` (not in the functions nested in it), and the keys it adds
    later by ``out[...] = ...``."""
    tree = ast.parse((REPO / "bench.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function)
    literal, added = set(), set()
    stack = list(fn.body)
    while stack:
        node = stack.pop()
        if isinstance(node, ast.FunctionDef):
            continue
        stack.extend(ast.iter_child_nodes(node))
        if not isinstance(node, ast.Assign):
            continue
        target = node.targets[0]
        if isinstance(target, ast.Name) and target.id == "out" and isinstance(node.value, ast.Dict):
            literal |= {k.value for k in node.value.keys}
        elif (isinstance(target, ast.Subscript) and isinstance(target.value, ast.Name)
              and target.value.id == "out"):
            added.add(target.slice.value)
    return literal, added


def _micro_cfg():
    return bench_torch.production_cfg(True).replace(shapes=MICRO)


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("overrides", [(), ("gicp.s2s.optimizer=gn",)])
def test_production_cfg_matches_bench(small, overrides):
    jcfg = jbench.production_cfg(small)
    for kv in overrides:
        key, value = j_parse_override(kv)
        jcfg = jconfig._override(jcfg, key.split("."), value)
    tcfg = bench_torch.with_overrides(bench_torch.production_cfg(small), overrides)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.gicp.s2s.optimizer == ("gn" if overrides else "lm")


@pytest.mark.parametrize("n_dynamic", [None, 0])
def test_bench_world_matches_jax(n_dynamic):
    frames = 3
    rng_j, rng_t = np.random.default_rng(0), np.random.default_rng(0)
    jw, jrange, jpts, jbeams = jbench.make_bench_world(frames, rng_j, True, n_dynamic=n_dynamic)
    tw, trange, tpts, tbeams = bench_torch.make_bench_world(frames, rng_t, True,
                                                            n_dynamic=n_dynamic)
    assert (trange, tpts) == (jrange, jpts)
    assert dataclasses.asdict(tbeams) == dataclasses.asdict(jbeams)
    np.testing.assert_array_equal(tw.poses, jw.poses)
    np.testing.assert_array_equal(tw.stamps, jw.stamps)
    for t in range(frames):
        js = jsynthetic.render_scan(jw, t, rng_j, max_range=jrange, max_points=jpts, beams=jbeams)
        ts = tsynthetic.render_scan(tw, t, rng_t, max_range=trange, max_points=tpts, beams=tbeams)
        np.testing.assert_array_equal(ts, js)


@pytest.fixture(scope="module")
def micro_world():
    rng = np.random.default_rng(0)
    world, max_range, max_pts, beams = bench_torch.make_bench_world(LOOP_FRAMES, rng, True)
    scans = [tsynthetic.render_scan(world, t, rng, max_range=max_range, max_points=max_pts,
                                    beams=beams) for t in range(LOOP_FRAMES)]
    return world, scans, [float(s) for s in world.stamps]


def test_measured_loop_protocols_agree(micro_world):
    """Both protocols (the stream one preparing chunks in the worker
    thread) drive the same frames to the same trajectory as a synced
    per-frame drive, the tail frame included."""
    world, scans, stamps = micro_world
    cfg = _micro_cfg()
    trajs = {}
    with ThreadPoolExecutor(1) as ex:
        for stream in (False, True):
            runner = OdometryRunner(cfg, device="cpu")
            start, _ = bench_torch.prime(runner, scans, stamps, CHUNK)
            assert start == bench_torch.WARMUP + CHUNK
            out = bench_torch.measured_loop(runner, scans, stamps, start, CHUNK, stream, 3, ex)
            assert out["n"] == LOOP_FRAMES - start
            assert math.isfinite(out["wall_ms"]) and out["wall_ms"] > 0
            trajs[stream] = runner.trajectory()
    ref = OdometryRunner(cfg, device="cpu")
    for scan, stamp in zip(scans, stamps):
        ref.process_scan(scan, stamp, sync=True)
    assert trajs[False].shape == (LOOP_FRAMES, 4, 4)
    np.testing.assert_array_equal(trajs[True], trajs[False])
    assert np.abs(trajs[False][:, :3, 3] - ref.trajectory()[:, :3, 3]).max() <= POSE_TOL


def _last_line(capsys) -> dict:
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def test_main_cpu_small_line(capsys):
    trajs = {}
    out = bench_torch.main(["--cpu", "--small", "--frames", str(LOOP_FRAMES - 1), "--chunk",
                            str(CHUNK), "--no-loop", *MICRO_SETS], trajectories=trajs)
    line = _last_line(capsys)
    assert line == out
    literal, added = _bench_py_keys("main")
    assert {"stream_fps", "vs_baseline_stream", "loopclosure"} == added
    # --small: one pass, no streamed pass, no loop-closure check
    assert set(line) == literal
    assert line["ate_rmse_m"] <= line["gate_m"]
    assert line["value"] > 0 and line["synced_chunk_fps"] > 0
    assert (line["protocol"], line["estimator"]) == ("prestaged", "wall_avg")
    assert line["cpu_baseline_fps_2core_measured"] == bench_torch.DLO_CPU_FPS_2CORE
    assert list(trajs) == ["pass 1"]


def test_main_cpu_batched_line(capsys):
    # the lanes carry the raw scans: n_raw holds the small world's 8192 points
    out = bench_torch.main(["--cpu", "--small", "--batch", "2", "--frames", "6", *MICRO_SETS,
                            "--set", "shapes.n_raw=8192"])
    assert _last_line(capsys) == out
    assert set(out) == {"metric", "value", "unit", "vs_baseline"}
    assert out["metric"] == "odometry_frames_per_s_per_chip_batched"
    assert out["value"] > 0


@pytest.mark.parametrize("argv", [["--small", "--no-loop"], ["--batch", "2"], ["--loop"]])
def test_main_refuses_missing_cuda(argv, monkeypatch):
    """Without ``--cpu`` the bench needs a card and never runs on the CPU
    by itself."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_torch.main(argv)


def test_loop_closure_check_keys():
    literal, added = _bench_py_keys("_loop_closure_check")
    out = bench_torch.loop_closure_check(_micro_cfg(), frames=4, per_frame_detail=True,
                                         device="cpu")
    # too few keyframes to admit a loop: no round, no "last_refine"
    assert added == {"last_refine"}
    assert set(out) == literal
    assert all(math.isfinite(v) for v in out.values())
    assert out["frames"] == 4 and out["ring_slots"] == MICRO.max_keyframes


def _jax_run_baseline():
    """The JAX package's ``cpp/run_baseline.py``, loaded by its path (it
    imports the standard library and numpy at module level)."""
    spec = importlib.util.spec_from_file_location("jax_run_baseline",
                                                  REPO / "cpp" / "run_baseline.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_dump_scans_matches_jax_script(tmp_path):
    rng = np.random.default_rng(3)
    scans = [rng.normal(size=(n, 3)).astype(np.float32) for n in (5, 0, 17)]
    stamps = np.array([0.0, 0.1, 0.2])
    run_baseline.dump_scans(str(tmp_path / "t.bin"), scans, stamps)
    _jax_run_baseline().dump_scans(str(tmp_path / "j.bin"), scans, stamps)
    assert (tmp_path / "t.bin").read_bytes() == (tmp_path / "j.bin").read_bytes()


def test_load_traj_round_trip(tmp_path):
    rng = np.random.default_rng(4)
    poses = rng.normal(size=(3, 4, 4)).astype(np.float32)
    with open(tmp_path / "traj.bin", "wb") as f:
        f.write(struct.pack("<q", len(poses)))
        for t, pose in enumerate(poses):
            f.write(struct.pack("<d", 0.1 * t))
            f.write(pose.tobytes())
    np.testing.assert_array_equal(run_baseline.load_traj(str(tmp_path / "traj.bin")), poses)


def test_baseline_builds_and_scores(capsys):
    cpp_before = sorted(p.name for p in (REPO / "cpp").iterdir())
    stats = run_baseline.main(["--small", "--frames", "4", "--threads", "2"])
    assert _last_line(capsys) == stats
    assert {"frames", "median_ms", "mean_ms", "fps", "threads", "thin", "ate_rmse_m"} == set(stats)
    assert stats["frames"] == 4 and stats["threads"] == 2
    assert math.isfinite(stats["ate_rmse_m"]) and stats["fps"] > 0
    exe, build_s = run_baseline.build()
    assert build_s == 0.0 and exe.parent == run_baseline.BUILD_DIR and exe.exists()
    assert sorted(p.name for p in (REPO / "cpp").iterdir()) == cpp_before
