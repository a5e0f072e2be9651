"""The port's CLI and what it writes, against the JAX package: the CLI run
in-process on the CPU (synthetic and KITTI-layout input), its trajectory,
PLY and checkpoint files read back by the JAX readers, JAX-written files
read by the port, the keyframe map against the JAX ``build_map``, and the
numpy copies (synthetic worlds, KITTI/trajectory/PLY io, dashboard)
identical to their originals.
"""

import dataclasses
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.io import kitti as jkitti, ply as jply
from direct_lidar_odometry_tpu.io import synthetic as jsyn, trajectory as jtraj
from direct_lidar_odometry_tpu.odometry import mapper as jmapper, state as jstate
from direct_lidar_odometry_tpu.utils import checkpoint as jckpt, profiling as jprof
from direct_lidar_odometry_tpu_torch import cli, config as tcfg
from direct_lidar_odometry_tpu_torch.io import kitti as tkitti, ply as tply
from direct_lidar_odometry_tpu_torch.io import synthetic as tsyn, trajectory as ttraj
from direct_lidar_odometry_tpu_torch.odometry import mapper as tmapper, state as tstate
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
from direct_lidar_odometry_tpu_torch.utils import checkpoint as tckpt, profiling as tprof
from tests.test_pallas_e2e import _scans, pallas_cfg, sparse_world  # noqa: F401

SHAPES = [
    "--set", "shapes.n_raw=8192", "--set", "shapes.n_scan=2048",
    "--set", "shapes.n_keyframe=1024", "--set", "shapes.max_keyframes=16",
    "--set", "shapes.max_submap_kf=4", "--set", "shapes.n_submap_flat=4096",
    "--set", "shapes.hull_directions=16",
]
SMALL = SHAPES + ["--set", "posegraph.use=false"]
REPO = Path(__file__).resolve().parent.parent


def _run_cli(argv, capsys):
    assert cli.main(argv) == 0
    out = capsys.readouterr()
    return json.loads(out.out.strip().splitlines()[-1]), out.err


def test_cli_synthetic_fused_in_process(tmp_path, capsys):
    """--device cpu --set nn_backend=pallas_fused at small shapes, with the
    checks of tests/test_cli.py:50-59; every file the CLI wrote is read
    back by the JAX package's readers, and --resume restarts from the
    checkpoint."""
    summary, _ = _run_cli(
        ["--synthetic", "6", "--device", "cpu", "--set", "nn_backend=pallas_fused",
         "--out-dir", str(tmp_path), "--eval", "--map-ply", "map.ply",
         "--checkpoint", "ckpt.npz", "--dashboard-every", "3"] + SMALL, capsys)
    assert summary["frames"] == 6
    assert summary["ate_rmse_m"] < 0.5
    est = jtraj.read_kitti(str(tmp_path / "trajectory_kitti.txt"))
    assert est.shape == (6, 4, 4)
    tum = np.loadtxt(tmp_path / "trajectory_tum.txt")
    assert tum.shape == (6, 8)
    np.testing.assert_allclose(tum[:, 1:4], est[:, :3, 3], atol=1e-5)
    m = jply.read_ply(str(tmp_path / "map.ply"))
    assert len(m) > 100
    cfg = tcfg.load_config(overrides={
        "nn_backend": "pallas_fused", "posegraph.use": False,
        **{kv.split("=")[0]: int(kv.split("=")[1]) for kv in SMALL[1::2] if "shapes" in kv}})
    jcfg = _jax_cfg(cfg)
    state, extra = jckpt.load_state(str(tmp_path / "ckpt.npz"), jcfg)
    assert int(state.frame_idx) == 6 and extra["prev_stamp"] == pytest.approx(0.5)
    np.testing.assert_allclose(np.asarray(state.pose)[:3], est[-1][:3], atol=1e-6)

    summary, err = _run_cli(
        ["--synthetic", "2", "--device", "cpu", "--set", "nn_backend=pallas_fused",
         "--out-dir", str(tmp_path / "resumed"), "--quiet",
         "--resume", str(tmp_path / "ckpt.npz")] + SMALL, capsys)
    assert "resumed from" in err and summary["frames"] == 2


def test_cli_kitti_path_in_process(tmp_path, capsys):
    """--kitti on a sequence written by the port's dump_kitti, read with the
    numpy reader: the ATE bound of tests/test_cli.py's KITTI drive."""
    world = tsyn.make_loop_world(np.random.default_rng(2), n_frames=80, speed=0.4)
    root = tsyn.dump_kitti(tsyn.SyntheticWorld(world.surface_points, world.poses[:8],
                                               world.stamps[:8]),
                           str(tmp_path / "kitti"), "07", rng=np.random.default_rng(5),
                           max_range=13.0, max_points=8192)
    summary, _ = _run_cli(["--kitti", root, "--sequence", "07", "--frames", "6", "--quiet",
                           "--eval", "--device", "cpu", "--out-dir", str(tmp_path)] + SMALL,
                          capsys)
    assert summary["frames"] == 6
    assert summary["ate_rmse_m"] < 0.15, summary


def test_cli_shipped_config_with_loop_closure(tmp_path, capsys):
    """cfg/tpu_dlo.yaml as shipped (posegraph on) at small shapes: the run
    exits 0 and the summary carries the loop-closure counts. check_every=3
    makes the runner ask for a round (none is due: too few keyframes)."""
    summary, _ = _run_cli(
        ["--synthetic", "6", "--config", str(REPO / "cfg" / "tpu_dlo.yaml"), "--device", "cpu",
         "--quiet", "--eval", "--out-dir", str(tmp_path), "--set", "posegraph.check_every=3"]
        + SHAPES, capsys)
    assert summary["frames"] == 6
    assert summary["refine_rounds"] == 0 and summary["loop_edges_accepted"] == 0
    assert summary["ate_rmse_m"] < 0.5


def test_cli_device_cuda_without_card_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --device cuda runs")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--synthetic", "2", "--out-dir", str(tmp_path)] + SMALL)


# ------------------------------------------------------------ port state run

def _jax_cfg(port_cfg):
    from direct_lidar_odometry_tpu.config import DloConfig, _build

    return _build(DloConfig, dataclasses.asdict(port_cfg))


@pytest.fixture(scope="module")
def port_run(sparse_world):  # noqa: F811
    """The port's runner after 4 frames of the test_pallas_e2e world (CPU)."""
    cfg = tcfg.config_from_dict(dataclasses.asdict(pallas_cfg()))
    scans = _scans(sparse_world, 5)
    runner = OdometryRunner(cfg, device="cpu")
    results = [runner.process_scan(s, float(sparse_world.stamps[t]), sync=True)
               for t, s in enumerate(scans[:4])]
    return cfg, runner, results[-1], scans


def test_checkpoint_readable_by_reference_and_back(port_run, tmp_path):
    """Port-written files load in the JAX package with equal leaves;
    JAX-written files load in the port with equal leaves."""
    cfg, runner, _, _ = port_run
    leaves = tstate.state_to_numpy(runner.state)
    tckpt.save_state(str(tmp_path / "port.npz"), runner.state, extra={"prev_stamp": 0.3})
    jstate_, extra = jckpt.load_state(str(tmp_path / "port.npz"), _jax_cfg(cfg))
    assert extra == {"prev_stamp": 0.3}
    for key, value in leaves.items():
        got = getattr(jstate_.keyframes, key[10:]) if key.startswith("keyframes.") \
            else getattr(jstate_, key)
        np.testing.assert_array_equal(np.asarray(got), value, err_msg=key)

    jkf = jstate.KeyframeStore(**{f: jnp.asarray(leaves[f"keyframes.{f}"])
                                  for f in jstate.KeyframeStore._fields})
    jst = jstate.OdomState(keyframes=jkf, submap_grid=None, **{
        f: jnp.asarray(leaves[f]) for f in jstate.OdomState._fields
        if f not in ("keyframes", "submap_grid")})
    jckpt.save_state(str(tmp_path / "jax.npz"), jst, extra={"prev_stamp": 0.3})
    back, extra = tckpt.load_state(str(tmp_path / "jax.npz"), cfg, device="cpu")
    assert extra == {"prev_stamp": 0.3}
    for key, value in tstate.state_to_numpy(back).items():
        np.testing.assert_array_equal(value, leaves[key], err_msg=key)


def test_checkpoint_resume_continues_identically(port_run, tmp_path):
    """A runner resumed from a checkpoint steps the next frame exactly as
    the runner that wrote it (the JAX package's resume contract)."""
    cfg, runner, _, scans = port_run
    tckpt.save_state(str(tmp_path / "s.npz"), runner.state,
                     extra={"prev_stamp": runner.prev_stamp})
    resumed = OdometryRunner(cfg, device="cpu")
    resumed.state, extra = tckpt.load_state(str(tmp_path / "s.npz"), cfg, device="cpu")
    resumed.prev_stamp = extra["prev_stamp"]
    a = runner.process_scan(scans[4], 0.4, sync=True)
    b = resumed.process_scan(scans[4], 0.4, sync=True)
    np.testing.assert_allclose(b.pose.numpy(), a.pose.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="shape"):
        tckpt.load_state(str(tmp_path / "s.npz"), cfg.replace(
            shapes=dataclasses.replace(cfg.shapes, n_scan=4096)), device="cpu")


def test_build_map_matches_reference_as_sets(port_run):
    """The keyframe map against the JAX build_map on the same keyframe ring:
    the same voxels, centroids within summation-order rounding."""
    cfg, runner, _, _ = port_run
    kf = runner.state.keyframes
    jkf = jstate.KeyframeStore(**{f: jnp.asarray(getattr(kf, f).numpy())
                                  for f in jstate.KeyframeStore._fields})
    ref = jmapper.build_map(jkf, cfg.map.leaf_size, 8192)
    out = tmapper.build_map(kf, cfg.map.leaf_size, 8192)
    pj = np.asarray(ref.points)[np.asarray(ref.mask)]
    pt = out.points[out.mask].numpy()
    assert len(pt) == len(pj) > 100
    np.testing.assert_allclose(pt[np.lexsort(pt.T[::-1])], pj[np.lexsort(pj.T[::-1])], atol=1e-5)
    np.testing.assert_array_equal(runner.build_map(8192), pt)


def test_health_check_classification(port_run):
    """ok on a normal frame; degraded/diverged on doctored metrics."""
    _, runner, res, _ = port_run
    assert runner.health_check(res) == "ok"
    assert runner.health_check(res._replace(s2m_num_corr=torch.tensor(1))) == "degraded"
    assert runner.health_check(res._replace(s2s_converged=False)) == "degraded"
    assert runner.health_check(res._replace(s2m_num_corr=torch.tensor(0))) == "diverged"
    nan_pose = res.pose.clone()
    nan_pose[0, 3] = torch.nan
    assert runner.health_check(res._replace(pose=nan_pose)) == "diverged"


# ------------------------------------------------------------- numpy copies

def test_loop_world_and_render_scan_identical():
    wj = jsyn.make_loop_world(np.random.default_rng(0), n_frames=6, speed=0.4, z_amplitude=0.5)
    wt = tsyn.make_loop_world(np.random.default_rng(0), n_frames=6, speed=0.4, z_amplitude=0.5)
    for f in ("surface_points", "poses", "stamps"):
        np.testing.assert_array_equal(getattr(wt, f), getattr(wj, f), err_msg=f)
    for beams in (None, (16, 256)):
        for t in (0, 5):
            kw = dict(max_range=13.0, max_points=2048)
            sj = jsyn.render_scan(wj, t, np.random.default_rng(t), **kw,
                                  beams=beams and jsyn.BeamModel(*beams))
            st = tsyn.render_scan(wt, t, np.random.default_rng(t), **kw,
                                  beams=beams and tsyn.BeamModel(*beams))
            np.testing.assert_array_equal(st, sj)
            assert len(st) > 100


def test_dump_kitti_and_readers_identical(tmp_path):
    """Both dump_kitti copies write the same bytes; both KITTI readers read
    them alike; trajectory and PLY files cross-read between packages."""
    world = tsyn.make_loop_world(np.random.default_rng(0), n_frames=4, speed=0.4)
    for pkg, name in ((jsyn, "j"), (tsyn, "t")):
        pkg.dump_kitti(world, str(tmp_path / name), "11", max_points=2048)
    for sub in ("sequences/11/velodyne/000002.bin", "sequences/11/times.txt", "poses/11.txt"):
        assert (tmp_path / "t" / sub).read_bytes() == (tmp_path / "j" / sub).read_bytes()
    sj = jkitti.load_sequence(str(tmp_path / "j"), "11")
    st = tkitti.load_sequence(str(tmp_path / "j"), "11")
    assert len(st) == len(sj) == 4
    np.testing.assert_array_equal(st.poses, sj.poses)
    np.testing.assert_array_equal(st.stamps, sj.stamps)
    np.testing.assert_array_equal(st.scan_xyzi(2), sj.scan_xyzi(2))
    (tmp_path / "calib.txt").write_text("P0: " + " ".join(["1.5"] * 12) + "\nTr: " +
                                        " ".join(map(str, range(12))) + "\n")
    cj, ct = jkitti.read_calib(str(tmp_path / "calib.txt")), tkitti.read_calib(str(tmp_path / "calib.txt"))
    assert cj.keys() == ct.keys() and all(np.array_equal(cj[k], ct[k]) for k in cj)

    poses = world.poses
    for writer, reader in ((ttraj.write_kitti, jtraj.read_kitti), (jtraj.write_kitti, ttraj.read_kitti)):
        writer(str(tmp_path / "traj.txt"), poses)
        np.testing.assert_allclose(reader(str(tmp_path / "traj.txt")), poses, atol=1e-8)
    ttraj.write_tum(str(tmp_path / "t.tum"), world.stamps, poses)
    jtraj.write_tum(str(tmp_path / "j.tum"), world.stamps, poses)
    assert (tmp_path / "t.tum").read_text() == (tmp_path / "j.tum").read_text()
    cloud = np.random.default_rng(1).normal(size=(300, 4)).astype(np.float32)
    for c in (3, 4):
        tply.write_ply(str(tmp_path / "t.ply"), cloud[:, :c])
        np.testing.assert_array_equal(jply.read_ply(str(tmp_path / "t.ply")), cloud[:, :c])
        jply.write_ply(str(tmp_path / "j.ply"), cloud[:, :c])
        np.testing.assert_array_equal(tply.read_ply(str(tmp_path / "j.ply")), cloud[:, :c])


def test_dashboard_and_timing_identical():
    tj, tt = jprof.TimingStats(), tprof.TimingStats()
    for ms in (40.0, 35.5, 80.25, 33.0, 31.0, 30.5, 36.0):
        tj.push(ms)
        tt.push(ms)
    assert tt.steady_state(skip=2) == tj.steady_state(skip=2)
    args = (12, np.array([1.5, -2.25, 0.5]), np.array([1.0, 0.0, 0.0, 0.0]), 7.5)
    health = {"s2s_it": 2, "s2s_nc": 1900, "s2m_it": 3, "s2m_nc": 1800}
    dj = jprof.dashboard(*args, tj, 3, health)
    dt = tprof.dashboard(*args, tt, 3, health)
    # the RAM figure is the process's own, read at each call
    strip = lambda d: [ln for ln in d.splitlines() if "RAM" not in ln]  # noqa: E731
    assert strip(dt) == strip(dj)
    assert tprof.CpuMonitor().sample() == (0.0, 0.0, tprof.CpuMonitor().n_cores)
