"""The port's IMU path and chunked dispatch against the JAX package: the
numpy copies (``ImuBuffer``, ``integrate_window_host``,
``make_imu_between``) bit-identical to their originals on seeded streams,
the tensor ``integrate_window`` and ``gravity_align_quat`` within 1e-6, the
runner with the IMU prior and gravity alignment against the JAX runner
(pallas, interpret mode) on the tilted-sensor world of
``tests/test_imu_e2e.py``, and ``process_chunk`` against ``process_scan``.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.config import DloConfig, ImuConfig, ShapeConfig
from direct_lidar_odometry_tpu.io import evaluation, synthetic as jsyn
from direct_lidar_odometry_tpu.odometry import imu as jimu, state as jstate
from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner as JaxRunner
from direct_lidar_odometry_tpu_torch import config as tcfg
from direct_lidar_odometry_tpu_torch.io import synthetic as tsyn
from direct_lidar_odometry_tpu_torch.odometry import imu as timu, state as tstate
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
from tests.test_imu_e2e import _tilted_loop_world

N_FRAMES = 20


def _stream(seed, n, t0=-1.5, rate=100.0):
    rng = np.random.default_rng(seed)
    stamps = t0 + np.cumsum(rng.uniform(0.5, 1.5, n)) / rate
    return stamps, rng.normal(scale=0.5, size=(n, 3)), rng.normal([0, 0, 9.81], 0.2, size=(n, 3))


@pytest.mark.parametrize("calib_time,buffer_size", [(0.0, 2000), (1.0, 2000), (1.0, 64)])
def test_imu_buffer_matches_reference(calib_time, buffer_size):
    """Calibration, the circular buffer (also when it wraps) and windows,
    bit for bit."""
    jb, tb = jimu.ImuBuffer(calib_time, buffer_size), timu.ImuBuffer(calib_time, buffer_size)
    stamps, gyro, accel = _stream(0, 300)
    for s, g, a in zip(stamps, gyro, accel):
        jb.push(float(s), g, a)
        tb.push(float(s), g, a)
        assert tb.calibrated == jb.calibrated
    for name in ("buffer", "gyro_bias", "accel_mean"):
        np.testing.assert_array_equal(getattr(tb, name), getattr(jb, name), err_msg=name)
    assert (tb.size, tb.head, tb.first_stamp) == (jb.size, jb.head, jb.first_stamp)
    for t0, t1, width in [(-0.5, -0.4, 32), (0.0, 0.9, 16), (-2.0, 2.0, 256), (5.0, 6.0, 8)]:
        wj, cj = jb.window(t0, t1, width)
        wt, ct = tb.window(t0, t1, width)
        assert ct == cj
        np.testing.assert_array_equal(wt, wj)


def _window(seed, count):
    rng = np.random.default_rng(seed)
    window = np.zeros((32, 7), np.float32)
    window[:, 0] = np.sort(rng.uniform(0.0, 0.1, 32))
    window[:, 1:4] = rng.normal(scale=0.8, size=(32, 3))
    return window


@pytest.mark.parametrize("count", [0, 1, 2, 7, 31, 32])
def test_integrate_window_host_matches_reference(count):
    window = _window(count, count)
    np.testing.assert_array_equal(timu.integrate_window_host(window, count),
                                  jimu.integrate_window_host(window, count))


@pytest.mark.parametrize("count", [0, 1, 2, 7, 31, 32])
def test_integrate_window_matches_reference(count):
    """The tensor integrator against JAX's device integrator (1e-6) and
    the host copy."""
    window = _window(count, count)
    got = timu.integrate_window(torch.from_numpy(window), torch.tensor(count)).numpy()
    ref = np.asarray(jimu.integrate_window(jnp.asarray(window), jnp.int32(count)))
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_allclose(got, timu.integrate_window_host(window, count), atol=1e-5)


def test_gravity_align_quat_matches_reference():
    rng = np.random.default_rng(1)
    accels = [np.array([0.0, 0.0, 9.81]), np.array([0.0, 0.0, -9.81]),
              np.array([0.3, -0.5, 9.7]), *rng.normal(scale=5.0, size=(5, 3))]
    for a in accels:
        a = np.asarray(a, np.float32)
        got = timu.gravity_align_quat(torch.from_numpy(a)).numpy()
        ref = np.asarray(jimu.gravity_align_quat(jnp.asarray(a)))
        np.testing.assert_allclose(got, ref, atol=1e-6)


def test_make_imu_between_identical():
    wj = jsyn.make_urban_world(np.random.default_rng(4), n_frames=6, speed=0.4, corridor=7.0,
                               n_dynamic=0, closed_loop=True)
    wt = tsyn.make_urban_world(np.random.default_rng(4), n_frames=6, speed=0.4, corridor=7.0,
                               n_dynamic=0, closed_loop=True)
    for t in range(6):
        rj = jsyn.make_imu_between(wj, t, 100.0, np.random.default_rng(t), gyro_bias=np.ones(3))
        rt = tsyn.make_imu_between(wt, t, 100.0, np.random.default_rng(t), gyro_bias=np.ones(3))
        np.testing.assert_array_equal(rt, rj)


# ----------------------------------------------------------------- the runner

def _imu_cfg():
    return DloConfig().replace(
        nn_backend="pallas", gravity_align=True, s2s_prior="constant_velocity",
        imu=ImuConfig(use=True, calib_time=1.0, buffer_size=2048),
        shapes=ShapeConfig(
            n_raw=4096, n_scan=2048, n_keyframe=1024, max_keyframes=16, max_submap_kf=4,
            n_submap_flat=4096, imu_window=32, grid_table_size=2**12,
            submap_table_size=2**12, cell_cap_1nn=8, cell_cap_knn=32, knn_query_chunk=1024,
            hull_directions=16,
        ),
    )


@pytest.fixture(scope="module")
def tilted():
    """The tilted-sensor world of tests/test_imu_e2e.py:32-45, its scans and
    IMU samples, the JAX runner's trajectory over them and the port's
    runner driven frame by frame through process_scan."""
    world, tilt = _tilted_loop_world(N_FRAMES)
    cfg = _imu_cfg()
    beams = jsyn.BeamModel(n_beams=32, n_azimuth=512)
    rng = np.random.default_rng(11)
    scans = [jsyn.render_scan(world, t, rng, max_range=13.0, max_points=cfg.shapes.n_raw,
                              beams=beams) for t in range(N_FRAMES)]
    imu_rng = np.random.default_rng(9)
    samples = [jsyn.make_imu_between(world, t, 100.0, imu_rng) for t in range(N_FRAMES)]
    data = dict(world=world, g_body=tilt.T @ np.array([0.0, 0.0, 9.81]), scans=scans,
                samples=samples, cfg=cfg)
    jr = JaxRunner(cfg)
    _drive(jr, data)
    data["jax_traj"] = jr.trajectory()
    data["port"] = _port_runner(cfg)
    _drive(data["port"], data)
    return data


def _push_static(runner, g_body):
    """1.5 s of static samples: the calibration window (tests/test_imu_e2e.py:59-62)."""
    for i in range(120):
        runner.push_imu(-1.5 + i * 0.01, np.zeros(3), g_body)


def _drive(runner, data, frames=None):
    _push_static(runner, data["g_body"])
    for t in range(N_FRAMES) if frames is None else frames:
        for row in data["samples"][t]:
            runner.push_imu(float(row[0]), row[1:4], row[4:7])
        runner.process_scan(data["scans"][t], float(data["world"].stamps[t]), sync=True)


def _port_runner(cfg):
    return OdometryRunner(tcfg.config_from_dict(dataclasses.asdict(cfg)), device="cpu")


def test_runner_imu_and_gravity_align_match_reference(tilted):
    """Poses within 5e-3 m of the JAX runner; the initial orientation levels
    the tilted gravity (1 degree) and the aligned ATE stays under 0.08 m
    (the bounds of tests/test_imu_e2e.py:76-81)."""
    est = tilted["port"].trajectory()
    assert est.shape == tilted["jax_traj"].shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(est, tilted["jax_traj"], atol=5e-3)
    g = tilted["g_body"]
    g_est = est[0][:3, :3] @ (g / np.linalg.norm(g))
    assert np.arccos(np.clip(g_est[2], -1, 1)) < np.deg2rad(1.0), g_est
    world = tilted["world"]
    gt = np.linalg.inv(world.poses[0])[None] @ world.poses[:N_FRAMES]
    assert evaluation.ate(est, gt, align=True).rmse < 0.08


def test_runner_waits_for_imu_calibration(tilted):
    """No frame is processed before the calibration window has passed
    (reference odom.cc:589-591)."""
    runner = _port_runner(tilted["cfg"])
    assert runner.process_scan(tilted["scans"][0], 0.0) is None
    assert runner.state is None and runner.poses == []
    _push_static(runner, tilted["g_body"])
    assert runner.imu.calibrated
    assert runner.process_scan(tilted["scans"][0], 0.0) is None and runner.state is not None


def test_process_chunk_matches_process_scan(tilted):
    """One process_scan for the first frame, then chunks of 8 and a tail of
    3: the same poses as process_scan(sync=True) frame for frame, a stacked
    FrameResult with the JAX package's fields, and the health of its worst
    frame."""
    single = tilted["port"]
    chunked = _port_runner(tilted["cfg"])
    _drive(chunked, tilted, frames=[0])
    world, scans = tilted["world"], tilted["scans"]
    for lo, hi in ((1, 9), (9, 17), (17, N_FRAMES)):
        for t in range(lo, hi):
            for row in tilted["samples"][t]:
                chunked.push_imu(float(row[0]), row[1:4], row[4:7])
        prepared = chunked.prepare_chunk(scans[lo:hi]) if lo == 9 else None
        res = chunked.process_chunk(scans[lo:hi], [float(s) for s in world.stamps[lo:hi]],
                                    prepared=prepared)
        k = hi - lo
        assert res._fields == jstate.FrameResult._fields
        assert res.pose.shape == (k, 4, 4) and res.s2m_num_corr.shape == (k,)
        assert isinstance(res.s2s_iterations, list) and len(res.new_keyframe) == k
        assert chunked.health_check(res) in ("ok", "degraded")
    np.testing.assert_allclose(chunked.trajectory(), single.trajectory(), atol=1e-6)
    assert chunked.stamps == single.stamps
    assert chunked.prev_stamp == single.prev_stamp
    assert int(chunked.state.frame_idx) == int(single.state.frame_idx) == N_FRAMES
    with pytest.raises(RuntimeError, match="initialized state"):
        _port_runner(tilted["cfg"]).process_chunk(scans[:2], [0.0, 0.1])
    with pytest.raises(ValueError):
        chunked.process_chunk(scans[:2], [0.0])


def test_stack_results_and_health_of_worst_frame(tilted):
    """A stacked result is classified by its worst frame."""
    from direct_lidar_odometry_tpu_torch.odometry.runner import stack_results

    runner = tilted["port"]
    results = [s.result for s in runner.stats[1:4]]
    stacked = stack_results(results)
    assert runner.health_check(stacked) == "ok"
    bad = results[1]._replace(s2m_num_corr=torch.zeros_like(results[1].s2m_num_corr))
    assert runner.health_check(stack_results([results[0], bad, results[2]])) == "diverged"
    weak = results[2]._replace(s2s_converged=False)
    assert runner.health_check(stack_results([results[0], weak])) == "degraded"
    assert tstate.FrameResult._fields == jstate.FrameResult._fields
