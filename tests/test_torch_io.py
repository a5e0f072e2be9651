"""The port's copies of the world generators (the ray-cast urban world,
the wandering point-soup world and its moving boxes) and of the ATE
evaluator reproduce the JAX package's exactly from the same seeds."""

import numpy as np
import pytest

from direct_lidar_odometry_tpu.io import evaluation as jeval, synthetic as jsyn
from direct_lidar_odometry_tpu_torch.io import evaluation as teval, synthetic as tsyn


@pytest.mark.parametrize("n_dynamic", [0, 2])
def test_urban_world_and_raycast_identical(n_dynamic):
    wj = jsyn.make_urban_world(np.random.default_rng(0), n_frames=6, speed=1.0,
                               n_dynamic=n_dynamic)
    wt = tsyn.make_urban_world(np.random.default_rng(0), n_frames=6, speed=1.0,
                               n_dynamic=n_dynamic)
    for f in ("boxes", "poses", "stamps", "rough", "dynamic_boxes", "dynamic_vel"):
        np.testing.assert_array_equal(getattr(wt, f), getattr(wj, f), err_msg=f)
    beams_j = jsyn.BeamModel(n_beams=16, n_azimuth=256)
    beams_t = tsyn.BeamModel(n_beams=16, n_azimuth=256)
    for t in (0, 5):
        sj = jsyn.render_scan(wj, t, np.random.default_rng(t), max_range=40.0,
                              max_points=4096, beams=beams_j)
        st = tsyn.render_raycast(wt, t, np.random.default_rng(t), max_range=40.0,
                                 max_points=4096, beams=beams_t)
        np.testing.assert_array_equal(st, sj)
        assert len(st) > 500


@pytest.mark.parametrize("seed", [0, 1])
def test_wandering_world_and_dynamic_boxes_identical(seed):
    """``make_world`` (at ``tools/scaling_bench.py``'s arguments and at its
    defaults) and ``add_dynamic_boxes`` give the JAX worlds bit for bit."""
    for kwargs in (dict(n_frames=6, extent=15.0, n_boxes=6, speed=0.4, ground_points=8000,
                        density=6.0), dict(n_frames=4)):
        wj = jsyn.make_world(np.random.default_rng(seed), **kwargs)
        wt = tsyn.make_world(np.random.default_rng(seed), **kwargs)
        wj = jsyn.add_dynamic_boxes(wj, np.random.default_rng(seed + 10), n=3)
        wt = tsyn.add_dynamic_boxes(wt, np.random.default_rng(seed + 10), n=3)
        for f in ("surface_points", "poses", "stamps", "dynamic_points", "dynamic_vel"):
            np.testing.assert_array_equal(getattr(wt, f), getattr(wj, f), err_msg=f)
            assert getattr(wt, f).dtype == getattr(wj, f).dtype, f
        assert len(wt.dynamic_points) > 0


def test_ate_identical():
    rng = np.random.default_rng(1)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(size=(20, 3)), axis=0)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.05, size=(20, 3))
    for align in (False, True):
        assert vars(teval.ate(est, gt, align=align)) == vars(jeval.ate(est, gt, align=align))
