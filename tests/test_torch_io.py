"""The port's copies of the ray-cast world generator and the ATE evaluator
reproduce the JAX package's exactly from the same seeds."""

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


def test_ate_identical():
    rng = np.random.default_rng(1)
    gt = np.tile(np.eye(4), (20, 1, 1))
    gt[:, :3, 3] = np.cumsum(rng.normal(size=(20, 3)), axis=0)
    est = gt.copy()
    est[:, :3, 3] += rng.normal(scale=0.05, size=(20, 3))
    for align in (False, True):
        assert vars(teval.ate(est, gt, align=align)) == vars(jeval.ate(est, gt, align=align))
