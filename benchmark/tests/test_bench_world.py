"""The device renderer against the frozen numpy ray-caster, on the CPU."""

import numpy as np
import pytest
import torch

from benchmark.reference import raycast
from benchmark.traffic import world as bw


@pytest.mark.parametrize("closed_loop,fov", [(False, (16.6, -16.6)), (True, (2.0, -24.8))])
def test_render_matches_numpy_raycast(closed_loop, fov):
    world = bw.make_urban_world(np.random.default_rng(3), n_frames=24, speed=0.4,
                                corridor=7.0, n_dynamic=2, closed_loop=closed_loop)
    beams = raycast.BeamModel(n_beams=16, n_azimuth=256, fov_up_deg=fov[0], fov_down_deg=fov[1])
    sensor = bw.Sensor(16, 256, fov[0], fov[1], max_range=13.0, noise=0.0)
    dw = bw.DeviceWorld(world, "cpu")
    for frame in (0, 9, 23):
        dirs = raycast._beam_dirs(beams, np.random.default_rng(frame))
        want = raycast.render_raycast(world, frame, np.random.default_rng(frame), max_range=13.0,
                                      noise=0.0, beams=beams)
        t_hit, sigma = bw.raycast(dw, world.poses[frame], float(world.stamps[frame]),
                                  torch.from_numpy(dirs), sensor)
        ok = (t_hit > sensor.min_range) & (t_hit < sensor.max_range)
        got = (torch.from_numpy(dirs) * t_hit[:, None])[ok].numpy()
        assert got.shape == want.shape and len(want) > 1000
        # foliage returns carry their box's shell noise even at noise=0, drawn
        # from the numpy generator: compare the crisp surfaces' ranges
        crisp = (sigma[ok] == 0).numpy()
        assert crisp.mean() > 0.5
        np.testing.assert_allclose(got[crisp], want[crisp], rtol=2e-6, atol=2e-6)
        shell = np.linalg.norm(got[~crisp] - want[~crisp], axis=1)
        assert (shell < 6 * 0.12).all()


def test_render_is_seeded():
    world = bw.make_urban_world(np.random.default_rng(5), n_frames=8, speed=0.4, corridor=7.0)
    sensor = bw.Sensor(16, 256, 16.6, -16.6, max_range=13.0)
    dw = bw.DeviceWorld(world, "cpu")

    def sweep(seed):
        gen = torch.Generator().manual_seed(seed)
        return bw.render(dw, 4, sensor, gen)

    (a, ma), (b, mb), (c, _) = sweep(11), sweep(11), sweep(12)
    assert torch.equal(a, b) and torch.equal(ma, mb) and not torch.equal(a, c)
    r = torch.linalg.norm(a[ma], dim=1)
    assert bool(((r > 0.4) & (r < 13.1)).all())


def test_imu_rows_integrate_to_the_true_rotation():
    from direct_lidar_odometry_tpu_torch.odometry import imu as imu_mod

    world = bw.make_urban_world(np.random.default_rng(4), n_frames=30, speed=0.8, corridor=7.0)
    rot = world.poses[:, :3, :3]
    stamps = 0.1 * np.arange(len(rot))
    rows = bw.imu_rows(rot, stamps, 100.0, 0.0, 3.0, bw.seed_words(9, 4, 0))
    assert rows[0][0, 0] == -3.0 and rows[0][-1, 0] == 0.0 and len(rows[0]) == 301
    assert all(len(r) == 10 and r[-1, 0] == stamps[t] for t, r in enumerate(rows) if t)
    buf = imu_mod.ImuBuffer(3.0, 2000)
    for t, r in enumerate(rows):
        for row in r:
            buf.push(float(row[0]), row[1:4], row[4:7])
        if t:
            assert buf.calibrated
            window, count = buf.window(stamps[t - 1], stamps[t], 256)
            prior = imu_mod.integrate_window_host(window, count)
            np.testing.assert_allclose(prior[:3, :3], rot[t - 1].T @ rot[t], atol=1e-4)
