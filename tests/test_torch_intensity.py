"""Host preprocessing and the intensity sidecar of the port's runner, and
the CLI's KITTI xyzi path, against the JAX package on the same scans:
trajectories with ``host_preprocess`` (pallas backends, JAX in interpret
mode), ``process_chunk`` against ``process_scan``, the sidecar's ring slots
and its xyzi map with ``map.carry_intensity``, the host reads a frame with
the sidecar on and off, and every formerly refused option running.

One JAX reference run, shared by the module.
"""

import dataclasses
import json

import numpy as np
import pytest

from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner as JaxRunner
from direct_lidar_odometry_tpu_torch import cli, config as tcfg
from direct_lidar_odometry_tpu_torch.io import native, ply as tply, synthetic as tsyn
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
from direct_lidar_odometry_tpu_torch.utils import sync
from tests.test_intensity import _world_intensity
from tests.test_pallas_e2e import _ate, _scans, pallas_cfg, sparse_world  # noqa: F401
from tests.test_torch_cli import SMALL

N_FRAMES = 6


def _xyzi(world, scans):
    """Each scan with the world's smooth reflectivity field as intensity."""
    out = []
    for t, s in enumerate(scans):
        w = s @ world.poses[t][:3, :3].T + world.poses[t][:3, 3]
        out.append(np.concatenate([s, _world_intensity(w)[:, None]], axis=1))
    return out


def _cfg(**over):
    cfg = pallas_cfg(host_preprocess=True)
    if over.pop("intensity", False):
        cfg = cfg.replace(map=dataclasses.replace(cfg.map, carry_intensity=True))
    return cfg.replace(**over)


def _port_cfg(jax_cfg):
    return tcfg.config_from_dict(dataclasses.asdict(jax_cfg))


def _drive(runner, world, scans):
    reads = []
    for t, s in enumerate(scans):
        before = sync.counts["host_reads"]
        runner.process_scan(s, float(world.stamps[t]), sync=True)
        reads.append(sync.counts["host_reads"] - before)
    return reads


@pytest.fixture(scope="module")
def reference(sparse_world):  # noqa: F811
    """The JAX runner with host preprocessing and the intensity sidecar on
    xyzi scans: trajectory, ATE, sidecar slots and xyzi map."""
    cfg = _cfg(intensity=True)
    scans = _xyzi(sparse_world, _scans(sparse_world, N_FRAMES))
    runner = JaxRunner(cfg)
    for t, s in enumerate(scans):
        runner.process_scan(s, float(sparse_world.stamps[t]), sync=True)
    xyzi = runner.build_map_xyzi()
    return dict(cfg=cfg, scans=scans, traj=runner.trajectory(), ate=_ate(runner, sparse_world),
                slots=sorted(runner._ikf), map=xyzi, n_kf=runner.num_keyframes())


@pytest.fixture(scope="module")
def port_run(reference, sparse_world):  # noqa: F811
    runner = OdometryRunner(_port_cfg(reference["cfg"]), device="cpu")
    reads = _drive(runner, sparse_world, reference["scans"])
    return runner, reads


def test_host_preprocess_trajectory_matches_reference(reference, port_run, sparse_world):  # noqa: F811
    """host_preprocess on pallas: poses within 5e-3 m, ATE < 0.05 m for
    both, the scans preprocessed by the native library, n_scan points on
    the wire."""
    runner, _ = port_run
    assert runner.cfg.host_preprocess and runner.host_prep_impl == "native"
    assert runner._wire_capacity() == runner.cfg.shapes.n_scan
    est = runner.trajectory()
    assert est.shape == reference["traj"].shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(est, reference["traj"], atol=5e-3)
    assert _ate(runner, sparse_world) < 0.05 and reference["ate"] < 0.05
    assert all(int(s.result.s2m_num_corr) > 100 for s in runner.stats[1:])


def test_intensity_sidecar_matches_reference(reference, port_run):
    """The same ring slots as the JAX runner's sidecar, and build_map_xyzi
    equal to its map within 1e-4 after a lexicographic sort."""
    runner, _ = port_run
    got = runner.build_map_xyzi()
    assert sorted(runner._ikf) == reference["slots"] and not runner._ipending
    assert runner.num_keyframes() == reference["n_kf"] == len(reference["slots"]) >= 2
    want = reference["map"]
    assert got.shape == want.shape and got.shape[1] == 4 and len(got) > 100
    np.testing.assert_allclose(got[np.lexsort(got.T[::-1])], want[np.lexsort(want.T[::-1])],
                               atol=1e-4)


def test_host_reads_unchanged_with_sidecar(reference, port_run, sparse_world):  # noqa: F811
    """The sidecar adds no host read: the same reads a frame as a run of
    the same config without carry_intensity on the xyz scans, and the same
    poses."""
    runner, reads_on = port_run
    cfg = reference["cfg"]
    off = OdometryRunner(_port_cfg(cfg.replace(map=dataclasses.replace(
        cfg.map, carry_intensity=False))), device="cpu")
    reads_off = _drive(off, sparse_world, [s[:, :3] for s in reference["scans"]])
    assert reads_on == reads_off
    assert not off._ikf
    np.testing.assert_array_equal(off.trajectory(), runner.trajectory())


def test_process_chunk_matches_process_scan_with_host_preprocess(sparse_world):  # noqa: F811
    """Chunks of host-preprocessed scans give the poses of process_scan
    within 1e-5 m."""
    cfg = _port_cfg(_cfg())
    scans = _scans(sparse_world, N_FRAMES)
    stamps = [float(s) for s in sparse_world.stamps[:N_FRAMES]]
    per_frame = OdometryRunner(cfg, device="cpu")
    _drive(per_frame, sparse_world, scans)
    chunked = OdometryRunner(cfg, device="cpu")
    chunked.process_scan(scans[0], stamps[0], sync=True)
    chunked.process_chunk(scans[1:4], stamps[1:4])
    chunked.process_chunk(scans[4:], stamps[4:], prepared=chunked.prepare_chunk(scans[4:]))
    assert chunked.host_prep_impl == "native"
    np.testing.assert_allclose(chunked.trajectory(), per_frame.trajectory(), atol=1e-5)


def _kitti(tmp_path, world):
    return tsyn.dump_kitti(world, str(tmp_path / "kitti"), "00", rng=np.random.default_rng(5),
                           max_range=13.0, max_points=8192)


def test_cli_kitti_xyzi_roundtrip(sparse_world, tmp_path, capsys):  # noqa: F811
    """--kitti on a dump_kitti sequence (intensity 1/range) with
    carry_intensity and host preprocessing: an xyzi PLY with finite
    intensities inside the inputs' range and the ATE bound of
    tests/test_cli.py; without carry_intensity the scans come through the
    native ScanFeeder, with the same host reads a frame."""
    world = tsyn.SyntheticWorld(sparse_world.surface_points, sparse_world.poses[:N_FRAMES],
                                sparse_world.stamps[:N_FRAMES])
    root = _kitti(tmp_path, world)
    common = ["--kitti", root, "--quiet", "--eval", "--device", "cpu", "--map-ply", "map.ply",
              "--set", "host_preprocess=true"] + SMALL
    runs = {}
    for intensity in (True, False):
        out = tmp_path / f"run_{intensity}"
        argv = common + ["--out-dir", str(out)]
        if intensity:
            argv += ["--set", "map.carry_intensity=true"]
        sync.reset()
        fed = native.counts["feeder_scans"]
        assert cli.main(argv) == 0
        summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        runs[intensity] = dict(summary=summary, reads=sync.counts["host_reads"],
                               fed=native.counts["feeder_scans"] - fed,
                               map=tply.read_ply(str(out / "map.ply")))
    inputs = np.concatenate([np.fromfile(f, np.float32).reshape(-1, 4)[:, 3]
                             for f in sorted((tmp_path / "kitti").rglob("*.bin"))])
    m = runs[True]["map"]
    assert m.shape[1] == 4 and len(m) > 100
    assert np.isfinite(m[:, 3]).all()
    assert inputs.min() - 1e-6 <= m[:, 3].min() and m[:, 3].max() <= inputs.max() + 1e-6
    assert runs[False]["map"].shape[1] == 3
    assert runs[True]["fed"] == 0 and runs[False]["fed"] == N_FRAMES
    assert runs[True]["reads"] == runs[False]["reads"]
    for run in runs.values():
        assert run["summary"]["frames"] == N_FRAMES
        assert run["summary"]["ate_rmse_m"] < 0.15, run["summary"]


@pytest.mark.parametrize("override", [
    {"host_preprocess": True}, {"map.carry_intensity": True},
    {"nn_backend": "brute"}, {"nn_backend": "hashgrid"},
], ids=["host_preprocess", "carry_intensity", "brute", "hashgrid"])
def test_formerly_refused_options_run(override, sparse_world):  # noqa: F811
    """Each option the port once refused builds a runner and tracks two
    frames of xyzi scans."""
    cfg = _port_cfg(pallas_cfg())
    for key, value in override.items():
        cfg = tcfg._override(cfg, key.split("."), value)
    runner = OdometryRunner(cfg, device="cpu")
    scans = _xyzi(sparse_world, _scans(sparse_world, 2))
    _drive(runner, sparse_world, scans)
    res = runner.stats[-1].result
    assert runner.health_check(res) != "diverged" and int(res.s2m_num_corr) > 100
    assert bool(runner._ikf) == bool(override.get("map.carry_intensity"))
