"""The plain reference against the port, on the CPU at tiny shapes: the
scan reduction, the keyframe clouds, the normals and the S2M solve. The
test imports both; the reference imports nothing of the port."""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.reference import geometry as geo
from benchmark.reference import judge
from benchmark.traffic import world as bw
from direct_lidar_odometry_tpu_torch.config import DloConfig, config_from_dict
from direct_lidar_odometry_tpu_torch.core import cloud as cl
from direct_lidar_odometry_tpu_torch.io import hostprep
from direct_lidar_odometry_tpu_torch.odometry import keyframes, pipeline
from direct_lidar_odometry_tpu_torch.registration import gicp

CFG = {
    "preprocessing": {"crop": {"use": True, "size": 1.0}, "voxel_scan": {"use": True, "res": 0.25},
                      "voxel_submap": {"use": True, "res": 0.5}},
    "shapes": {"n_raw": 8192, "n_scan": 2048, "n_keyframe": 1024, "max_keyframes": 16,
               "max_submap_kf": 4, "n_submap_flat": 4096},
    "gicp": {"s2m": {"max_correspondence_distance": 0.5}},
}


def _scans(n=3, seed=1):
    world = bw.make_urban_world(np.random.default_rng(seed), n_frames=12, speed=0.4, corridor=7.0)
    dw = bw.DeviceWorld(world, "cpu")
    sensor = bw.Sensor(16, 256, 16.6, -16.6, max_range=13.0)
    gen = torch.Generator().manual_seed(seed)
    out = []
    for t in range(n):
        pts, ok = bw.render(dw, 4 * t, sensor, gen)
        out.append(pts[ok])
    return world, out


def _port_cfg(**dlo):
    return config_from_dict({**CFG, **dlo})


def _sorted(p: torch.Tensor) -> np.ndarray:
    a = p.numpy().astype(np.float64)
    return a[np.lexsort(a.T[::-1])]


def test_reference_imports_nothing_of_the_port():
    for path in (Path(judge.__file__).parent).glob("*.py"):
        tree = ast.parse(path.read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
        tops = {n.split(".")[0] for n in names}
        assert tops <= {"__future__", "dataclasses", "numpy", "torch", "benchmark"}, (path, tops)
        assert all(n.startswith("benchmark.reference") for n in names if n.startswith("benchmark"))


@pytest.mark.parametrize("wire", [True, False])
def test_scan_reduction_matches_the_port(wire):
    _, scans = _scans()
    cfg = _port_cfg(host_preprocess=wire)
    for raw in scans:
        ref = geo.reduce_scan(raw, CFG, wire)
        if wire:
            host = hostprep.preprocess_morton(raw.numpy(), 1.0, 0.25, cfg.shapes.n_scan)
            qs = cl.quantize_for_transfer(host, cfg.shapes.n_scan)
            port = cl.dequantize(torch.from_numpy(qs.q.view(np.int16)), torch.from_numpy(qs.lo),
                                 torch.from_numpy(qs.scale), int(qs.count))
        else:
            pad = torch.zeros((cfg.shapes.n_raw, 3))
            pad[:len(raw)] = raw
            mask = torch.arange(cfg.shapes.n_raw) < len(raw)
            port = pipeline.preprocess_scan(pad, mask, cfg)
        got = port.points[port.mask]
        assert got.shape == ref.shape
        err = (got - ref).abs().amax(dim=1)
        # a centroid summed in another order can land one 16-bit step away
        step = float((ref.amax(0) - ref.amin(0)).max()) / 65535.0 if wire else 0.0
        assert float(err.max()) <= step * 1.01 + 1e-5
        assert float((err > 1e-5).to(torch.float64).mean()) < 1e-3


def test_keyframe_cloud_and_normals_match_the_port():
    _, scans = _scans()
    cfg = _port_cfg()
    pose = torch.eye(4)
    pose[:3, :3] = torch.from_numpy(np.array(
        [[0.8, -0.6, 0.0], [0.6, 0.8, 0.0], [0.0, 0.0, 1.0]], np.float32))
    pose[:3, 3] = torch.tensor([12.5, -3.25, 1.5])
    scan = geo.reduce_scan(scans[1], CFG, False)
    pad = torch.full((cfg.shapes.n_scan, 3), 1e6)
    pad[:len(scan)] = scan
    mask = torch.arange(cfg.shapes.n_scan) < len(scan)
    c, nrm = keyframes.make_keyframe_cloud(cl.PointCloud(pad, mask), pose, cfg)
    drive = judge.Drive(CFG, lambda f: scans[1], lambda f: pose.double(), False, "cpu")
    ref = drive.keyframe(0, geo.FLOAT32)
    np.testing.assert_allclose(_sorted(c.points[c.mask]), _sorted(ref.points), atol=1e-5)
    # normals of the same points, up to sign
    idx, dist = geo.nearest(c.points[c.mask], ref.points)
    assert float(dist.max()) < 1e-5
    same = c.mask.clone()
    port_n = nrm.normals[same][nrm.valid[same]]
    ref_n = ref.normals[idx][nrm.valid[same]].to(torch.float32)
    assert bool((ref.valid[idx] == nrm.valid[same]).all())
    # a line-like neighbourhood has no unique smallest eigenvector
    agree = (port_n * ref_n).sum(-1).abs() > 0.999
    assert float(agree.to(torch.float64).mean()) > 0.99


def test_s2m_solve_matches_the_port():
    _, scans = _scans(n=2)
    src_pts = geo.reduce_scan(scans[0], CFG, False)
    n, v = geo.radius_normals(src_pts, 0.75)
    src = geo.Cloud(src_pts, n, v)
    tgt_pts = geo.reduce_scan(scans[1], CFG, False)
    n, v = geo.radius_normals(tgt_pts, 0.75)
    tgt = geo.Cloud(tgt_pts, n, v)
    guess = torch.eye(4, dtype=torch.float64)
    guess[0, 3] = 1.5
    ref, ok, idx = geo.gicp_solve(src, tgt, guess, 1.0, geo.JUDGE)
    assert int(ok.sum()) > 300
    stage = dataclasses.replace(DloConfig().gicp.s2m, max_correspondence_distance=1.0,
                                transformation_epsilon=1e-7, rotation_epsilon=1e-7,
                                max_iterations=60)
    f32 = torch.float32
    port = gicp.align(
        gicp.GicpSource(src_pts, torch.ones(len(src_pts), dtype=torch.bool), src.normals.to(f32),
                        src.valid),
        gicp.make_target(tgt_pts, torch.ones(len(tgt_pts), dtype=torch.bool),
                         tgt.normals.to(f32), tgt.valid, backend="brute"),
        guess.to(f32), stage, backend="brute")
    # the port solves in float32, the reference in float64
    assert judge._gap(port.transform, ref, src_pts[ok], tgt.normals[idx[ok]]) < 2e-4
