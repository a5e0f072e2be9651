"""Host preprocessing of the port (``io/hostprep.py``, ``io/native.py``,
``core/cloud.py``'s encoder) against the JAX package on the same seeded
scans: the numpy functions bitwise, the native library (built here from
``cpp/dlo_host.cpp`` with g++) against the numpy twin and the port's device
voxel filter, the wire encoder, the KITTI reader and the prefetcher.
"""

import shutil

import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.io import hostprep as jhp
from direct_lidar_odometry_tpu_torch.core import cloud as tcloud
from direct_lidar_odometry_tpu_torch.core.cloud import PointCloud
from direct_lidar_odometry_tpu_torch.io import hostprep as thp, native
from direct_lidar_odometry_tpu_torch.ops import preprocess as tprep, voxel as tvoxel

pytestmark = pytest.mark.skipif(shutil.which("g++") is None, reason="g++ is not installed")


def _scan(seed: int, n: int = 20000, channels: int = 3) -> np.ndarray:
    """A raw scan with NaN rows and points inside the 1 m crop box."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-30, 30, (n, channels)).astype(np.float32)
    if channels == 4:
        pts[:, 3] = rng.uniform(0, 1, n)
    pts[100:110, :3] = np.nan
    pts[200:220, :3] *= 0.01
    return pts


@pytest.mark.parametrize("fn,cap", [
    ("_preprocess_morton_numpy", 32768), ("_preprocess_morton_numpy", 2048),
    ("voxel_mean_xyzi", None), ("voxel_mean_xyzi", 1024),
    ("reduce_keyframe_scan_xyzi:3", 2048), ("reduce_keyframe_scan_xyzi:4", 2048),
])
def test_numpy_functions_bitwise_equal_reference(fn, cap):
    """The numpy copies give the JAX package's arrays bit for bit, without
    and with capacity overflow (Bresenham stride), for xyz and xyzi input."""
    name, _, channels = fn.partition(":")
    if name == "_preprocess_morton_numpy":
        args = (_scan(0), 1.0, 0.25, cap)
    elif name == "voxel_mean_xyzi":
        pts = _scan(1, channels=4)
        pts = pts[np.isfinite(pts).all(axis=1)]
        args = (pts, 0.5, cap)
    else:
        args = (_scan(2, channels=int(channels)), 1.0, 0.25, 0.5, cap)
    want = getattr(jhp, name)(*args)
    got = getattr(thp, name)(*args)
    assert got.dtype == want.dtype and got.shape == want.shape
    if cap is not None and name != "voxel_mean_xyzi":
        assert len(got) <= cap
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("cap", [32768, 2048])
def test_native_preprocess_morton_matches_numpy_and_device(cap):
    """The C++ host preprocessor, the numpy twin and the port's device op
    (``voxel_downsample_morton``, on the CPU) give the same voxel centroids
    in the same Morton order, with and without overflow (the bound of JAX
    tests/test_native.py:76-100)."""
    assert native.available(), native.load_error()
    assert thp.implementation() == "native"
    pts = _scan(3)
    a = native.preprocess_morton(pts, 1.0, 0.25, cap)
    b = thp._preprocess_morton_numpy(pts, 1.0, 0.25, cap)
    assert a.shape == b.shape and len(a) <= cap
    np.testing.assert_allclose(a, b, atol=1e-4)
    np.testing.assert_array_equal(thp.preprocess_morton(pts, 1.0, 0.25, cap), a)
    c = tprep.preprocess(PointCloud(torch.from_numpy(pts), torch.ones(len(pts), dtype=torch.bool)),
                         1.0)
    d = tvoxel.voxel_downsample_morton(c, 0.25, out_capacity=cap)
    dd = d.points[d.mask].numpy()
    assert dd.shape == a.shape
    np.testing.assert_allclose(dd, a, atol=1e-4)


def test_native_quantize_matches_numpy_encode(monkeypatch):
    """``quantize_for_transfer`` runs ``native.quantize`` when the library
    is available; it decodes to the numpy encoder's points within one
    quantum a coordinate, with the same offset, count and zero tail."""
    assert native.available(), native.load_error()
    pts = _scan(4)[:, :3]
    pts = pts[np.isfinite(pts).all(axis=1)]
    cap = 32768
    q, lo, scale, m = native.quantize(pts, cap)
    enc = tcloud.quantize_for_transfer(pts, cap)
    np.testing.assert_array_equal(enc.q, q)
    monkeypatch.setattr(native, "available", lambda: False)
    ref = tcloud.quantize_for_transfer(pts, cap)
    np.testing.assert_array_equal(lo, ref.lo)
    np.testing.assert_allclose(scale, ref.scale, rtol=1e-6)
    assert int(m) == int(ref.count) == len(pts)
    assert not q[m:].any() and not ref.q[m:].any()

    def decode(x):
        return tcloud.dequantize(torch.from_numpy(x.q.view(np.int16)), torch.from_numpy(x.lo),
                                 torch.from_numpy(x.scale), int(x.count)).points.numpy()[:m]

    err = np.abs(decode(enc) - decode(ref))
    assert np.all(err <= ref.scale * 1.001), err.max(axis=0)


def test_read_velodyne_and_feeder_stream_in_order(tmp_path):
    """``read_velodyne`` drops the intensity column; ``ScanFeeder`` with raw
    reads serves every file in order, counted; a missing file raises."""
    rng = np.random.default_rng(5)
    files, scans = [], []
    for i in range(5):
        p = tmp_path / f"{i:06d}.bin"
        s = rng.normal(scale=10, size=(2000 + 10 * i, 4)).astype(np.float32)
        s.tofile(p)
        files.append(str(p))
        scans.append(s)
    np.testing.assert_array_equal(native.read_velodyne(files[2]), scans[2][:, :3])
    with pytest.raises(IOError):
        native.read_velodyne(str(tmp_path / "missing.bin"))
    before = native.counts["feeder_scans"]
    feeder = native.ScanFeeder(files, crop_size=0.0, res=0.0, depth=2)
    got = list(feeder)
    feeder.close()
    assert [i for i, _ in got] == list(range(5))
    for (_, s), want in zip(got, scans):
        np.testing.assert_array_equal(s, want[:, :3])
    assert native.counts["feeder_scans"] - before == 5
    feeder = native.ScanFeeder([files[0], str(tmp_path / "missing.bin")], crop_size=0.0, res=0.0)
    it = iter(feeder)
    assert next(it)[0] == 0
    with pytest.raises(IOError):
        next(it)
    feeder.close()


def test_build_failure_keeps_its_reason(tmp_path, monkeypatch):
    """A library that does not compile gives ``available() == False`` with
    the compiler's message from ``load_error()``, and the entry points raise
    with it; the numpy paths take over."""
    bad = tmp_path / "dlo_host.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_state", {})
    assert not native.available()
    assert "g++ failed" in native.load_error()
    assert thp.implementation() == "numpy"
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.quantize(np.zeros((4, 3), np.float32), 8)
    pts = _scan(6)
    np.testing.assert_array_equal(thp.preprocess_morton(pts, 1.0, 0.25, 4096),
                                  thp._preprocess_morton_numpy(pts, 1.0, 0.25, 4096))
