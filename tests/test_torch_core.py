"""Parity of the PyTorch port's core modules with the JAX package.

The same numpy inputs (from seeds) go through each JAX function and its
counterpart in ``direct_lidar_odometry_tpu_torch``: config, SE(3), cloud
decoding, preprocessing, Morton sort, voxel filters and the 3x3
eigen-analysis. Tolerances are stated per case; sorted outputs whose order
among equal keys is unspecified in the reference are compared as sets.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu import config as jcfg
from direct_lidar_odometry_tpu.core import cloud as jcloud, se3 as jse3
from direct_lidar_odometry_tpu.ops import eigh3 as jeigh3, morton as jmorton
from direct_lidar_odometry_tpu.ops import preprocess as jprep, voxel as jvoxel
from direct_lidar_odometry_tpu_torch import config as tcfg
from direct_lidar_odometry_tpu_torch.core import cloud as tcloud, se3 as tse3
from direct_lidar_odometry_tpu_torch.ops import eigh3 as teigh3, morton as tmorton
from direct_lidar_odometry_tpu_torch.ops import preprocess as tprep, voxel as tvoxel
from direct_lidar_odometry_tpu_torch.utils import precision

REPO = Path(__file__).resolve().parent.parent


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# --------------------------------------------------------------------- config

def test_config_default_trees_equal():
    assert dataclasses.asdict(jcfg.DloConfig()) == dataclasses.asdict(tcfg.DloConfig())


def test_config_yaml_loads_equal():
    path = str(REPO / "cfg" / "tpu_dlo.yaml")
    over = {"nn_backend": "pallas", "posegraph.use": False}
    assert dataclasses.asdict(jcfg.load_config(path, over)) == dataclasses.asdict(
        tcfg.load_config(path, over)
    )


@pytest.mark.parametrize("backend", ["hashgrid", "brute"])
def test_unported_backends_raise(backend):
    """The backends the port once refused now resolve to themselves, as in
    the JAX package; only a name neither package knows raises."""
    assert tcfg.resolve_backend(tcfg.DloConfig(nn_backend=backend)) == backend
    assert jcfg.resolve_backend(jcfg.DloConfig(nn_backend=backend)) == backend
    with pytest.raises(ValueError, match="unknown nn_backend"):
        tcfg.resolve_backend(tcfg.DloConfig(nn_backend=backend + "_x"))


@pytest.mark.parametrize("backend,resolved", [
    ("auto", "pallas"), ("pallas", "pallas"), ("pallas_unfused", "pallas_unfused"),
    ("pallas_fused", "pallas_fused"), ("pallas_mxu", "pallas_mxu"),
])
def test_ported_backends_resolve(backend, resolved):
    """The name itself, as in the JAX package; "auto" is the pallas path."""
    assert tcfg.resolve_backend(tcfg.DloConfig(nn_backend=backend)) == resolved
    if backend != "auto":
        assert jcfg.resolve_backend(jcfg.DloConfig(nn_backend=backend)) == resolved


def test_se3_constants():
    np.testing.assert_array_equal(tse3.quat_identity().numpy(), np.asarray(jse3.quat_identity()))
    np.testing.assert_array_equal(tse3.se3_identity().numpy(), np.asarray(jse3.se3_identity()))
    # antiparallel vectors take the rotate-by-pi branch
    a = np.array([[0.0, 0.0, 1.0], [1.0, 0.0, 0.0]], np.float32)
    q = tse3.quat_from_two_vectors(_t(a), _t(-a)).numpy()
    np.testing.assert_allclose(q, np.asarray(jse3.quat_from_two_vectors(jnp.asarray(a), jnp.asarray(-a))),
                               atol=1e-6)


def test_precision_pin():
    precision.pin_float32()
    assert torch.get_float32_matmul_precision() == "highest"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_port_imports_no_jax():
    """The import graphs of the runner, the CLI, every other public module,
    every tool in ``tools_torch/``, ``graft_entry_torch.py``,
    ``chip_smoke.py`` and ``bench_torch.py`` stay free of jax."""
    code = (
        "import sys, direct_lidar_odometry_tpu_torch.odometry.runner, "
        "direct_lidar_odometry_tpu_torch.io.synthetic, "
        "direct_lidar_odometry_tpu_torch.io.evaluation, "
        "direct_lidar_odometry_tpu_torch.cli, "
        "direct_lidar_odometry_tpu_torch.utils.checkpoint, "
        "direct_lidar_odometry_tpu_torch.odometry.mapper, "
        "direct_lidar_odometry_tpu_torch.ops.cuda_gicp, "
        "direct_lidar_odometry_tpu_torch.odometry.loopclosure, "
        "direct_lidar_odometry_tpu_torch.odometry.imu, "
        "direct_lidar_odometry_tpu_torch.parallel.posegraph, "
        "direct_lidar_odometry_tpu_torch.io.native, "
        "direct_lidar_odometry_tpu_torch.io.hostprep, "
        "direct_lidar_odometry_tpu_torch.ops.bruteforce, "
        "direct_lidar_odometry_tpu_torch.ops.hashgrid, "
        "tools_torch.long_validation, tools_torch.staleness_sweep, tools_torch.hull_ab, "
        "tools_torch.trace_frames, tools_torch.debug_loopclosure, tools_torch.scaling_procs, "
        "tools_torch.scaling_procs_worker, tools_torch.scaling_bench, tools_torch.devprof, "
        "tools_torch.profile_stages, tools_torch.ablate_step, tools_torch.micro_align, "
        "tools_torch.micro_linearize, tools_torch.run_baseline, "
        "direct_lidar_odometry_tpu_torch.parallel.sharded, graft_entry_torch, chip_smoke, "
        "bench_torch\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m.startswith('direct_lidar_odometry_tpu.') or m == 'direct_lidar_odometry_tpu']\n"
        "print(bad); sys.exit(1 if bad else 0)"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


# ----------------------------------------------------------------------- se3

def _rotvecs(rng):
    w = rng.normal(size=(16, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = 1e-5 * w[1]                                   # small-angle branch
    w[2] = (np.pi - 1e-4) * w[2] / np.linalg.norm(w[2])  # near pi
    return w


def _case(name, rng):
    w = _rotvecs(rng)
    r = np.asarray(jse3.so3_exp(jnp.asarray(w)))
    q = rng.normal(size=(16, 4)).astype(np.float32)
    v = rng.normal(size=(16, 3)).astype(np.float32)
    tau = np.concatenate([w, v], axis=1)
    t44 = np.asarray(jse3.se3_exp(jnp.asarray(tau)))
    pts = rng.normal(size=(64, 3)).astype(np.float32) * 20
    return {
        "skew": (v,),
        "so3_exp": (w,),
        "so3_log": (r,),
        "quat_mul": (q, q[::-1].copy()),
        "quat_to_rotmat": (q,),
        "rotmat_to_quat": (r,),
        "quat_angle_deg": (q / np.linalg.norm(q, axis=1, keepdims=True), q[::-1].copy()),
        "make_se3": (r, v),
        "se3_inverse": (t44,),
        "transform_points": (t44[3], pts),
        "se3_exp": (tau,),
        "quat_rotate": (q / np.linalg.norm(q, axis=1, keepdims=True), v),
        "quat_from_two_vectors": (v, np.concatenate([v[:8], -v[8:]]) + 0.1 * w),
    }[name]


@pytest.mark.parametrize("name", [
    "skew", "so3_exp", "so3_log", "quat_mul", "quat_to_rotmat", "rotmat_to_quat",
    "quat_angle_deg", "make_se3", "se3_inverse", "transform_points", "se3_exp",
    "quat_rotate", "quat_from_two_vectors",
])
def test_se3_matches_reference(name):
    """Float32 elementwise math in the same order: 1e-5 absolute (degrees for
    quat_angle_deg, whose arctan2 near zero amplifies rounding)."""
    args = _case(name, np.random.default_rng(0))
    ref = np.asarray(getattr(jse3, name)(*map(jnp.asarray, args)))
    out = _np(getattr(tse3, name)(*map(_t, args)))
    atol = 2e-3 if name == "quat_angle_deg" else 1e-5
    np.testing.assert_allclose(out, ref, atol=atol, rtol=1e-5)


# --------------------------------------------------------------------- cloud

def test_dequantize_matches_reference():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-40, 40, size=(900, 3)).astype(np.float32)
    qs = tcloud.quantize_for_transfer(pts, 1024)
    ref = jcloud.dequantize(jnp.asarray(qs.q), jnp.asarray(qs.lo), jnp.asarray(qs.scale),
                            jnp.asarray(qs.count))
    out = tcloud.dequantize(_t(qs.q.view(np.int16)), _t(qs.lo), _t(qs.scale), int(qs.count))
    np.testing.assert_array_equal(_np(out.mask), np.asarray(ref.mask))
    # q * scale + lo: one rounding apart at most where XLA fuses into an FMA
    np.testing.assert_allclose(_np(out.points), np.asarray(ref.points), rtol=1e-6, atol=1e-5)
    # the port's encoder is the JAX package's numpy encoder
    m = int(qs.count)
    np.testing.assert_allclose(_np(out.points)[:m], pts, atol=float(qs.scale.max()))


@pytest.mark.parametrize("n_valid", [0, 5, 37, 64])
def test_cloud_helpers_match_reference(n_valid):
    """``make_cloud`` (with and without a mask), ``to_numpy``, ``compact``
    (order of the valid points, PAD_VALUE rows, the mask) and
    ``concat_clouds`` equal the JAX package's on the same random masked
    cloud; a capacity mismatch raises in both."""
    rng = np.random.default_rng(n_valid)
    pts = rng.normal(scale=5.0, size=(64, 3)).astype(np.float32)
    mask = np.zeros(64, bool)
    mask[rng.choice(64, n_valid, replace=False)] = True
    for m in (mask, None):
        ref = jcloud.make_cloud(jnp.asarray(pts), None if m is None else jnp.asarray(m))
        out = tcloud.make_cloud(_t(pts), None if m is None else _t(m))
        assert out.points.dtype == torch.float32
        np.testing.assert_array_equal(_np(out.points), np.asarray(ref.points))
        np.testing.assert_array_equal(_np(out.mask), np.asarray(ref.mask))
        np.testing.assert_array_equal(tcloud.to_numpy(out), jcloud.to_numpy(ref))
    ref = jcloud.compact(jcloud.PointCloud(jnp.asarray(pts), jnp.asarray(mask)))
    out = tcloud.compact(tcloud.PointCloud(_t(pts), _t(mask)))
    np.testing.assert_array_equal(_np(out.points), np.asarray(ref.points))
    np.testing.assert_array_equal(_np(out.mask), np.asarray(ref.mask))
    np.testing.assert_array_equal(tcloud.to_numpy(out), pts[mask])
    assert np.all(_np(out.points)[n_valid:] == tcloud.PAD_VALUE)
    parts = [(pts[:40], mask[:40]), (pts[40:], mask[40:])]
    ref = jcloud.concat_clouds([jcloud.PointCloud(jnp.asarray(p), jnp.asarray(k))
                                for p, k in parts], capacity=64)
    tparts = [tcloud.PointCloud(_t(p), _t(k)) for p, k in parts]
    out = tcloud.concat_clouds(tparts, capacity=64)
    np.testing.assert_array_equal(_np(out.points), np.asarray(ref.points))
    np.testing.assert_array_equal(_np(out.mask), np.asarray(ref.mask))
    with pytest.raises(ValueError, match="concat capacity 64 != requested 32"):
        jcloud.concat_clouds([jcloud.PointCloud(jnp.asarray(p), jnp.asarray(k))
                              for p, k in parts], capacity=32)
    with pytest.raises(ValueError, match="concat capacity 64 != requested 32"):
        tcloud.concat_clouds(tparts, capacity=32)


# ---------------------------------------------------------------- preprocess

@pytest.mark.parametrize("n_valid", [0, 1, 7, 500])
def test_masked_median_matches_reference(n_valid):
    rng = np.random.default_rng(n_valid)
    vals = rng.uniform(0, 50, size=512).astype(np.float32)
    mask = np.zeros(512, bool)
    mask[rng.permutation(512)[:n_valid]] = True
    ref = float(jprep.masked_median(jnp.asarray(vals), jnp.asarray(mask)))
    assert float(tprep.masked_median(_t(vals), _t(mask))) == ref


def test_preprocess_matches_reference():
    rng = np.random.default_rng(2)
    pts = rng.uniform(-5, 5, size=(1024, 3)).astype(np.float32)
    pts[::17] = np.nan
    pts[5::31, 1] = np.inf
    mask = rng.random(1024) < 0.9
    ref = jprep.preprocess(jcloud.PointCloud(jnp.asarray(pts), jnp.asarray(mask)), 1.0)
    out = tprep.preprocess(tcloud.PointCloud(_t(pts), _t(mask)), 1.0)
    np.testing.assert_array_equal(_np(out.mask), np.asarray(ref.mask))
    np.testing.assert_array_equal(_np(out.points), np.asarray(ref.points))


# -------------------------------------------------------------------- morton

def _cloud(seed, n=2048, valid=0.85, extent=30.0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-extent, extent, size=(n, 3)).astype(np.float32)
    pts[:, 2] *= 0.1
    mask = rng.random(n) < valid
    pts[~mask] = 1e6
    return pts, mask


def test_morton_codes_match_reference():
    pts, mask = _cloud(3)
    ref = np.asarray(jmorton.morton_codes(jnp.asarray(pts), jnp.asarray(mask))).astype(np.int64)
    out = _np(tmorton.morton_codes(_t(pts), _t(mask)))
    np.testing.assert_array_equal(out, ref)
    assert out.max() == 0xFFFFFFFF and out[mask].max() < 0x40000000


def test_sort_cloud_and_aabbs_match_reference():
    """Sorted clouds agree as sequences of codes (points within equal codes
    may be ordered differently); chunk AABBs of the port's order are exact."""
    pts, mask = _cloud(4)
    jp, jm = jmorton.sort_cloud(jnp.asarray(pts), jnp.asarray(mask))
    tp, tm = tmorton.sort_cloud(_t(pts), _t(mask))
    codes_j = np.asarray(jmorton.morton_codes(jnp.asarray(pts), jnp.asarray(mask)))
    np.testing.assert_array_equal(
        np.sort(codes_j.astype(np.int64)),
        _np(tmorton.morton_codes(_t(pts), _t(mask)))[_np(tmorton.sort_order(_t(pts), _t(mask)))],
    )
    np.testing.assert_array_equal(_np(tm), np.asarray(jm))
    assert {tuple(p) for p in _np(tp)[_np(tm)]} == {tuple(p) for p in np.asarray(jp)[np.asarray(jm)]}
    lo_j, hi_j = jmorton.chunk_aabbs(jnp.asarray(_np(tp)), jnp.asarray(_np(tm)), 512)
    lo_t, hi_t = tmorton.chunk_aabbs(tp, tm, 512)
    np.testing.assert_array_equal(_np(lo_t), np.asarray(lo_j))
    np.testing.assert_array_equal(_np(hi_t), np.asarray(hi_j))


# --------------------------------------------------------------------- voxel

def test_scramble_matches_reference():
    ids = np.random.default_rng(5).integers(0, 2**31 - 1, size=4096).astype(np.int32)
    ids[:3] = [0, 1, 2**31 - 1]
    ref = np.asarray(jvoxel._scramble(jnp.asarray(ids))).astype(np.int64)
    np.testing.assert_array_equal(_np(tvoxel._scramble(_t(ids).to(torch.int64))), ref)


def _as_sorted_rows(points, mask):
    p = np.asarray(points)[np.asarray(mask)]
    return p[np.lexsort(p.T[::-1])]


@pytest.mark.parametrize("fn,res,cap", [
    ("voxel_downsample_morton", 0.5, 4096),
    ("voxel_downsample_morton", 0.5, 300),   # Bresenham overflow path
    ("voxel_downsample", 1.0, 4096),
    ("voxel_downsample", 0.5, 256),          # scrambled-order overflow path
])
def test_voxel_filters_match_reference_as_sets(fn, res, cap):
    """Same voxels kept; centroids within float rounding of summation order."""
    pts, mask = _cloud(6, n=4096, extent=12.0)
    ref = getattr(jvoxel, fn)(jcloud.PointCloud(jnp.asarray(pts), jnp.asarray(mask)), res, cap)
    out = getattr(tvoxel, fn)(tcloud.PointCloud(_t(pts), _t(mask)), res, cap)
    assert int(_np(out.mask).sum()) == int(np.asarray(ref.mask).sum()) > 0
    # compacted to the front
    n = int(_np(out.mask).sum())
    assert _np(out.mask)[:n].all()
    np.testing.assert_allclose(
        _as_sorted_rows(_np(out.points), _np(out.mask)),
        _as_sorted_rows(ref.points, ref.mask), atol=1e-5,
    )
    if fn == "voxel_downsample_morton":
        # output in Z order of the voxel grid, as the reference's
        np.testing.assert_allclose(_np(out.points)[:n], np.asarray(ref.points)[:n], atol=1e-5)


@pytest.mark.parametrize("fn", ["voxel_downsample_morton", "voxel_downsample"])
def test_voxel_centroids_are_exact_float64_means(fn):
    """Each centroid is its voxel's float64 mean rounded once to float32:
    the sums are prefix-sum differences, independent of accumulation order
    (a float scatter-add on the card is not)."""
    pts, mask = _cloud(8, n=4096, extent=12.0)
    res = 0.5
    out = getattr(tvoxel, fn)(tcloud.PointCloud(_t(pts), _t(mask)), res, 4096)
    p = pts[mask].astype(np.float64)
    origin = pts[mask].min(axis=0)
    vox = np.clip(np.floor((pts[mask] - origin) / np.float32(res)), 0, 1023).astype(np.int64)
    _, group = np.unique(vox, axis=0, return_inverse=True)
    group = group.reshape(-1)
    means = np.zeros((group.max() + 1, 3))
    np.add.at(means, group, p)
    means /= np.bincount(group)[:, None]
    np.testing.assert_array_equal(_as_sorted_rows(_np(out.points), _np(out.mask)),
                                  _as_sorted_rows(means.astype(np.float32), np.ones(len(means), bool)))


# --------------------------------------------------------------------- eigh3

def test_eigh3_matches_reference():
    """Eigenvalues to 1e-5; normals compared as |n . n'| (arbitrary sign)."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=(256, 5, 3)).astype(np.float32)
    a[:, :, 2] *= 0.05  # plane-like neighbourhoods
    cov = np.einsum("nki,nkj->nij", a, a) / 5
    vj, ej = jeigh3.smallest_eigvec3(jnp.asarray(cov))
    vt, et = teigh3.smallest_eigvec3(_t(cov))
    np.testing.assert_allclose(_np(et), np.asarray(ej), atol=1e-5, rtol=1e-5)
    dots = np.abs(np.sum(_np(vt) * np.asarray(vj), axis=-1))
    assert dots.min() >= 1 - 1e-4
