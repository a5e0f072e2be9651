"""Parity of the port's odometry modules (adaptive, hulls, keyframes, submap,
state) with the JAX package, on identical numpy inputs."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.config import DloConfig, ShapeConfig
from direct_lidar_odometry_tpu.odometry import adaptive as jadapt, hulls as jhulls
from direct_lidar_odometry_tpu.odometry import keyframes as jkf, state as jstate, submap as jsub
from direct_lidar_odometry_tpu_torch import config as tcfg
from direct_lidar_odometry_tpu_torch.odometry import adaptive as tadapt, hulls as thulls
from direct_lidar_odometry_tpu_torch.odometry import keyframes as tkf, state as tstate, submap as tsub


def _t(x):
    return torch.from_numpy(np.array(x, copy=True))


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _ring(seed, k=16, count=12):
    """Keyframe positions along a wandering planar path (numpy)."""
    rng = np.random.default_rng(seed)
    pos = np.zeros((k, 3), np.float32)
    pos[:count] = np.cumsum(rng.normal(scale=1.5, size=(count, 3)) * [1, 1, 0.05], axis=0)
    mask = np.arange(k) < count
    return pos, mask


# ------------------------------------------------------------------ adaptive

@pytest.mark.parametrize("prev", [-1.0, 3.0, 12.0])
def test_spaciousness_matches_reference(prev):
    rng = np.random.default_rng(1)
    pts = rng.normal(scale=8.0, size=(8192, 3)).astype(np.float32)
    mask = rng.random(8192) < 0.8
    sj = jadapt.update_spaciousness(jnp.float32(prev), jnp.asarray(pts), jnp.asarray(mask))
    st = tadapt.update_spaciousness(torch.tensor(prev), _t(pts), _t(mask))
    np.testing.assert_allclose(float(st), float(sj), rtol=1e-6)
    for s in (2.0, 5.0, 7.5, 10.0, 15.0, 20.0, 30.0):
        assert float(tadapt.keyframe_thresh_from_spaciousness(torch.tensor(s))) == float(
            jadapt.keyframe_thresh_from_spaciousness(jnp.float32(s)))


# --------------------------------------------------------------------- hulls

@pytest.mark.parametrize("seed,count", [(0, 3), (1, 12), (2, 16)])
def test_hull_surrogates_match_reference(seed, count):
    pos, mask = _ring(seed, count=count)
    d = jhulls.fibonacci_directions(16)
    np.testing.assert_array_equal(thulls.fibonacci_directions(16), d)
    cj = jhulls.convex_membership(jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(d))
    ct = thulls.convex_membership(_t(pos), _t(mask), _t(d))
    np.testing.assert_array_equal(_np(ct), np.asarray(cj))
    aj = jhulls.concave_membership(jnp.asarray(pos), jnp.asarray(mask), jnp.asarray(d),
                                   jnp.float32(1.0))
    at = thulls.concave_membership(_t(pos), _t(mask), _t(d), torch.tensor(1.0))
    np.testing.assert_array_equal(_np(at), np.asarray(aj))


# -------------------------------------------------------------------- submap

@pytest.mark.parametrize("k", [1, 3, 5, 40])
def test_k_smallest_members_ties(k):
    """Every element <= the kth smallest survives, ties included."""
    d2 = np.array([4.0, 1.0, 1.0, 9.0, 1.0, 2.0, 7.0, 2.0], np.float32)
    mask = np.array([1, 1, 1, 1, 0, 1, 1, 1], bool)
    ref = np.asarray(jsub.k_smallest_members(jnp.asarray(d2), jnp.asarray(mask), k))
    np.testing.assert_array_equal(_np(tsub.k_smallest_members(_t(d2), _t(mask), k)), ref)


def _kf_store_pair(pos, count, nk=8):
    """The same keyframe ring in both packages (clouds are placeholders)."""
    k = pos.shape[0]
    rng = np.random.default_rng(9)
    quats = rng.normal(size=(k, 4)).astype(np.float32)
    quats /= np.linalg.norm(quats, axis=1, keepdims=True)
    leaves = dict(
        positions=pos, quats=quats,
        points=rng.normal(size=(k, nk, 3)).astype(np.float32),
        masks=np.ones((k, nk), bool),
        normals=np.tile(np.array([0, 0, 1], np.float32), (k, nk, 1)),
        normals_valid=np.ones((k, nk), bool),
        count=np.int32(count), seq=np.arange(k, dtype=np.int32), health=np.zeros(k, np.float32),
    )
    j = jstate.KeyframeStore(**{f: jnp.asarray(v) for f, v in leaves.items()})
    t = tstate.KeyframeStore(**{f: _t(v) for f, v in leaves.items()})
    return j, t


@pytest.mark.parametrize("seed,max_submap_kf", [(3, 32), (4, 4), (5, 2)])
def test_select_submap_keyframes_matches_reference(seed, max_submap_kf):
    """Member set (with the hard cap) and change flag equal; device hull
    surrogates and host masks both."""
    pos, mask = _ring(seed, k=32, count=30)
    shapes = ShapeConfig(max_keyframes=32, max_submap_kf=max_submap_kf, hull_directions=16)
    jc = DloConfig().replace(shapes=shapes)
    tc = tcfg.DloConfig().replace(shapes=tcfg.ShapeConfig(**shapes.__dict__))
    kj, kt = _kf_store_pair(pos, 30)
    d = jhulls.fibonacci_directions(16)
    q = pos[7] + np.float32(0.3)
    prev = np.zeros(32, bool)
    prev[:3] = True
    host = (np.arange(32) % 3 == 0, np.arange(32) % 4 == 0)
    for hull in (None, host):
        jh = None if hull is None else (jnp.asarray(hull[0]), jnp.asarray(hull[1]), jnp.asarray(True))
        th = None if hull is None else (_t(hull[0]), _t(hull[1]), True)
        sj = jsub.select_submap_keyframes(kj, jnp.asarray(prev), jnp.asarray(q), jnp.float32(2.0),
                                          jc, jnp.asarray(d), jh)
        st = tsub.select_submap_keyframes(kt, _t(prev), _t(q), torch.tensor(2.0), tc, _t(d), th)
        np.testing.assert_array_equal(_np(st.members), np.asarray(sj.members))
        assert bool(st.changed) == bool(sj.changed)
        assert _np(st.members).sum() <= max_submap_kf


# ----------------------------------------------------------------- keyframes

@pytest.mark.parametrize("count", [0, 5, 16])
def test_keyframe_decide_matches_reference(count):
    pos, _ = _ring(6, count=max(count, 1))
    kj, kt = _kf_store_pair(pos, count)
    for p in (pos[0] + 0.2, pos[0] + 3.0):
        qt = np.array([0.9, 0.1, 0.3, 0.0], np.float32)
        qt /= np.linalg.norm(qt)
        dj = jkf.decide(kj, jnp.asarray(p), jnp.asarray(qt), jnp.float32(1.0), 45.0)
        dt = tkf.decide(kt, _t(p), _t(qt), torch.tensor(1.0), 45.0)
        assert bool(dt.spawn) == bool(dj.spawn)
        assert int(dt.num_nearby) == int(dj.num_nearby)


@pytest.mark.parametrize("count", [3, 16])
def test_keyframe_insert_and_evict_match_reference(count):
    """Append below capacity; at capacity the densest-pair rule picks the
    same slot, and the ring is written in place."""
    pos, _ = _ring(7, count=16)
    pos[11] = pos[4] + 0.01  # an unambiguous densest pair
    kj, kt = _kf_store_pair(pos, count)
    rng = np.random.default_rng(8)
    cloud = rng.normal(size=(8, 3)).astype(np.float32)
    cmask = np.ones(8, bool)
    nrm = np.tile(np.array([1, 0, 0], np.float32), (8, 1))
    new_pos = pos[4] + np.array([0.5, 0.0, 0.0], np.float32)
    quat = np.array([1, 0, 0, 0], np.float32)
    from direct_lidar_odometry_tpu.core.cloud import PointCloud as JCloud
    from direct_lidar_odometry_tpu.registration.covariance import Normals as JNormals
    from direct_lidar_odometry_tpu_torch.core.cloud import PointCloud as TCloud
    from direct_lidar_odometry_tpu_torch.registration.covariance import Normals as TNormals

    outj, evj, slotj = jkf.insert(kj, jnp.asarray(new_pos), jnp.asarray(quat),
                                  JCloud(jnp.asarray(cloud), jnp.asarray(cmask)),
                                  JNormals(jnp.asarray(nrm), jnp.asarray(cmask)),
                                  seq=jnp.int32(99), health=jnp.float32(0.25))
    positions_before = kt.positions
    outt, evt, slott = tkf.insert(kt, _t(new_pos), _t(quat), TCloud(_t(cloud), _t(cmask)),
                                  TNormals(_t(nrm), _t(cmask)),
                                  seq=torch.tensor(99, dtype=torch.int32),
                                  health=torch.tensor(0.25))
    assert bool(evt) == bool(evj) == (count == 16)
    assert int(slott) == int(slotj)
    assert outt.positions is positions_before  # in place
    for f in jstate.KeyframeStore._fields:
        np.testing.assert_array_equal(_np(getattr(outt, f)), np.asarray(getattr(outj, f)), err_msg=f)


# --------------------------------------------------------------------- state

def test_state_numpy_round_trip():
    cfg = tcfg.DloConfig().replace(shapes=tcfg.ShapeConfig(
        n_scan=1024, n_keyframe=512, max_keyframes=4, max_submap_kf=2, n_submap_flat=1024))
    st = tstate.empty_state(cfg, device="cpu")
    leaves = tstate.state_to_numpy(st)
    back = tstate.state_to_numpy(tstate.state_from_numpy(leaves, "cpu"))
    assert leaves.keys() == back.keys()
    for k in leaves:
        np.testing.assert_array_equal(back[k], leaves[k], err_msg=k)
        assert back[k].dtype == leaves[k].dtype
    with pytest.raises(KeyError):
        tstate.state_from_numpy({k: v for k, v in leaves.items() if k != "pose"}, "cpu")


# -------------------------------------------------------------------- runner

def test_runner_refuses_missing_cuda(monkeypatch):
    """device="cuda" without CUDA raises rather than moving to the CPU."""
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OdometryRunner(tcfg.DloConfig(nn_backend="pallas"), device="cuda")


@pytest.mark.parametrize("override", [
    {"host_preprocess": True}, {"map.carry_intensity": True}, {"nn_backend": "hashgrid"},
])
def test_runner_refuses_unported_options(override):
    """The options the port once refused construct a runner now (host
    preprocessing stays on only with the scan voxel filter); an unknown
    backend is still refused."""
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner

    cfg = tcfg.load_config(None, override)
    runner = OdometryRunner(cfg, device="cpu")
    assert runner.cfg == cfg
    no_voxel = tcfg.load_config(None, {**override, "preprocessing.voxel_scan.use": False})
    assert not OdometryRunner(no_voxel, device="cpu").cfg.host_preprocess
    with pytest.raises(ValueError, match="unknown nn_backend"):
        OdometryRunner(cfg.replace(nn_backend="kdtree"), device="cpu")


@pytest.mark.parametrize("override", [
    {"imu.use": True}, {"posegraph.use": True}, {"gravity_align": True},
])
def test_runner_constructs_with_ported_options(override):
    """The IMU prior, gravity alignment and loop closure are ported; the
    shipped config (posegraph on) constructs as well."""
    from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner

    runner = OdometryRunner(tcfg.load_config(None, override), device="cpu")
    assert (runner.imu is not None) == runner.cfg.imu.use
    shipped = Path(__file__).resolve().parent.parent / "cfg" / "tpu_dlo.yaml"
    OdometryRunner(tcfg.load_config(str(shipped), override), device="cpu")
