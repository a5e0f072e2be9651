"""The stage-attribution tools (``tools_torch/ablate_step.py``,
``profile_stages.py``, ``micro_align.py``, ``micro_linearize.py``) on the
CPU at tiny shapes.

- The full prefix of ``ablate_step`` is ``pipeline.odom_frame`` bit for bit
  (pose, keyframe decision, keyframe count) on a state carried across from
  the JAX runner, with the rescue off and forced, and without the S2S
  polish ("pallas", plain versions).
- Each stop against the JAX package's step on the same carried state and
  scan ("pallas", Pallas interpret mode): the preprocessed scan and the
  submap as sets within 1e-6, normals within 1e-4 on valid rows with the
  same validity, the coarse and full S2S, the S2M (after the rescue) and
  the full step's pose within 1e-4.
- Each tool's ``run`` returns the JAX tool's rows in its order, with
  finite positive times.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench_torch import production_cfg
from direct_lidar_odometry_tpu.odometry import state as jstate
from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner as JaxRunner
from direct_lidar_odometry_tpu.registration import gicp as jgicp
from direct_lidar_odometry_tpu.utils.precision import f32_matmuls
from direct_lidar_odometry_tpu_torch.config import ShapeConfig
from direct_lidar_odometry_tpu_torch.core import cloud as tcloud
from direct_lidar_odometry_tpu_torch.odometry import hulls, pipeline as tpipe, state as tstate
from direct_lidar_odometry_tpu_torch.ops import cuda_cov, morton as tmorton
from tests.test_pallas_e2e import _scans, pallas_cfg, sparse_world  # noqa: F401
from tests.test_torch_e2e import _jax_leaves, _port_cfg
from tools_torch import ablate_step, micro_align, micro_linearize, profile_stages

CARRY_AT = 3  # the carried state is the JAX runner's before this frame
# the tools' own runs: tiny shapes over 2 frames of the small bench world
MICRO = ShapeConfig(
    n_raw=2048, n_scan=1024, n_keyframe=512, max_keyframes=8, max_submap_kf=4,
    n_submap_flat=2048, imu_window=32, grid_table_size=2 ** 11, submap_table_size=2 ** 11,
    cell_cap_1nn=8, cell_cap_knn=32, knn_query_chunk=512, hull_directions=16,
)
TOOL_FRAMES = 2
PROFILE_TIMES = ("ms",)
ABLATE_TIMES = ("ms", "cum_ms")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread, as the other drive tests (a thread pool over
    every core in two xdist workers spins them to a crawl)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def carried(sparse_world):  # noqa: F811
    """The JAX runner's state after CARRY_AT frames (numpy leaves), the
    next scan as the runner puts it on the wire (quantized) and as raw
    points at the raw capacity (dequantized), and the runner, whose
    compiled step the JAX side reuses."""
    cfg = pallas_cfg()
    scans = _scans(sparse_world, CARRY_AT + 1)
    runner = JaxRunner(cfg)
    for t in range(CARRY_AT):
        runner.process_scan(scans[t], float(sparse_world.stamps[t]), sync=True)
    qs = tcloud.quantize_for_transfer(scans[CARRY_AT], cfg.shapes.n_raw)
    raw = tcloud.dequantize(torch.from_numpy(qs.q.view(np.int16)), torch.from_numpy(qs.lo),
                            torch.from_numpy(qs.scale), int(qs.count))
    return dict(cfg=cfg, leaves=_jax_leaves(runner.state), runner=runner, wire=qs,
                points=raw.points, mask=raw.mask)


def _jax_state(leaves):
    kf = jstate.KeyframeStore(**{f: jnp.asarray(leaves[f"keyframes.{f}"])
                                 for f in jstate.KeyframeStore._fields})
    fields = {f: jnp.asarray(leaves[f]) for f in jstate.OdomState._fields
              if f not in ("keyframes", "submap_grid")}
    return jstate.OdomState(keyframes=kf, submap_grid=None, **fields)


def _port_stop(carried, stop, cfg=None):
    cfg = _port_cfg(carried["cfg"]) if cfg is None else cfg
    st = tstate.state_from_numpy(carried["leaves"], "cpu", cfg)
    return ablate_step.prefix(stop, cfg)(st, carried["points"], carried["mask"], torch.eye(4))


@pytest.fixture(scope="module")
def jax_stops(carried):
    """The JAX package's step on the carried state and wire scan, through
    the runner's compiled step with the device hull surrogates (its new
    state holds the scan, its normals and the submap; its pose is the S2M
    transform when S2M found correspondences), and its coarse and full S2S
    on the same scan and normals, as ``pipeline.odom_frame`` wires them."""
    cfg = carried["cfg"]
    k = cfg.shapes.max_keyframes
    st = _jax_state(carried["leaves"])
    qs = carried["wire"]
    new, res = carried["runner"].step_fn(
        st, jnp.asarray(qs.q), jnp.asarray(qs.lo), jnp.asarray(qs.scale), jnp.asarray(qs.count),
        jnp.eye(4, dtype=jnp.float32), jnp.zeros(k, bool), jnp.zeros(k, bool),
        jnp.asarray(False))

    @jax.jit
    @f32_matmuls
    def s2s(state, points, mask, normals, valid):
        shapes = cfg.shapes
        cs = cfg.gicp.s2s_coarse_stride
        while cs > 1 and (shapes.n_scan // cs) % 512 != 0:
            cs -= 1
        coarse_cfg = dataclasses.replace(
            cfg.gicp.s2s,
            max_iterations=min(cfg.gicp.s2s_coarse_max_iterations, cfg.gicp.s2s.max_iterations))
        target = jgicp.make_target(
            state.prev_points[::cs], state.prev_mask[::cs], state.prev_normals[::cs],
            state.prev_normals_valid[::cs], cfg.gicp.s2s.max_correspondence_distance,
            shapes.grid_table_size, backend="pallas")
        src = jgicp.GicpSource(points[::cs], mask[::cs], normals[::cs], valid[::cs])
        coarse = jgicp.align(src, target, jnp.eye(4, dtype=jnp.float32), coarse_cfg,
                             cap=shapes.cell_cap_1nn, backend="pallas")
        target = jgicp.make_target(
            state.prev_points, state.prev_mask, state.prev_normals, state.prev_normals_valid,
            cfg.gicp.s2s.max_correspondence_distance, shapes.grid_table_size, backend="pallas")
        full = jgicp.align(jgicp.GicpSource(points, mask, normals, valid), target,
                           coarse.transform, cfg.gicp.s2s, cap=shapes.cell_cap_1nn,
                           backend="pallas")
        return coarse.transform, full.transform

    # the step donated its state
    coarse, full = s2s(_jax_state(carried["leaves"]), new.prev_points, new.prev_mask, new.prev_normals,
                       new.prev_normals_valid)
    assert cfg.s2s_prior == "imu" and cfg.gicp.s2s_full_polish  # the guess is the identity
    assert int(res.s2m_num_corr) > 100
    return dict(new=jax.tree_util.tree_map(np.asarray, new), pose=np.asarray(res.pose),
                new_keyframe=bool(res.new_keyframe), num_keyframes=int(res.num_keyframes),
                coarse=np.asarray(coarse), full=np.asarray(full))


def _well_conditioned(scan, radius):
    """Rows whose radius neighbourhood's two smallest covariance eigenvalues
    are apart by more than 1e-3 of the largest."""
    clo, chi = tmorton.chunk_aabbs(scan.points, scan.mask, 512)
    m = cuda_cov.radius_moments_sorted(scan.points, scan.mask, clo, chi, scan.points, scan.mask,
                                       radius)
    ev = np.linalg.eigvalsh(cuda_cov.moments_to_cov(m)[0].numpy().astype(np.float64))
    return (ev[:, 1] - ev[:, 0]) > 1e-3 * np.maximum(ev[:, 2], 1e-12)


def _rows(points, mask):
    p = np.asarray(points)[np.asarray(mask)]
    return p[np.lexsort(p.T[::-1])]


@pytest.mark.parametrize("forced_rescue,polish", [(False, True), (True, True), (False, False)],
                         ids=["rescue-off", "rescue-forced", "no-polish"])
def test_full_prefix_is_odom_frame(carried, forced_rescue, polish):
    """``prefix("full")`` and ``pipeline.odom_frame`` on copies of one
    carried state: the same pose, keyframe decision and keyframe count, bit
    for bit; ``forced_rescue`` zeroes the rescue threshold so the rescue
    runs in both; ``polish`` False ends the S2S at the coarse align."""
    cfg = _port_cfg(carried["cfg"])
    gicp_cfg = dataclasses.replace(cfg.gicp, s2s_full_polish=polish)
    if forced_rescue:
        gicp_cfg = dataclasses.replace(gicp_cfg, rescue_s2m_error=0.0)
    cfg = cfg.replace(gicp=gicp_cfg)
    assert ablate_step.stops(cfg) == list(ablate_step.STOPS)
    count, spawned, pose = _port_stop(carried, "full", cfg)
    directions = torch.from_numpy(hulls.fibonacci_directions(cfg.shapes.hull_directions))
    st = tstate.state_from_numpy(carried["leaves"], "cpu", cfg)
    _, res = tpipe.odom_frame(cfg, directions, st, carried["points"], carried["mask"],
                              torch.eye(4))
    assert torch.equal(pose, res.pose)
    assert spawned == res.new_keyframe
    assert torch.equal(count, res.num_keyframes)


@pytest.mark.parametrize("stop", ablate_step.STOPS)
def test_stop_matches_reference(carried, jax_stops, stop):
    out = _port_stop(carried, stop)
    new = jax_stops["new"]
    if stop == "preprocess":
        assert int(out.mask.sum()) == int(new.prev_mask.sum()) > 0
        np.testing.assert_allclose(_rows(out.points, out.mask),
                                   _rows(new.prev_points, new.prev_mask), atol=1e-6)
    elif stop == "normals":
        scan = _port_stop(carried, "preprocess")
        # rows matched by their points (order within equal keys is unspecified)
        mine = np.lexsort(scan.points.numpy().T[::-1])
        ref = np.lexsort(new.prev_points.T[::-1])
        np.testing.assert_allclose(scan.points.numpy()[mine], new.prev_points[ref], atol=1e-6)
        valid = out.valid.numpy()[mine]
        np.testing.assert_array_equal(valid, new.prev_normals_valid[ref])
        # well-conditioned neighbourhoods only, as test_torch_kernels: a
        # near-isotropic neighbourhood's smallest eigenvector is not
        # determined by the data
        sep = _well_conditioned(scan, 3.0 * carried["cfg"].preprocessing.voxel_scan.res)[mine]
        both = valid & sep
        assert both.sum() > 0.9 * valid.sum() > 100
        np.testing.assert_allclose(out.normals.numpy()[mine][both],
                                   new.prev_normals[ref][both], atol=1e-4)
    elif stop in ("s2s_coarse", "s2s"):
        want = jax_stops["coarse" if stop == "s2s_coarse" else "full"]
        np.testing.assert_allclose(out.transform.numpy(), want, atol=1e-4)
    elif stop == "submap":
        assert int(out.mask.sum()) == int(new.submap_mask.sum()) > 0
        np.testing.assert_allclose(_rows(out.points, out.mask),
                                   _rows(new.submap_points, new.submap_mask), atol=1e-6)
    elif stop == "s2m":
        assert int(out.num_correspondences) > 100
        np.testing.assert_allclose(out.transform.numpy(), jax_stops["pose"], atol=1e-4)
    else:
        count, spawned, pose = out
        np.testing.assert_allclose(pose.numpy(), jax_stops["pose"], atol=1e-4)
        assert spawned == jax_stops["new_keyframe"]
        assert int(count) == jax_stops["num_keyframes"]


def _micro_cfg(backend):
    return production_cfg(True).replace(shapes=MICRO, nn_backend=backend)


def _times_ok(rows, keys):
    return all(math.isfinite(r[k]) and r[k] > 0 for r in rows for k in keys)


def test_profile_stages_rows():
    rows = profile_stages.run(small=True, device="cpu", cfg=_micro_cfg("pallas"),
                               frames=TOOL_FRAMES, n=1)
    assert tuple(r["stage"] for r in rows) == profile_stages.STAGES
    assert _times_ok(rows, PROFILE_TIMES)
    # the step's reads: one each for the submap flag, the rescue trigger
    # and the spawn decision, besides GICP's
    assert rows[-1]["host_reads"] >= 3
    assert isinstance(rows[profile_stages.STAGES.index("keyframe maybe_spawn")]["spawned"], bool)


def test_ablate_step_rows():
    cfg = _micro_cfg("pallas")
    rows = ablate_step.run(small=True, device="cpu", cfg=cfg, frames=TOOL_FRAMES, n=1)
    names = [r["stop"] for r in rows]
    assert names == ["dispatch floor", *ablate_step.stops(cfg), "odom_frame"]
    assert "s2s_coarse" in names
    assert _times_ok(rows, ABLATE_TIMES)
    assert all(math.isfinite(r["delta_ms"]) for r in rows)
    # the full prefix reads the host and launches as the step does (on the
    # CPU the plain versions of K1 and K2)
    full, step = rows[-2], rows[-1]
    assert full["host_reads"] == step["host_reads"] >= 3
    assert full["launches"] == step["launches"]
    assert step["launches"]["K1"]["plain"] > 0 and step["launches"]["K2"]["plain"] > 0
    assert all(rows[-1]["full_matches_step"][k]
               for k in ("pose_equal", "new_keyframe_equal", "count_equal"))


def test_micro_align_rows():
    rows = micro_align.run(device="cpu", cfg=_micro_cfg("pallas"), frames=TOOL_FRAMES, n=1,
                           small=True)
    assert tuple(r["stage"] for r in rows) == micro_align.ROWS
    assert _times_ok(rows, PROFILE_TIMES)
    # on the CPU the searches and normals run the plain versions only
    assert rows[0]["launches"]["K2"] == {"cuda": 0, "plain": 1}
    normals = rows[micro_align.ROWS.index("scan normals")]
    assert normals["launches"]["K1"] == {"cuda": 0, "plain": 1}
    chunks = rows[0]["candidate_chunks"]
    assert 0 < chunks["mean"] <= chunks["max"] <= chunks["chunks"] == MICRO.n_scan // 512



def test_micro_linearize_rows():
    rows = micro_linearize.run(ns=1024, nt=2048, device="cpu", n=1)
    assert tuple(r["stage"] for r in rows) == micro_linearize.ROWS
    assert _times_ok(rows, PROFILE_TIMES)
    fused = [r["launches"]["K3"]["plain"] for r in rows]
    assert fused == [0, 1, 1, 0]
    assert [r["launches"]["K2"]["plain"] for r in rows] == [1, 0, 0, 1]
