"""Slice-level parity: the port's runner against the JAX package's runner
(pallas backend, interpret mode) on the same scans, and one step of both
pipelines from a state carried across from the reference.

The JAX reference run is computed once per module.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.odometry import pipeline as jpipe, state as jstate
from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner as JaxRunner
from direct_lidar_odometry_tpu_torch import config as tcfg
from direct_lidar_odometry_tpu_torch.core import cloud as tcloud
from direct_lidar_odometry_tpu_torch.odometry import hulls, pipeline as tpipe, state as tstate
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_nn
from tests.test_pallas_e2e import _ate, _scans, pallas_cfg, sparse_world  # noqa: F401

N_FRAMES = 6
CARRY_AT = 3  # the state carried across is the one before this frame


def _jax_leaves(state) -> dict[str, np.ndarray]:
    out = {}
    for name in state._fields:
        value = getattr(state, name)
        if name == "keyframes":
            out.update({f"keyframes.{k}": np.asarray(v) for k, v in value._asdict().items()})
        elif value is not None:  # the pallas backend carries no submap_grid
            out[name] = np.asarray(value)
    return out


def _port_cfg(jax_cfg):
    return tcfg.config_from_dict(dataclasses.asdict(jax_cfg))


@pytest.fixture(scope="module")
def reference(sparse_world):  # noqa: F811
    cfg = pallas_cfg()
    scans = _scans(sparse_world, N_FRAMES)
    runner = JaxRunner(cfg)
    carried = None
    new_kf = []
    for t, s in enumerate(scans):
        if t == CARRY_AT:
            carried = _jax_leaves(runner.state)
        res = runner.process_scan(s, float(sparse_world.stamps[t]), sync=True)
        new_kf.append(None if res is None else bool(res.new_keyframe))
    return dict(cfg=cfg, scans=scans, runner=runner, traj=runner.trajectory(),
                ate=_ate(runner, sparse_world), new_kf=new_kf, carried=carried)


def test_runner_trajectory_matches_reference(reference, sparse_world):  # noqa: F811
    """6-frame poses within 5e-3 m (the chunked-vs-per-frame precedent of
    test_pallas_e2e), ATE < 0.05 m for both, the same keyframe decisions."""
    runner = OdometryRunner(_port_cfg(reference["cfg"]), device="cpu")
    cuda_nn.reset_launches()
    cuda_cov.reset_launches()
    new_kf = []
    for t, s in enumerate(reference["scans"]):
        res = runner.process_scan(s, float(sparse_world.stamps[t]), sync=True)
        new_kf.append(None if res is None else res.new_keyframe)
        if res is not None:
            assert int(res.s2m_num_corr) > 100
    est = runner.trajectory()
    assert est.shape == reference["traj"].shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(est, reference["traj"], atol=5e-3)
    assert _ate(runner, sparse_world) < 0.05
    assert reference["ate"] < 0.05
    assert new_kf == reference["new_kf"]
    # on the CPU every search went through the plain versions
    assert cuda_nn.launches["plain"] > 0 and cuda_nn.launches["cuda"] == 0
    assert cuda_cov.launches["plain"] > 0 and cuda_cov.launches["cuda"] == 0


@pytest.mark.parametrize("forced_rescue", [False, True])
def test_one_step_from_carried_state_matches_reference(reference, forced_rescue):
    """Step both pipelines once from the reference's state after CARRY_AT
    frames, on identical wire-format input: poses within 1e-4. The second
    case zeroes the rescue threshold, so the staged-gate rescue (wide-gate
    re-register + re-refine) runs in both."""
    cfg = reference["cfg"]
    step_fn = reference["runner"].step_fn
    if forced_rescue:
        cfg = cfg.replace(gicp=dataclasses.replace(cfg.gicp, rescue_s2m_error=0.0))
        _, step_fn = jpipe.make_quantized_step_fns(cfg)
    leaves = reference["carried"]
    scan = reference["scans"][CARRY_AT]
    qs = tcloud.quantize_for_transfer(scan, cfg.shapes.n_raw)
    k = cfg.shapes.max_keyframes

    jkf = jstate.KeyframeStore(**{f: jnp.asarray(leaves[f"keyframes.{f}"])
                                  for f in jstate.KeyframeStore._fields})
    jfields = {f: jnp.asarray(leaves[f]) for f in jstate.OdomState._fields
               if f not in ("keyframes", "submap_grid")}
    jst = jstate.OdomState(keyframes=jkf, submap_grid=None, **jfields)
    no_hull = (jnp.zeros(k, bool), jnp.zeros(k, bool), jnp.asarray(False))
    _, rj = step_fn(
        jst, jnp.asarray(qs.q), jnp.asarray(qs.lo), jnp.asarray(qs.scale),
        jnp.asarray(qs.count), jnp.eye(4, dtype=jnp.float32), *no_hull)

    pcfg = _port_cfg(cfg)
    tst = tstate.state_from_numpy(leaves, "cpu")
    raw = tcloud.dequantize(torch.from_numpy(qs.q.view(np.int16)), torch.from_numpy(qs.lo),
                            torch.from_numpy(qs.scale), int(qs.count))
    directions = torch.from_numpy(hulls.fibonacci_directions(pcfg.shapes.hull_directions))
    new_state, rt = tpipe.odom_frame(
        pcfg, directions, tst, raw.points, raw.mask, torch.eye(4),
        (torch.zeros(k, dtype=torch.bool), torch.zeros(k, dtype=torch.bool), False),
    )
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-4)
    assert rt.new_keyframe == bool(rj.new_keyframe)
    assert rt.s2m_iterations == int(rj.s2m_iterations)
    assert abs(int(rt.s2m_num_corr) - int(rj.s2m_num_corr)) <= 2
    assert int(new_state.frame_idx) == int(leaves["frame_idx"]) + 1
