"""Slice-level parity on the "brute" and "hashgrid" backends: the port's
runner against the JAX package's runner on the same scans, one step of
both pipelines from a state carried across from the reference (hash grid
included), a forced loop-closure round on "hashgrid", and a resume of the
port from a checkpoint the JAX package wrote on "hashgrid".

One JAX reference run per backend, shared by the module.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.odometry import loopclosure as jlc, state as jstate
from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner as JaxRunner
from direct_lidar_odometry_tpu.ops import hashgrid as jhg
from direct_lidar_odometry_tpu.utils import checkpoint as jckpt
from direct_lidar_odometry_tpu_torch import config as tcfg
from direct_lidar_odometry_tpu_torch.core import cloud as tcloud
from direct_lidar_odometry_tpu_torch.odometry import hulls, loopclosure as tlc
from direct_lidar_odometry_tpu_torch.odometry import pipeline as tpipe, state as tstate
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
from direct_lidar_odometry_tpu_torch.ops import cuda_cov, cuda_gicp, cuda_nn
from direct_lidar_odometry_tpu_torch.utils import checkpoint as tckpt
from tests.test_pallas_e2e import _ate, _scans, pallas_cfg, sparse_world  # noqa: F401
from tests.test_torch_loopclosure import _wide_gate_store

N_FRAMES = 6
CARRY_AT = 3  # the state carried across is the one before this frame
BACKENDS = ["brute", "hashgrid"]


def _jax_leaves(state) -> dict[str, np.ndarray]:
    """Numpy leaves by field path, the hash grid's as ``submap_grid.<field>``."""
    out = {}
    for name in state._fields:
        value = getattr(state, name)
        if isinstance(value, tuple):
            out.update({f"{name}.{k}": np.asarray(v) for k, v in value._asdict().items()})
        elif value is not None:
            out[name] = np.asarray(value)
    return out


def _jax_state(leaves):
    kf = jstate.KeyframeStore(**{f: jnp.asarray(leaves[f"keyframes.{f}"])
                                 for f in jstate.KeyframeStore._fields})
    grid = None
    if "submap_grid.points" in leaves:
        grid = jhg.HashGrid(**{f: jnp.asarray(leaves[f"submap_grid.{f}"])
                               for f in jhg.HashGrid._fields})
    fields = {f: jnp.asarray(leaves[f]) for f in jstate.OdomState._fields
              if f not in ("keyframes", "submap_grid")}
    return jstate.OdomState(keyframes=kf, submap_grid=grid, **fields)


def _port_cfg(jax_cfg):
    return tcfg.config_from_dict(dataclasses.asdict(jax_cfg))


def _reset_launches():
    for mod in (cuda_nn, cuda_cov, cuda_gicp):
        mod.reset_launches()


def _no_kernel_route():
    """Neither a hand kernel nor its plain version ran."""
    counters = (cuda_nn.launches, cuda_nn.mxu_launches, cuda_nn.exhaustive_launches,
                cuda_cov.launches, cuda_cov.exhaustive_launches, cuda_gicp.launches)
    return all(sum(c.values()) == 0 for c in counters)


@pytest.fixture(scope="module")
def references(sparse_world, tmp_path_factory):  # noqa: F811
    """backend -> the JAX runner's run over N_FRAMES scans: trajectory, ATE,
    keyframe decisions, the state before CARRY_AT, a checkpoint of the
    final state, and the pose of one more frame stepped after it."""
    cache = {}
    scans = _scans(sparse_world, N_FRAMES + 1)

    def get(backend):
        if backend not in cache:
            cfg = pallas_cfg(nn_backend=backend)
            runner = JaxRunner(cfg)
            carried, new_kf = None, []
            for t, s in enumerate(scans[:N_FRAMES]):
                if t == CARRY_AT:
                    carried = _jax_leaves(runner.state)
                res = runner.process_scan(s, float(sparse_world.stamps[t]), sync=True)
                new_kf.append(None if res is None else bool(res.new_keyframe))
            ckpt = str(tmp_path_factory.mktemp(backend) / "ckpt.npz")
            jckpt.save_state(ckpt, runner.state, extra={"prev_stamp": runner.prev_stamp})
            final = _jax_leaves(runner.state)
            traj, ate = runner.trajectory(), _ate(runner, sparse_world)
            nxt = runner.process_scan(scans[N_FRAMES], float(sparse_world.stamps[N_FRAMES]),
                                      sync=True)
            cache[backend] = dict(cfg=cfg, scans=scans, runner=runner, traj=traj, ate=ate,
                                  new_kf=new_kf, carried=carried, final=final, ckpt=ckpt,
                                  next_pose=np.asarray(nxt.pose))
        return cache[backend]

    return get


@pytest.mark.parametrize("backend", BACKENDS)
def test_runner_trajectory_matches_reference(references, sparse_world, backend):  # noqa: F811
    """6-frame poses within 5e-3 m, ATE < 0.05 m for both, the same keyframe
    decisions, S2M correspondences > 100, and no hand kernel nor plain
    version ran (the backend does not go through the pruned-kernel route)."""
    ref = references(backend)
    runner = OdometryRunner(_port_cfg(ref["cfg"]), device="cpu")
    _reset_launches()
    new_kf = []
    for t, s in enumerate(ref["scans"][:N_FRAMES]):
        res = runner.process_scan(s, float(sparse_world.stamps[t]), sync=True)
        new_kf.append(None if res is None else res.new_keyframe)
        if res is not None:
            assert int(res.s2m_num_corr) > 100
    assert _no_kernel_route()
    est = runner.trajectory()
    assert est.shape == ref["traj"].shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(est, ref["traj"], atol=5e-3)
    assert _ate(runner, sparse_world) < 0.05 and ref["ate"] < 0.05
    assert new_kf == ref["new_kf"]
    assert (runner.state.submap_grid is not None) == (backend == "hashgrid")


@pytest.mark.parametrize("backend", BACKENDS)
def test_one_step_from_carried_state_matches_reference(references, backend):
    """Step both pipelines once from the reference's state before CARRY_AT
    (its S2M hash grid carried across on "hashgrid"), on identical wire
    input: pose within 1e-4, S2M correspondences within 2."""
    ref = references(backend)
    cfg, leaves = ref["cfg"], ref["carried"]
    assert ("submap_grid.start" in leaves) == (backend == "hashgrid")
    scan = ref["scans"][CARRY_AT]
    qs = tcloud.quantize_for_transfer(scan, cfg.shapes.n_raw)
    k = cfg.shapes.max_keyframes
    no_hull = (jnp.zeros(k, bool), jnp.zeros(k, bool), jnp.asarray(False))
    _, rj = ref["runner"].step_fn(
        _jax_state(leaves), jnp.asarray(qs.q), jnp.asarray(qs.lo), jnp.asarray(qs.scale),
        jnp.asarray(qs.count), jnp.eye(4, dtype=jnp.float32), *no_hull)

    pcfg = _port_cfg(cfg)
    tst = tstate.state_from_numpy(leaves, "cpu", pcfg)
    if backend == "hashgrid":
        np.testing.assert_array_equal(tst.submap_grid.start.numpy(), leaves["submap_grid.start"])
    raw = tcloud.dequantize(torch.from_numpy(qs.q.view(np.int16)), torch.from_numpy(qs.lo),
                            torch.from_numpy(qs.scale), int(qs.count))
    directions = torch.from_numpy(hulls.fibonacci_directions(pcfg.shapes.hull_directions))
    new_state, rt = tpipe.odom_frame(
        pcfg, directions, tst, raw.points, raw.mask, torch.eye(4),
        (torch.zeros(k, dtype=torch.bool), torch.zeros(k, dtype=torch.bool), False),
    )
    np.testing.assert_allclose(rt.pose.numpy(), np.asarray(rj.pose), atol=1e-4)
    assert rt.new_keyframe == bool(rj.new_keyframe)
    assert abs(int(rt.s2m_num_corr) - int(rj.s2m_num_corr)) <= 2
    assert int(new_state.frame_idx) == int(leaves["frame_idx"]) + 1


def test_forced_loop_closure_round_on_hashgrid():
    """One loop-closure round (candidates, hash-grid loop registration at
    the wide gate, refinement, re-anchoring) on a drifted two-keyframe ring:
    the same counts, keyframe poses and re-anchored clouds as the JAX
    package's round within 1e-4."""
    leaves, cfg = _wide_gate_store()
    cfg = cfg.replace(nn_backend="hashgrid", posegraph=dataclasses.replace(
        cfg.posegraph, use=True, min_index_gap=1))
    pcfg = _port_cfg(cfg)
    jkf = jstate.KeyframeStore(**{f: jnp.asarray(v) for f, v in leaves.items()})
    jnew, jinfo = jlc.refine_and_reanchor(jstate.empty_state(cfg)._replace(keyframes=jkf), cfg,
                                          "hashgrid")
    tkf = tstate.KeyframeStore(**{f: torch.from_numpy(np.array(v)) for f, v in leaves.items()})
    tst = tstate.empty_state(pcfg, device="cpu")._replace(keyframes=tkf)
    _reset_launches()
    tnew, tinfo = tlc.refine_and_reanchor(tst, pcfg, "hashgrid")
    assert _no_kernel_route()
    assert tinfo.n_candidates == int(jinfo.n_candidates) == 1
    assert tinfo.n_accepted == int(jinfo.n_accepted) == 1
    for f in ("positions", "quats", "points"):
        np.testing.assert_allclose(getattr(tnew.keyframes, f).numpy(),
                                   np.asarray(getattr(jnew.keyframes, f)), atol=1e-4, err_msg=f)
    moved = np.abs(tnew.keyframes.positions.numpy() - leaves["positions"]).max()
    assert moved > 1e-3


def test_resume_from_reference_checkpoint_on_hashgrid(references, sparse_world, tmp_path):  # noqa: F811
    """The port loads the JAX package's hashgrid checkpoint with its hash
    grid bit for bit; a file without the grid gets it rebuilt from the
    loaded submap, equal to the reference's; the resumed runner's next
    frame is the reference's within 1e-4."""
    ref = references("hashgrid")
    pcfg = _port_cfg(ref["cfg"])
    state, extra = tckpt.load_state(ref["ckpt"], pcfg, "cpu")
    grid_keys = [k for k in ref["final"] if k.startswith("submap_grid.")]
    assert len(grid_keys) == 7
    for key in grid_keys:
        got = getattr(state.submap_grid, key.split(".", 1)[1]).numpy()
        np.testing.assert_array_equal(got, ref["final"][key], err_msg=key)

    data = dict(np.load(ref["ckpt"]))
    stripped = str(tmp_path / "no_grid.npz")
    np.savez_compressed(stripped, **{k: v for k, v in data.items()
                                     if not k.startswith("state/submap_grid/")})
    rebuilt, _ = tckpt.load_state(stripped, pcfg, "cpu")
    for key in grid_keys:
        got = getattr(rebuilt.submap_grid, key.split(".", 1)[1]).numpy()
        np.testing.assert_array_equal(got, ref["final"][key], err_msg=key)

    runner = OdometryRunner(pcfg, device="cpu")
    runner.state, runner.prev_stamp = rebuilt, extra["prev_stamp"]
    res = runner.process_scan(ref["scans"][N_FRAMES], float(sparse_world.stamps[N_FRAMES]),
                              sync=True)
    assert int(res.s2m_num_corr) > 100
    np.testing.assert_allclose(res.pose.numpy(), ref["next_pose"], atol=1e-4)
