"""JAX parity of the long-drive regime: a closed loop driven past keyframe
ring saturation, with periodic loop-closure rounds and a forced one.

The same scans go through the JAX package's ``OdometryRunner`` and the
port's (``device="cpu"``, through ``tools_torch/long_validation.py``'s
``drive``), both on "hashgrid", at the JAX tools' small shapes: the first
60 frames of a 72-frame closed loop sized by
``tools/staleness_sweep.py``'s radius rule (0.96 m a frame), an 8-slot
ring with keyframes every 1 m (adaptive off, as ``tools/hull_ab.py``), so
a keyframe spawns every other frame and the ring fills at frame 14. The
trigger checks every 4 frames and needs 5 keyframes (``min_index_gap`` 3)
and 3 new ones (``refine_every_kf``): one round runs before the ring fills
(frame 8), one with it full (frame 16), and none after, because the
keyframe count stops at capacity (JAX ``keyframes.py:162``,
``runner.py:499``). One forced round ends the drive.

Tolerances: keyframe decisions, ring slots, evictions, round counts and
the final ring's ``seq`` identical; the rounds of the drive within 1e-3
relative in graph error; poses within 5e-3 m (the backends' 6-frame
parity tolerance). The forced round at the end registers loop edges
between drifted keyframes from an identity guess, and GICP stops once a
step is below ``transformation_epsilon`` (1 cm), so the drive's
millimetres of pose difference may end an edge's registration one step
earlier or later (graph error 5e-3 apart on the drive): the forced
round's counts are compared on the drive, and its graph error (1e-3
relative) and keyframe-map error (1e-3 m) on the JAX drive's own final
state carried into the port.

One JAX drive, shared by the module.
"""

import dataclasses

import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu.config import DloConfig, ShapeConfig
from direct_lidar_odometry_tpu.io import synthetic as jsyn
from direct_lidar_odometry_tpu.odometry.runner import OdometryRunner as JaxRunner
from direct_lidar_odometry_tpu_torch import config as tcfg
from direct_lidar_odometry_tpu_torch.odometry import state as tstate
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner
from tests.test_torch_backends_e2e import _jax_leaves
from tools_torch import long_validation as lv

WORLD_FRAMES = 72
N_FRAMES = 60
RING = 8
POSE_TOL = 5e-3
GRAPH_REL = 1e-3
MAP_TOL = 1e-3

@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread: the drives run thousands of small tensor ops a
    frame, and under the parallel test run a thread pool over every core
    in two such workers spins them to a crawl (this file and
    ``test_torch_tools.py`` side by side took over 20 minutes that way)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)



def _config() -> DloConfig:
    base = DloConfig().replace(s2s_prior="constant_velocity", nn_backend="hashgrid")
    return base.replace(
        shapes=ShapeConfig(max_keyframes=RING, **lv.SMALL_SHAPES),
        keyframe=dataclasses.replace(base.keyframe, thresh_dist=1.0),
        adaptive=dataclasses.replace(base.adaptive, use=False),
        posegraph=dataclasses.replace(base.posegraph, use=True, check_every=4,
                                      refine_every_kf=3, min_index_gap=3, loop_radius=12.0),
    )


def _jax_map_error(state, gt_pos) -> float:
    kf = state.keyframes
    n = int(kf.count)
    seq = np.asarray(kf.seq[:n])
    return float(np.linalg.norm(np.asarray(kf.positions[:n]) - gt_pos[seq], axis=-1).mean())


@pytest.fixture(scope="module")
def drives():
    """Both drives over the same scans, and the port's forced round on the
    JAX drive's final state."""
    speed = max(0.4, 2 * np.pi * 11.0 / WORLD_FRAMES)
    world = jsyn.make_urban_world(np.random.default_rng(5), n_frames=WORLD_FRAMES, speed=speed,
                                  closed_loop=True, z_amplitude=1.0, n_dynamic=0, corridor=7.0)
    beams = jsyn.BeamModel(n_beams=32, n_azimuth=512)
    scans = [jsyn.render_scan(world, t, np.random.default_rng(100 + t), max_range=13.0,
                              max_points=8192, beams=beams) for t in range(N_FRAMES)]
    gt_pos = lv.gt_poses(world)[:, :3, 3]
    cfg = _config()

    runner = JaxRunner(cfg)
    decisions = []
    for t, s in enumerate(scans):
        r = runner.process_scan(s, float(world.stamps[t]), sync=True)
        decisions.append(None if r is None else (
            bool(r.new_keyframe), int(r.kf_slot), bool(r.kf_evicted), int(r.num_keyframes)))
    final = _jax_leaves(runner.state)
    jstore = runner.state.keyframes  # immutable: the ring before the forced round
    n_drive_rounds = len(runner.refine_log)
    jax_before = _jax_map_error(runner.state, gt_pos)
    runner.maybe_refine(force=True)
    n = int(runner.state.keyframes.count)
    jax = dict(decisions=decisions, log=runner.refine_log, n_drive_rounds=n_drive_rounds,
               seq=np.asarray(runner.state.keyframes.seq[:n]).tolist(),
               trajectory=runner.trajectory(), map_before=jax_before,
               map_after=_jax_map_error(runner.state, gt_pos), store=jstore, final=final)

    pcfg = tcfg.config_from_dict(dataclasses.asdict(cfg))
    row, trace = lv.drive(pcfg, world, scans, device="cpu")

    carried = OdometryRunner(pcfg, device="cpu")
    carried.state = tstate.state_from_numpy(final, "cpu", pcfg)
    carried_round = carried.maybe_refine(force=True)
    return dict(jax=jax, row=row, trace=trace, carried_round=carried_round,
                carried_map_after=lv.kf_map_error(carried.state, gt_pos), world=world,
                cfg=cfg, pcfg=pcfg)


def test_keyframe_decisions_and_evictions_match_reference(drives):
    """Per frame: spawn, ring slot, eviction and keyframe count identical;
    the ring saturates and evicts."""
    tr = drives["trace"]
    port = [None if s is None else (s, slot, ev, n) for s, slot, ev, n in zip(
        tr["new_keyframe"], tr["kf_slot"], tr["kf_evicted"], tr["num_keyframes"])]
    assert port == drives["jax"]["decisions"]
    ev = sum(1 for d in drives["jax"]["decisions"] if d is not None and d[2])
    assert ev >= 1 and drives["row"]["evictions"] == ev
    assert drives["row"]["ring_full_frame"] is not None


def test_ring_seq_matches_reference(drives):
    """The final ring's spawn frames, slot by slot, identical."""
    assert drives["trace"]["seq"] == drives["jax"]["seq"]
    assert len(set(drives["trace"]["seq"])) == RING


def test_refine_rounds_match_reference(drives):
    """Every round: the same frame, keyframe count, candidates and accepted
    edges; the drive's rounds within 1e-3 relative in graph error."""
    jlog, plog = drives["jax"]["log"], drives["trace"]["refine_log"]
    keys = ("frame", "n_keyframes", "n_candidates", "n_accepted")
    assert [[e[k] for k in keys] for e in plog] == [[e[k] for k in keys] for e in jlog]
    k = drives["jax"]["n_drive_rounds"]
    assert k >= 2 and [e["forced"] for e in plog] == [False] * k + [True]
    for pe, je in zip(plog[:k], jlog[:k]):
        assert abs(pe["graph_error"] - je["graph_error"]) <= GRAPH_REL * abs(je["graph_error"])


@pytest.mark.parametrize("package", ["jax", "port"])
def test_trigger_stops_once_the_ring_is_full(drives, package):
    """A round runs before saturation; with the ring full at most one
    unforced round runs, and none after it (the keyframe count stops at
    capacity, so the trigger's 'new keyframes' gate never passes again)."""
    if package == "jax":
        log = drives["jax"]["log"][: drives["jax"]["n_drive_rounds"]]
    else:
        log = [e for e in drives["trace"]["refine_log"] if not e["forced"]]
    full = [e for e in log if e["n_keyframes"] == RING]
    assert any(e["n_keyframes"] < RING for e in log)
    assert len(full) == 1
    assert all(e["frame"] <= full[0]["frame"] for e in log)
    if package == "port":
        checks = drives["trace"]["checks"]
        assert all(c["due"] == c["ran"] for c in checks)
        later = [c for c in checks if c["frame"] > full[0]["index"]]
        assert later and not any(c["due"] for c in later)


def test_trajectory_matches_reference(drives):
    est, ref = drives["trace"]["trajectory"], drives["jax"]["trajectory"]
    assert est.shape == ref.shape == (N_FRAMES, 4, 4)
    np.testing.assert_allclose(est, ref, atol=POSE_TOL)
    assert np.isfinite(drives["row"]["ate_rmse_m"]) and drives["trace"]["state_finite"]
    assert abs(drives["row"]["kf_map_err_before_m"] - drives["jax"]["map_before"]) <= POSE_TOL


def test_forced_round_on_the_reference_state_matches(drives):
    """The port's forced round on the JAX drive's final state: graph error
    within 1e-3 relative and keyframe-map error within 1e-3 m of the JAX
    round's, the same candidates and accepted edges."""
    je, pe = drives["jax"]["log"][-1], drives["carried_round"]
    assert (pe["n_candidates"], pe["n_accepted"]) == (je["n_candidates"], je["n_accepted"])
    assert abs(pe["graph_error"] - je["graph_error"]) <= GRAPH_REL * abs(je["graph_error"])
    assert abs(drives["carried_map_after"] - drives["jax"]["map_after"]) <= MAP_TOL


# ------------------------------------------- loop-closure dissection


def _jax_dissection(cfg, store, world) -> dict:
    """The rows of the JAX package's ``tools/debug_loopclosure.py`` (its
    code after the drive) on a JAX keyframe ring, its f64 Gauss-Newton
    run with ``tests/test_loopclosure.py``'s residual and retraction."""
    from direct_lidar_odometry_tpu.config import resolve_backend
    from direct_lidar_odometry_tpu.core import se3 as jse3
    from direct_lidar_odometry_tpu.odometry import loopclosure as jlc
    from direct_lidar_odometry_tpu.parallel import posegraph as jpg
    from tests import test_loopclosure as jlct
    from tools_torch import debug_loopclosure as dlc

    gt_all = lv.gt_poses(world)
    kfc = int(store.count)
    seq = np.asarray(store.seq[:kfc])
    pos = np.asarray(store.positions[:kfc])
    rot = [np.asarray(jse3.quat_to_rotmat(store.quats[k])) for k in range(kfc)]
    kf_err = np.linalg.norm(pos - gt_all[seq, :3, 3], axis=-1)
    rot_err = np.asarray([np.degrees(np.arccos(np.clip(
        (np.trace(rot[k] @ gt_all[seq[k], :3, :3].T) - 1) / 2, -1, 1))) for k in range(kfc)])
    pg = cfg.posegraph
    edges, cand = jlc.loop_candidates(store, pg.loop_radius, pg.min_index_gap, pg.max_loops)
    loops = jlc.register_loop_edges(store, edges, cand, cfg, resolve_backend(cfg))
    e, cand, w, rel = (np.asarray(a) for a in (edges, cand, loops.weight, loops.rel))

    def pose(k):
        x = np.eye(4)
        x[:3, :3], x[:3, 3] = rot[k], pos[k]
        return x

    def ang(r):
        return float(np.degrees(np.arccos(np.clip((np.trace(r[:3, :3]) - 1) / 2, -1, 1))))

    rows = []
    for m in range(len(e)):
        if not cand[m]:
            continue
        i, j = int(e[m, 0]), int(e[m, 1])
        z_true = np.linalg.inv(gt_all[seq[i]]) @ gt_all[seq[j]]
        resid = np.linalg.inv(rel[m]) @ (np.linalg.inv(pose(i)) @ pose(j))
        rows.append(dict(edge=[i, j], seq=[int(seq[i]), int(seq[j])], weight=float(w[m]),
                         z_err_m=float(np.linalg.norm(rel[m][:3, 3] - z_true[:3, 3])),
                         z_rot_err_deg=ang(rel[m] @ np.linalg.inv(z_true)),
                         resid_t_m=float(np.linalg.norm(resid[:3, 3]))))
    graph = jlc.build_refinement_graph(store, loops, pg.chain_weight)

    def after(poses):
        moved = np.asarray(poses)[:kfc, :3, 3]
        err = np.linalg.norm(moved - gt_all[seq, :3, 3], axis=-1)
        return dict(kf_err_after_mean=float(err.mean()), kf_err_after_max=float(err.max()),
                    max_move=float(np.linalg.norm(moved - pos, axis=-1).max()))

    refine = []
    for iters in (2, 8, 24):
        poses, err = jpg.refine(graph, iterations=iters)
        refine.append(dict(after(poses), iters=iters, graph_error=float(err)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dlc, "_residual_np", jlct._residual_np)
        mp.setattr(dlc, "_retract", jlct._retract)
        gn = after(dlc.solve_numpy({f: np.asarray(v) for f, v in graph._asdict().items()}))
    return dict(drift=dict(keyframes=kfc, kf_err_mean=float(kf_err.mean()),
                           kf_err_max=float(kf_err.max()),
                           rot_drift_deg_mean=float(rot_err.mean()),
                           rot_drift_deg_max=float(rot_err.max()),
                           rot_drift_deg_last5=rot_err[-5:].tolist()),
                n_candidates=int(cand.sum()), n_accepted=int((w > 0).sum()), edges=rows,
                refine=refine, gn=gn)


@pytest.fixture(scope="module")
def dissections(drives):
    """The port's dissection of the JAX drive's ring before its forced
    round (carried into the port) and of its own drive's, beside the JAX
    tool's rows on the JAX ring."""
    from tools_torch import debug_loopclosure as dlc

    world, pcfg = drives["world"], drives["pcfg"]
    carried = tstate.state_from_numpy(drives["jax"]["final"], "cpu", pcfg)
    return dict(jax=_jax_dissection(drives["cfg"], drives["jax"]["store"], world),
                carried=dlc.dissect(pcfg, carried, world, "cpu"),
                own=dlc.dissect(pcfg, drives["trace"]["state_before_forced"], world, "cpu"))


def test_dissection_on_the_reference_state_matches(drives, dissections):
    """On the same ring: the candidate pairs, their ``seq`` and the accepted
    edges identical; the drift rows within 1e-3 m (and degrees); graph
    error at 2, 8 and 24 iterations within 1e-3 relative and the keyframe
    error after each within 1e-3 m; the f64 Gauss-Newton row within 1e-3
    m. Each edge's ``z_err_m`` and ``resid_t_m`` within the loop GICP's
    own stopping step (``transformation_epsilon``, 1 cm): the edge
    [4, 5] of this ring is a poor registration (1.35 m from the truth)
    whose two packages' transforms agree within 1e-7 through GICP
    iteration 8 and then take one different correspondence, a hash-grid
    near-tie (d2 within 1e-6 relative, by design), and end 1.8e-4 rad
    apart: 1.44 mm at this ring's lever arm."""
    ref, got = dissections["jax"], dissections["carried"]
    edge_tol = drives["cfg"].gicp.s2m.transformation_epsilon
    assert (got["n_candidates"], got["n_accepted"]) == (ref["n_candidates"], ref["n_accepted"])
    assert got["n_accepted"] >= 1
    assert [(r["edge"], r["seq"]) for r in got["edges"]] == \
        [(r["edge"], r["seq"]) for r in ref["edges"]]
    assert [r["edge"] for r in got["edges"] if r["weight"] > 0] == \
        [r["edge"] for r in ref["edges"] if r["weight"] > 0]
    for g, r in zip(got["edges"], ref["edges"]):
        for key in ("z_err_m", "resid_t_m"):
            assert abs(g[key] - r[key]) <= edge_tol, (key, g, r)
    assert got["drift"]["keyframes"] == ref["drift"]["keyframes"] == RING
    for key in ("kf_err_mean", "kf_err_max", "rot_drift_deg_mean", "rot_drift_deg_max"):
        assert abs(got["drift"][key] - ref["drift"][key]) <= MAP_TOL, key
    np.testing.assert_allclose(got["drift"]["rot_drift_deg_last5"],
                               ref["drift"]["rot_drift_deg_last5"], atol=MAP_TOL)
    for g, r in zip(got["refine"], ref["refine"]):
        assert g["iters"] == r["iters"]
        assert abs(g["graph_error"] - r["graph_error"]) <= GRAPH_REL * abs(r["graph_error"])
        assert abs(g["kf_err_after_mean"] - r["kf_err_after_mean"]) <= MAP_TOL
    for key in ("kf_err_after_mean", "kf_err_after_max", "max_move"):
        assert abs(got["gn"][key] - ref["gn"][key]) <= MAP_TOL, key


def test_dissection_of_the_drive_equals_its_forced_round(drives, dissections):
    """The dissection of the port's ring before its forced round runs that
    round's calls: the same candidate and accepted counts, and its
    8-iteration graph error is the round's bit for bit; every row is
    finite."""
    own, forced = dissections["own"], drives["trace"]["refine_log"][-1]
    assert forced["forced"]
    assert (own["n_candidates"], own["n_accepted"]) == (forced["n_candidates"],
                                                        forced["n_accepted"])
    assert [r["iters"] for r in own["refine"]] == [2, 8, 24]
    assert own["refine"][1]["graph_error"] == forced["graph_error"]
    values = [v for row in (own["drift"], *own["edges"], *own["refine"], own["gn"])
              for v in row.values() if not isinstance(v, str)]
    flat = [x for v in values for x in (v if isinstance(v, list) else [v])]
    assert all(np.isfinite(float(x)) for x in flat)
