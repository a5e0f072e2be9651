"""Dissect one loop-closure round: wrong measurement, or wrong solver.

Port of the JAX package's ``tools/debug_loopclosure.py``. It drives the
long-validation noise-burst sequence with loop closure off, then takes the
end state's refinement apart: which candidate pairs fire, how far each
GICP loop measurement Z is from the ground-truth relative pose (exact
association through ``KeyframeStore.seq``, the spawn frame), what
``posegraph.refine`` does to the per-keyframe error at 2, 8 and 24
iterations, and what an f64 Gauss-Newton with numeric Jacobians does on
the same graph (a solver fault shows as the two disagreeing; a measurement
fault as large ``z_err_m`` with both agreeing; small ``z_err_m``, both
agreeing and a worse map point at the refinement objective itself).

On the card:
    SMALL=1 LV_FRAMES=300 LV_NOISE_BURST=100:140:0.15 LV_MAX_KF=128 \\
        python3 tools_torch/debug_loopclosure.py
On the CPU, call :func:`run` (or :func:`dissect` on a state of your own)
with ``device="cpu"``.

Environment (the JAX tool's): ``LV_FRAMES`` (300), ``LV_NOISE_BURST``
("100:140:0.15"), ``LV_MAX_KF`` (128) and ``DLC_CACHE`` (the end state's
checkpoint, format v2, read when it exists and written after a drive; an
empty value disables it; default ``debug_lc_state.npz`` in the temporary
directory). Prints the drift row, one JSON line per candidate edge, one
per refine iteration count and the f64 solver's row, unrounded.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from direct_lidar_odometry_tpu_torch.config import DloConfig, resolve_backend  # noqa: E402
from direct_lidar_odometry_tpu_torch.core import se3  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry import loopclosure  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry.runner import OdometryRunner  # noqa: E402
from direct_lidar_odometry_tpu_torch.parallel import posegraph  # noqa: E402
from direct_lidar_odometry_tpu_torch.utils import checkpoint  # noqa: E402
from tools_torch import long_validation as lv  # noqa: E402

REFINE_ITERS = (2, 8, 24)
GN_ITERS = 20


# f64 numpy oracle of the pose-graph residual and the pseudo-exp
# retraction (copies of the JAX package's tests/test_loopclosure.py helpers)

def _rodrigues(w):
    t = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if t < 1e-10:
        return np.eye(3) + k
    return np.eye(3) + np.sin(t) / t * k + (1 - np.cos(t)) / t**2 * (k @ k)


def _log_so3(r):
    cos_t = np.clip((np.trace(r) - 1) / 2, -1, 1)
    t = np.arccos(cos_t)
    if t < 1e-10:
        return np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]]) / 2
    v = np.array([r[2, 1] - r[1, 2], r[0, 2] - r[2, 0], r[1, 0] - r[0, 1]])
    return v * t / (2 * np.sin(t))


def _retract(x, xi):
    """x @ P(xi), P = (rodrigues(xi_w), xi_t), as ``se3.se3_exp``."""
    p = np.eye(4)
    p[:3, :3] = _rodrigues(xi[:3])
    p[:3, 3] = xi[3:]
    return x @ p


def _residual_np(x_i, x_j, z):
    e = np.linalg.inv(z) @ (np.linalg.inv(x_i) @ x_j)
    return np.concatenate([_log_so3(e[:3, :3]), e[:3, 3]])


def _angle_deg(r) -> float:
    return float(np.degrees(np.arccos(np.clip((np.trace(r[:3, :3]) - 1) / 2, -1, 1))))


def make_config(max_kf: int = 128) -> DloConfig:
    """The JAX tool's configuration: the long-validation small shapes with a
    ``max_kf`` ring, a constant-velocity prior, loop closure off (the
    dissection runs the round itself), ``min_index_gap`` 20,
    ``loop_radius`` 6 and ``check_every`` 64."""
    return lv.with_posegraph(lv.make_config(small=True, max_kf=max_kf), False, min_gap=20,
                             loop_radius=6.0, check_every=64)


def solve_numpy(graph: dict, iters: int = GN_ITERS, pin_w: float = 1e6,
                damp: float = 1e-4) -> np.ndarray:
    """Dense f64 Gauss-Newton with central-difference Jacobians over the
    graph's masked-in edges (numpy arrays of a ``PoseGraph``), the gauge
    pinned on pose 0 and masked-out poses frozen: the refined [K, 4, 4]
    poses."""
    e, rel, em, w, pm = (graph[f] for f in ("edges", "rel", "edge_mask", "weights", "pose_mask"))
    x = np.asarray(graph["poses"], np.float64).copy()
    rel, w = np.asarray(rel, np.float64), np.asarray(w, np.float64)
    k = x.shape[0]
    eps = 1e-6
    for _ in range(iters):
        h = np.zeros((k * 6, k * 6))
        g = np.zeros(k * 6)
        for m in range(len(e)):
            if not em[m]:
                continue
            i, j = int(e[m, 0]), int(e[m, 1])
            r = _residual_np(x[i], x[j], rel[m])
            ji, jj = np.zeros((6, 6)), np.zeros((6, 6))
            for a in range(6):
                d = np.zeros(6)
                d[a] = eps
                ji[:, a] = (_residual_np(_retract(x[i], d), x[j], rel[m])
                            - _residual_np(_retract(x[i], -d), x[j], rel[m])) / (2 * eps)
                jj[:, a] = (_residual_np(x[i], _retract(x[j], d), rel[m])
                            - _residual_np(x[i], _retract(x[j], -d), rel[m])) / (2 * eps)
            si, sj = slice(i * 6, i * 6 + 6), slice(j * 6, j * 6 + 6)
            h[si, si] += w[m] * ji.T @ ji
            h[sj, sj] += w[m] * jj.T @ jj
            h[si, sj] += w[m] * ji.T @ jj
            h[sj, si] += w[m] * jj.T @ ji
            g[si] += w[m] * ji.T @ r
            g[sj] += w[m] * jj.T @ r
        diag = np.full(k * 6, damp)
        diag[:6] += pin_w
        for p in range(k):
            if not pm[p]:
                diag[p * 6:p * 6 + 6] += 1e9
        h[np.diag_indices_from(h)] += diag
        delta = np.linalg.solve(h, -g)
        for p in range(k):
            if pm[p]:
                x[p] = _retract(x[p], delta[p * 6:p * 6 + 6])
    return x


def dissect(cfg: DloConfig, state, world, device="cuda") -> dict:
    """The JAX tool's rows for the loop-closure round on ``state`` (its
    keyframe ring is read, not written), against ``world``'s ground truth.

    Returns ``drift`` (the ring's ``keyframes``, per-keyframe translation
    error ``kf_err_mean`` / ``kf_err_max`` in m and rotation drift
    ``rot_drift_deg_mean`` / ``_max`` / ``_last5``), ``n_candidates`` and
    ``n_accepted`` (the round's counts), ``edges`` (one row per candidate:
    ``edge``, ``seq``, ``weight``, ``num_corr``, ``z_err_m``,
    ``z_rot_err_deg``, ``resid_t_m``, ``resid_rot_deg``), ``refine`` (one
    row per iteration count of ``posegraph.refine``: ``iters``,
    ``graph_error``, ``kf_err_after_mean`` / ``_max``, ``max_move``) and
    ``gn`` (the f64 numeric-Jacobian Gauss-Newton's row on the same
    graph). The candidates are ``loop_candidates`` without ``min_seq_gap``,
    as in the JAX tool."""
    dev = lv.require_device(device)
    store = type(state.keyframes)(*(t.to(dev) for t in state.keyframes))
    gt_all = lv.gt_poses(world)
    kfc = int(store.count)
    seq = store.seq[:kfc].cpu().numpy()
    pos = store.positions[:kfc].cpu().numpy()
    rot = se3.quat_to_rotmat(store.quats[:kfc]).cpu().numpy()
    kf_err = np.linalg.norm(pos - gt_all[seq, :3, 3], axis=-1)
    rot_err = np.asarray([_angle_deg(rot[k] @ gt_all[seq[k], :3, :3].T) for k in range(kfc)])
    drift = dict(keyframes=kfc, kf_err_mean=float(kf_err.mean()), kf_err_max=float(kf_err.max()),
                 rot_drift_deg_mean=float(rot_err.mean()), rot_drift_deg_max=float(rot_err.max()),
                 rot_drift_deg_last5=rot_err[-5:].tolist())

    pg = cfg.posegraph
    edges, cand_mask = loopclosure.loop_candidates(store, pg.loop_radius, pg.min_index_gap,
                                                   pg.max_loops)
    loops = loopclosure.register_loop_edges(store, edges, cand_mask, cfg, resolve_backend(cfg))
    e, mask = edges.cpu().numpy(), cand_mask.cpu().numpy()
    w, rel, nc = (loops.weight.cpu().numpy(), loops.rel.cpu().numpy(),
                  loops.num_corr.cpu().numpy())

    def pose(idx):
        x = np.eye(4)
        x[:3, :3] = rot[idx]
        x[:3, 3] = pos[idx]
        return x

    rows = []
    for m in np.flatnonzero(mask):
        i, j = int(e[m, 0]), int(e[m, 1])
        z_true = np.linalg.inv(gt_all[seq[i]]) @ gt_all[seq[j]]
        # the residual at the current estimates: what the graph will remove
        resid = np.linalg.inv(rel[m]) @ (np.linalg.inv(pose(i)) @ pose(j))
        rows.append(dict(
            edge=[i, j], seq=[int(seq[i]), int(seq[j])], weight=float(w[m]),
            num_corr=int(nc[m]), z_err_m=float(np.linalg.norm(rel[m][:3, 3] - z_true[:3, 3])),
            z_rot_err_deg=_angle_deg(rel[m] @ np.linalg.inv(z_true)),
            resid_t_m=float(np.linalg.norm(resid[:3, 3])), resid_rot_deg=_angle_deg(resid)))

    graph = loopclosure.build_refinement_graph(store, loops, pg.chain_weight)

    def after(poses: np.ndarray, **row) -> dict:
        moved = poses[:kfc, :3, 3]
        err = np.linalg.norm(moved - gt_all[seq, :3, 3], axis=-1)
        return dict(row, kf_err_after_mean=float(err.mean()), kf_err_after_max=float(err.max()),
                    max_move=float(np.linalg.norm(moved - pos, axis=-1).max()))

    refine = []
    for iters in REFINE_ITERS:
        new_poses, err = posegraph.refine(graph, iterations=iters)
        refine.append(after(new_poses.cpu().numpy(), iters=iters, graph_error=float(err)))
    gn = after(solve_numpy({f: v.cpu().numpy() for f, v in graph._asdict().items()}),
               solver="numpy_f64_numeric_jacobians", iters=GN_ITERS)
    return dict(drift=drift, n_candidates=int(mask.sum()), n_accepted=int((w > 0).sum()),
                edges=rows, refine=refine, gn=gn)


def rows(result: dict) -> list[dict]:
    """The dissection as the JAX tool prints it: the drift row, the edges,
    the refine rows, the f64 solver's row."""
    return [result["drift"], *result["edges"], *result["refine"], result["gn"]]


def run(device="cuda", frames: int = 300, burst: tuple = (100, 140, 0.15), max_kf: int = 128,
        cache: str = "") -> dict:
    """The JAX tool's drive (its world, scans from ``rng(3)`` at noise 0.01
    with ``burst`` = (a, b, sigma) on frames [a, b), loop closure off), or
    the end state in ``cache`` when that file exists; the drive's end
    state is written there when ``cache`` is set. Returns
    :func:`dissect`'s result with ``cached`` (whether the state was
    loaded)."""
    dev = lv.require_device(device)
    cfg = make_config(max_kf)
    world, render = lv.make_world(frames, small=True, soup=True)
    cached = bool(cache) and os.path.exists(cache)
    if cached:
        state, _ = checkpoint.load_state(cache, cfg, dev)
    else:
        runner = OdometryRunner(cfg, device=dev)
        for t, scan in enumerate(lv.render_scans(world, render, frames, 0.01, burst)):
            runner.process_scan(scan, float(world.stamps[t]))
        state = runner.state
        if cache:
            checkpoint.save_state(cache, state)
    return dict(dissect(cfg, state, world, dev), cached=cached)


def env_args() -> dict:
    """:func:`run`'s arguments from the JAX tool's environment variables."""
    a, b, sigma = os.environ.get("LV_NOISE_BURST", "100:140:0.15").split(":")
    return dict(
        frames=int(os.environ.get("LV_FRAMES", "300")),
        burst=(int(a), int(b), float(sigma)),
        max_kf=int(os.environ.get("LV_MAX_KF", "128")),
        cache=os.environ.get("DLC_CACHE",
                             os.path.join(tempfile.gettempdir(), "debug_lc_state.npz")),
    )


def main() -> None:
    args = env_args()
    result = run(device="cuda", **args)
    if result["cached"]:
        print(f"# loaded cached end state from {args['cache']}")
    for row in rows(result):
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
