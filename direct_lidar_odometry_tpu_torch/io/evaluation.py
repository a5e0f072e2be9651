"""Trajectory evaluation: ATE (with Umeyama alignment) and RPE.

A copy of the JAX package's ``io/evaluation.py`` (numpy only), so that
scripts driving the port need not import the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def umeyama_align(est: np.ndarray, gt: np.ndarray, with_scale: bool = False):
    """Least-squares SE(3) (or Sim(3)) alignment est -> gt. [T,3] each."""
    mu_e = est.mean(axis=0)
    mu_g = gt.mean(axis=0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / len(est)
    u, d, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1
    r = u @ s @ vt
    if with_scale:
        var_e = (xe**2).sum() / len(est)
        c = np.trace(np.diag(d) @ s) / var_e
    else:
        c = 1.0
    t = mu_g - c * r @ mu_e
    return c, r, t


@dataclass
class AteResult:
    rmse: float
    mean: float
    median: float
    max: float


def ate(est_poses: np.ndarray, gt_poses: np.ndarray, align: bool = True) -> AteResult:
    """Absolute trajectory error of [T,4,4] pose arrays."""
    est = est_poses[:, :3, 3]
    gt = gt_poses[:, :3, 3]
    if align:
        c, r, t = umeyama_align(est, gt)
        est = (c * (r @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return AteResult(
        rmse=float(np.sqrt((err**2).mean())),
        mean=float(err.mean()),
        median=float(np.median(err)),
        max=float(err.max()),
    )


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over a frame delta: (trans_rmse_m, rot_rmse_deg)."""
    t_errs, r_errs = [], []
    for i in range(len(est_poses) - delta):
        de = np.linalg.inv(est_poses[i]) @ est_poses[i + delta]
        dg = np.linalg.inv(gt_poses[i]) @ gt_poses[i + delta]
        rel = np.linalg.inv(dg) @ de
        t_errs.append(np.linalg.norm(rel[:3, 3]))
        cos_t = np.clip((np.trace(rel[:3, :3]) - 1) / 2, -1, 1)
        r_errs.append(np.degrees(np.arccos(cos_t)))
    return float(np.sqrt(np.mean(np.square(t_errs)))), float(
        np.sqrt(np.mean(np.square(r_errs)))
    )
