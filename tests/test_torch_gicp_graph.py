"""``registration/gicp.align``'s device-resident LM loop on the CPU.

:func:`_host_loop_align` is the loop that ``align`` ran before its state
moved to the device: lambda, nu and the accepted estimate updated on the
host after each read. ``align`` now keeps x, lambda and nu in device
tensors and updates them with ``torch.where``, so that one iteration can be
captured as a CUDA graph (``tests/test_torch_cuda.py`` holds the captured
path to the eager one on a card). Here the two loops give the same bits on
every backend, under LM and GN, and the device constants that replaced the
host-built copies hold the values those copies had.

Small clouds from the port's own synthetic world; one torch thread.
"""

import dataclasses

import numpy as np
import pytest
import torch

from direct_lidar_odometry_tpu_torch.config import DloConfig, ShapeConfig
from direct_lidar_odometry_tpu_torch.core import se3
from direct_lidar_odometry_tpu_torch.io import synthetic
from direct_lidar_odometry_tpu_torch.odometry import pipeline
from direct_lidar_odometry_tpu_torch.registration import covariance, gicp
from direct_lidar_odometry_tpu_torch.utils import sync

CFG = DloConfig(shapes=ShapeConfig(n_raw=4096, n_scan=2048, n_keyframe=1024, max_keyframes=16,
                                   max_submap_kf=4, n_submap_flat=4096, hull_directions=16,
                                   grid_table_size=2 ** 12, cell_cap_1nn=8, cell_cap_knn=32,
                                   knn_query_chunk=1024))


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    sync.reset()
    yield
    torch.set_num_threads(n)
    sync.reset()


def _host_loop_align(src, target, guess, cfg, backend="pallas", cap=16):
    """``align`` as it was with its LM state on the host (the oracle)."""
    dev = guess.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    x = gicp._reorthonormalize(guess.to(torch.float32))
    lam = None
    h_fin = eye6
    err_fin = torch.zeros((), dtype=torch.float32, device=dev)
    nc_fin = torch.zeros((), dtype=torch.int32, device=dev)
    iters, steps, converged, failed = 0, 0, False, False
    while iters < cfg.max_iterations and not converged and not failed:
        lin = gicp._linearize(x, src, target, cfg, backend, cap=cap)
        if cfg.optimizer == "lm":
            if lam is None:
                lam = cfg.lm_init_lambda_factor * torch.max(torch.abs(torch.diagonal(lin.h)))
            nu = 2.0
            ok, conv, x_new = False, False, x
            for _ in range(cfg.lm_max_iterations):
                steps += 1
                d = gicp._solve6(lin.h + lam * eye6, lin.b)
                delta = se3.se3_exp(d)
                xi = gicp._reorthonormalize(delta @ x)
                yi = gicp._compute_error(xi, src, lin)
                denom = torch.dot(d, lam * d - lin.b)
                denom = torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
                rho = (lin.error - yi) / denom
                accept = bool(rho >= 0.0)
                conv = bool(gicp._is_converged(delta, cfg))
                if accept:
                    lam = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
                    x_new = xi
                else:
                    lam = nu * lam
                    nu = 2.0 * nu
                if accept or conv:
                    ok = True
                    break
        else:
            steps += 1
            d = gicp._solve6(lin.h, lin.b)
            delta = se3.se3_exp(d)
            x_new = gicp._reorthonormalize(delta @ x)
            ok, conv = True, bool(gicp._is_converged(delta, cfg))
        converged = ok and conv
        failed = not ok
        if ok:
            x = x_new
        iters += 1
        h_fin, err_fin, nc_fin = lin.h, lin.error, lin.n_corr
    return gicp.GicpResult(x, h_fin, iters, converged, failed, err_fin, nc_fin), steps


def _render():
    """Two consecutive raw scans of a small box world (host arrays) and the
    ground-truth motion between them."""
    w = synthetic.make_world(np.random.default_rng(0), n_frames=10, extent=15.0, n_boxes=6,
                             speed=0.4, ground_points=3000, density=3.0)
    raw = []
    for t in (0, 1):
        s = synthetic.render_scan(w, t, np.random.default_rng(50 + t), max_range=13.0,
                                  max_points=CFG.shapes.n_raw)
        pts = np.full((CFG.shapes.n_raw, 3), 1e6, np.float32)
        pts[: len(s)] = s
        raw.append((torch.from_numpy(pts), torch.from_numpy(np.arange(CFG.shapes.n_raw) < len(s))))
    gt = (np.linalg.inv(w.poses[0]) @ w.poses[1]).astype(np.float32)
    return raw, torch.from_numpy(gt)


@pytest.fixture(scope="module")
def scans():
    return _render()


def _problem(scans, backend, gate):
    """(source, target) of the two scans, prepared as the step prepares
    them on ``backend``."""
    raw, _ = scans
    clouds = []
    for pts, mask in raw:
        scan = pipeline.preprocess_scan(pts, mask, CFG, backend)
        nrm = pipeline._scan_normals(scan, CFG, backend)
        clouds.append((scan.points, scan.mask, nrm.normals, nrm.valid))
    target = gicp.make_target(*clouds[0], gate, CFG.shapes.grid_table_size, backend)
    return gicp.GicpSource(*clouds[1]), target


def _guess(scans, kind):
    _, gt = scans
    if kind == "half":
        g = torch.eye(4)
        g[:3, 3] = gt[:3, 3] * 0.5
        return g
    # a yaw of 0.25 rad and 0.6 m off
    off = se3.se3_exp(torch.tensor([0.0, 0.0, 0.25, 0.6, -0.3, 0.0]))
    return off @ gt


def _stage(optimizer, gate, eps):
    """The S2S stage with ``optimizer`` and gate ``gate``; ``eps`` (or
    None) for both convergence epsilons: at 1e-8 the steps near the
    optimum are rounding noise, which LM rejects and retries."""
    cfg = dataclasses.replace(CFG.gicp.s2s, optimizer=optimizer, max_correspondence_distance=gate)
    if eps is None:
        return cfg
    return dataclasses.replace(cfg, rotation_epsilon=eps, transformation_epsilon=eps)


CASES = [  # backend, optimizer, gate, guess, epsilons
    ("pallas", "lm", 1.0, "half", None),
    ("pallas", "gn", 1.0, "half", None),
    ("pallas", "lm", 0.5, "far", None),
    ("pallas", "lm", 1.0, "half", 1e-8),
    ("pallas_mxu", "lm", 1.0, "far", None),
    ("pallas_fused", "lm", 1.0, "half", None),
    ("pallas_fused", "gn", 0.5, "far", None),
    ("pallas_fused", "lm", 1.0, "half", 1e-8),
    ("hashgrid", "lm", 1.0, "far", None),
    ("brute", "lm", 1.0, "half", 1e-8),
]


@pytest.mark.parametrize("backend,optimizer,gate,guess,eps", CASES)
def test_device_state_loop_equals_host_loop(scans, backend, optimizer, gate, guess, eps):
    """Every field of the result, bit for bit, and the same count of LM (or
    GN) steps; no graph on the CPU. The tight-epsilon cases retry LM steps
    on one linearization."""
    src, target = _problem(scans, backend, gate)
    cfg = _stage(optimizer, gate, eps)
    g = _guess(scans, guess)
    want, want_steps = _host_loop_align(src, target, g, cfg, backend, CFG.shapes.cell_cap_1nn)
    with sync.span("case"):
        got = gicp.align(src, target, g, cfg, backend, CFG.shapes.cell_cap_1nn)
    for name in ("transform", "hessian", "final_error", "num_correspondences"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.iterations, got.converged, got.lm_failed) == (
        want.iterations, want.converged, want.lm_failed)
    assert int(want.num_correspondences) > 100
    assert sync.counts["align_iters.case"] == got.iterations > 0
    assert sync.counts["lm_steps.case"] == want_steps
    assert (want_steps > got.iterations) == (eps is not None)
    assert not any(k.startswith("gicp_graph.") for k in sync.counts)


@pytest.mark.parametrize("optimizer", ["lm", "gn"])
def test_no_iteration_returns_the_guess(scans, optimizer):
    """``max_iterations`` 0: the reorthonormalized guess, an identity H, no
    error and no correspondence, as before."""
    src, target = _problem(scans, "pallas", 1.0)
    cfg = dataclasses.replace(CFG.gicp.s2s, optimizer=optimizer, max_iterations=0)
    g = _guess(scans, "far")
    want, _ = _host_loop_align(src, target, g, cfg)
    got = gicp.align(src, target, g, cfg)
    for name in ("transform", "hessian", "final_error", "num_correspondences"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert (got.iterations, got.converged, got.lm_failed) == (0, False, False)


CONSTANTS = [(1.0, 0.0, 0.0, 0.0), (1.0, -1.0, -1.0, -1.0), (1.0, 0.0, 0.0),
             (0.0, 1.0, 0.0), (0.0, 0.0, 0.0, 1.0), (0.0, 0.0, 1.0)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_device_constants_equal_their_uploads(dtype):
    """Each constant the helpers used to copy from the host: the values
    ``sync.upload`` gave, in the dtype asked for, built once per (device,
    dtype) and shared; ``quat_identity`` hands out its own copy."""
    for values in CONSTANTS:
        got = sync.constant(values, torch.device("cpu"), dtype)
        want = sync.upload(list(values), torch.device("cpu"), dtype)
        assert got.dtype == want.dtype == dtype and torch.equal(got, want)
        assert sync.constant(values, None, dtype) is got
    assert sync.constant((1.0, 0.0), "cpu", torch.float32) is not sync.constant(
        (1.0, 0.0), "cpu", torch.float64)
    q = se3.quat_identity(dtype)
    q.add_(1.0)
    assert torch.equal(se3.quat_identity(dtype), torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype))
    r = torch.eye(3, dtype=dtype)[None].repeat(2, 1, 1)
    t = torch.arange(6, dtype=dtype).reshape(2, 3)
    m = se3.make_se3(r, t)
    assert torch.equal(m[:, 3], torch.tensor([[0.0, 0.0, 0.0, 1.0]] * 2, dtype=dtype))
    qc = se3.quat_conj(torch.tensor([0.5, 0.1, -0.2, 0.3], dtype=dtype))
    assert torch.equal(qc, torch.tensor([0.5, -0.1, 0.2, -0.3], dtype=dtype))
    nrm = covariance._masked_normals(torch.ones(2, 3, dtype=dtype), torch.tensor([True, False]))
    assert torch.equal(nrm, torch.tensor([[1.0, 1.0, 1.0], [0.0, 0.0, 1.0]], dtype=dtype))
    flip = se3.quat_from_two_vectors(torch.tensor([1.0, 0.0, 0.0], dtype=dtype),
                                     torch.tensor([-1.0, 0.0, 0.0], dtype=dtype))
    assert torch.allclose(se3.quat_rotate(flip, torch.tensor([1.0, 0.0, 0.0], dtype=dtype)),
                          torch.tensor([-1.0, 0.0, 0.0], dtype=dtype))
