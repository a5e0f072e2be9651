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
from direct_lidar_odometry_tpu_torch.ops import cuda_lm
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
    x = cuda_lm.reorthonormalize_plain(guess.to(torch.float32))
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
                d = cuda_lm.solve6(lin.h + lam * eye6, lin.b)
                delta = se3.se3_exp(d)
                xi = cuda_lm.reorthonormalize_plain(delta @ x)
                yi = cuda_lm.compute_error_plain(xi, src.points, lin.mu_b, lin.n_b, lin.m0,
                                                 lin.weight, covariance.PLANE_EPS)
                denom = torch.dot(d, lam * d - lin.b)
                denom = torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
                rho = (lin.error - yi) / denom
                accept = bool(rho >= 0.0)
                conv = bool(cuda_lm.is_converged(delta, cfg.rotation_epsilon,
                                                 cfg.transformation_epsilon))
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
            d = cuda_lm.solve6(lin.h, lin.b)
            delta = se3.se3_exp(d)
            x_new = cuda_lm.reorthonormalize_plain(delta @ x)
            ok, conv = True, bool(cuda_lm.is_converged(delta, cfg.rotation_epsilon,
                                                       cfg.transformation_epsilon))
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


def _pre_kernel_reorthonormalize(x):
    """``gicp._reorthonormalize`` as it was before ``ops/cuda_lm.py``."""
    q = se3.rotmat_to_quat(x[..., :3, :3])
    return se3.make_se3(se3.quat_to_rotmat(q), x[..., :3, 3])


def _pre_kernel_compute_error(x0, src, lin):
    """``gicp._compute_error`` as it was before ``ops/cuda_lm.py``."""
    p_t = se3.transform_points(x0, src.points)
    e = lin.mu_b - p_t
    ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
    nx, ny, nz = lin.n_b[..., 0], lin.n_b[..., 1], lin.n_b[..., 2]
    mx, my, mz = lin.m0[..., 0], lin.m0[..., 1], lin.m0[..., 2]
    a = 1.0 - covariance.PLANE_EPS
    a00 = 2.0 - a * (nx * nx + mx * mx)
    a01 = -a * (nx * ny + mx * my)
    a02 = -a * (nx * nz + mx * mz)
    a11 = 2.0 - a * (ny * ny + my * my)
    a12 = -a * (ny * nz + my * mz)
    a22 = 2.0 - a * (nz * nz + mz * mz)
    co00 = a11 * a22 - a12 * a12
    co01 = a02 * a12 - a01 * a22
    co02 = a01 * a12 - a02 * a11
    det = a00 * co00 + a01 * co01 + a02 * co02
    inv_det = lin.weight / torch.where(torch.abs(det) > 1e-20, det, torch.ones_like(det))
    m00 = co00 * inv_det
    m01 = co01 * inv_det
    m02 = co02 * inv_det
    m11 = (a00 * a22 - a02 * a02) * inv_det
    m12 = (a01 * a02 - a00 * a12) * inv_det
    m22 = (a00 * a11 - a01 * a01) * inv_det
    mex = m00 * ex + m01 * ey + m02 * ez
    mey = m01 * ex + m11 * ey + m12 * ez
    mez = m02 * ex + m12 * ey + m22 * ez
    return torch.sum(ex * mex + ey * mey + ez * mez)


def _pre_kernel_lm_trial(st, src, lin, cfg):
    """``gicp._lm_trial`` as it was before its trial became kernel K7 (the
    oracle of the plain route)."""
    eye6 = torch.eye(6, dtype=torch.float32, device=st.x.device)
    d = torch.linalg.solve_ex(lin.h + st.lam * eye6, -lin.b)[0]
    delta = se3.se3_exp(d)
    xi = _pre_kernel_reorthonormalize(delta @ st.x)
    yi = _pre_kernel_compute_error(xi, src, lin)
    denom = torch.dot(d, st.lam * d - lin.b)
    denom = torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
    rho = (lin.error - yi) / denom
    accept = rho >= 0.0
    r = delta[:3, :3] - torch.eye(3, dtype=delta.dtype, device=delta.device)
    conv = torch.maximum(torch.max(torch.abs(r)) / cfg.rotation_epsilon,
                         torch.max(torch.abs(delta[:3, 3])) / cfg.transformation_epsilon) < 1.0
    flags = torch.stack([accept, conv])
    st.lam.copy_(torch.where(accept, st.lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                                          min=1.0 / 3.0), st.nu * st.lam))
    st.nu.copy_(torch.where(accept, st.nu, 2.0 * st.nu))
    st.x.copy_(torch.where(accept, xi, st.x))
    return flags


@pytest.mark.parametrize("backend,case", [
    ("pallas", "first"), ("pallas_fused", "first"), ("pallas", "rejected"),
    ("pallas_fused", "converged"),
])
def test_lm_trial_on_cpu_equals_the_pre_kernel_trial(scans, backend, case):
    """``ops/cuda_lm.lm_trial`` on CPU tensors (its plain route) gives the
    pre-kernel trial's flags, x, lambda and nu bit for bit: a call's first
    trial, one rejected (the linearization's error set to 0, so no step
    lowers it; nu doubles) and one that converges at loose epsilons;
    ``pallas_fused`` hands over K3's strided payload rows."""
    from direct_lidar_odometry_tpu_torch.ops import cuda_lm

    src, target = _problem(scans, backend, 1.0)
    cfg = _stage("lm", 1.0, 0.5 if case == "converged" else None)
    x0 = _pre_kernel_reorthonormalize(_guess(scans, "half"))
    assert torch.equal(cuda_lm.reorthonormalize(_guess(scans, "half")), x0)
    lin = gicp._linearize(x0, src, target, cfg, backend)
    if case == "rejected":
        lin = lin._replace(error=torch.zeros(()))
    lam0 = cfg.lm_init_lambda_factor * torch.max(torch.abs(torch.diagonal(lin.h)))
    states = [gicp._LmState(x0.clone(), lam0.clone(), torch.full((), 2.0),
                            torch.zeros((), dtype=torch.bool), None) for _ in range(2)]
    cuda_lm.reset_launches()
    got = gicp._lm_trial(states[0], src, lin, cfg)
    want = _pre_kernel_lm_trial(states[1], src, lin, cfg)
    assert cuda_lm.launches == {"cuda": 0, "plain": 1, "captured": 0}
    assert torch.equal(got, want) and got.tolist() == {
        "first": [True, False], "rejected": [False, False], "converged": [True, True]}[case]
    for a, b in zip(states[0][:3], states[1][:3]):
        assert torch.equal(a, b)
