"""One Levenberg-Marquardt trial of GICP's ``align`` (kernel K7), and the
re-orthonormalization of a pose.

Counterpart of the LM inner step of the JAX package's
``registration/gicp.py`` (``lsq_registration_impl.hpp:169-206`` with
``nano_gicp_impl.hpp:272-296``'s error), which XLA fuses inside its
``lax.while_loop``; the JAX package has no Pallas kernel for it.

- :func:`lm_trial` is the kernel's wrapper. On a CUDA tensor it launches
  ``csrc/lm_trial.cu``: the damped 6x6 solve, ``se3_exp``, the
  re-orthonormalized estimate, its error over the frozen correspondences,
  the gain ratio rho and the lambda / nu / x updates in one launch. On a
  CPU tensor it runs :func:`lm_trial_plain`, the plain PyTorch version.
  Nothing falls back from one to the other.
- :func:`reorthonormalize` is the same for one [4, 4] pose: a one-thread
  launch on a CUDA tensor, :func:`reorthonormalize_plain` on a CPU tensor.
- The plain helpers (:func:`solve6`, :func:`is_converged`,
  :func:`compute_error_plain`, :func:`reorthonormalize_plain`) also serve
  ``registration/gicp.py``'s Gauss-Newton step and ``align_batched``'s
  host loop, each of one lane or of B.

The kernel needs a workspace of its own (:func:`workspace`): the blocks'
partial error sums, the trial's error and rho (:data:`ERROR_SLOT`,
:data:`RHO_SLOT`) and the ticket that elects the block which finishes the
trial, reset by that block. A state that keeps its workspace for its life
lets the launch be captured in a CUDA graph and replayed.

``launches`` counts the trial's launches per route (``"cuda"``: the kernel,
``"plain"``: its plain version, ``"captured"``: kernel launches recorded
into a CUDA graph capture, which the graph launches again at each replay);
``reorth_launches`` those of :func:`reorthonormalize`.
"""

from __future__ import annotations

import numpy as np
import torch

from direct_lidar_odometry_tpu_torch.core import se3
from direct_lidar_odometry_tpu_torch.ops import cuda_build
from direct_lidar_odometry_tpu_torch.utils.lanes import per_lane

MAX_BLOCKS = 128  # csrc/lm_trial.cu's kMaxBlocks: one partial sum a block
ERROR_SLOT = MAX_BLOCKS
RHO_SLOT = MAX_BLOCKS + 1
WORK_SLOTS = MAX_BLOCKS + 4  # partials, error, rho, ticket, spare

launches = {"cuda": 0, "plain": 0, "captured": 0}
reorth_launches = {"cuda": 0, "plain": 0, "captured": 0}


def reset_launches() -> None:
    for counter in (launches, reorth_launches):
        for k in counter:
            counter[k] = 0


def _count(counter: dict, device: torch.device) -> None:
    if device.type == "cpu":
        counter["plain"] += 1
    elif torch.cuda.is_current_stream_capturing():
        counter["captured"] += 1
    else:
        counter["cuda"] += 1


def solve6(h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    # solve_ex: no error check, hence no host sync (a singular H gives
    # non-finite steps, which the gain test rejects, as in the reference)
    return torch.linalg.solve_ex(h, -b)[0]


def is_converged(delta: torch.Tensor, rotation_epsilon: float,
                 transformation_epsilon: float) -> torch.Tensor:
    """Reference lsq_registration_impl.hpp:118-127 (device bool); of each
    lane, [B], for [B, 4, 4] steps."""
    r = delta[..., :3, :3] - torch.eye(3, dtype=delta.dtype, device=delta.device)
    r_max = torch.amax(torch.abs(r), dim=(-2, -1)) / rotation_epsilon
    t_max = torch.amax(torch.abs(delta[..., :3, 3]), dim=-1) / transformation_epsilon
    return torch.maximum(r_max, t_max) < 1.0


def reorthonormalize_plain(x: torch.Tensor) -> torch.Tensor:
    """Keep the rotation block orthonormal under f32 compounding (quat
    roundtrip). [..., 4, 4]."""
    q = se3.rotmat_to_quat(x[..., :3, :3])
    return se3.make_se3(se3.quat_to_rotmat(q), x[..., :3, 3])


def compute_error_plain(x0, points, mu_b, n_b, m0, weight, plane_eps: float) -> torch.Tensor:
    """Reference nano_gicp_impl.hpp:272-296 — frozen correspondences, with
    M = w * (2I - (1-eps)(n_b n_b^T + m0 m0^T))^{-1} rebuilt columnwise.
    With B lanes (x0 [B, 4, 4]) the error of each lane, [B]."""
    p_t = se3.transform_points(x0, points)
    e = mu_b - p_t
    ex, ey, ez = e[..., 0], e[..., 1], e[..., 2]
    nx, ny, nz = n_b[..., 0], n_b[..., 1], n_b[..., 2]
    mx, my, mz = m0[..., 0], m0[..., 1], m0[..., 2]
    a = 1.0 - plane_eps
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
    inv_det = weight / torch.where(torch.abs(det) > 1e-20, det, torch.ones_like(det))
    m00 = co00 * inv_det
    m01 = co01 * inv_det
    m02 = co02 * inv_det
    m11 = (a00 * a22 - a02 * a02) * inv_det
    m12 = (a01 * a02 - a00 * a12) * inv_det
    m22 = (a00 * a11 - a01 * a01) * inv_det
    mex = m00 * ex + m01 * ey + m02 * ez
    mey = m01 * ex + m11 * ey + m12 * ez
    mez = m02 * ex + m12 * ey + m22 * ez
    if x0.dim() == 3:
        return per_lane(torch.sum, ex * mex + ey * mey + ez * mez)
    return torch.sum(ex * mex + ey * mey + ez * mez)


def lm_trial_plain(x, lam, nu, h, b, error, mu_b, n_b, m0, weight, points,
                   rotation_epsilon: float, transformation_epsilon: float,
                   plane_eps: float) -> torch.Tensor:
    """Plain PyTorch version of K7: one trial of step_lm
    (lsq_registration_impl.hpp:169-206) on the linearization ``h``, ``b``,
    ``error`` and its frozen correspondences: the damped step, the gain
    ratio rho, then ``lam``, ``nu`` and ``x`` updated in place as an
    accepted (rho >= 0) or a rejected step updates them. Returns the
    [accept, converged] flags."""
    eye6 = torch.eye(6, dtype=torch.float32, device=x.device)
    d = solve6(h + lam * eye6, b)
    delta = se3.se3_exp(d)
    xi = reorthonormalize_plain(delta @ x)
    yi = compute_error_plain(xi, points, mu_b, n_b, m0, weight, plane_eps)
    denom = torch.dot(d, lam * d - b)
    denom = torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
    rho = (error - yi) / denom
    accept = rho >= 0.0
    flags = torch.stack([accept, is_converged(delta, rotation_epsilon, transformation_epsilon)])
    lam.copy_(torch.where(accept, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3,
                                                    min=1.0 / 3.0), nu * lam))
    nu.copy_(torch.where(accept, nu, 2.0 * nu))
    x.copy_(torch.where(accept, xi, x))
    return flags


def workspace(device) -> torch.Tensor | None:
    """A zeroed [WORK_SLOTS] float32 workspace for :func:`lm_trial` on a
    CUDA ``device``; None on the CPU, whose plain version needs none."""
    device = torch.device(device)
    if device.type == "cpu":
        return None
    return torch.zeros(WORK_SLOTS, dtype=torch.float32, device=device)


def _require(ok: bool, what: str) -> None:
    if not ok:
        raise ValueError(what)


def _check_rows(name: str, t: torch.Tensor, n: int, cols: int | None, device) -> None:
    shape = (n,) if cols is None else (n, cols)
    _require(t.dtype == torch.float32 and t.device == device and tuple(t.shape) == shape
             and (cols is None or t.stride(1) == 1),
             f"{name} must be a float32 tensor of shape {shape} on {device} "
             "(rows at any stride, each row contiguous)")


def lm_trial(x, lam, nu, h, b, error, mu_b, n_b, m0, weight, points,
             rotation_epsilon: float, transformation_epsilon: float, plane_eps: float,
             work: torch.Tensor | None = None) -> torch.Tensor:
    """Wrapper of kernel K7: one LM trial as :func:`lm_trial_plain`, with
    ``x`` [4, 4], ``lam`` and ``nu`` (0-d) float32 updated in place, and
    the [accept, converged] bool flags returned.

    ``h`` [6, 6] contiguous, ``b`` [6], ``error`` 0-d: the linearization;
    ``mu_b``, ``n_b``, ``m0`` [N, 3] and ``weight`` [N]: its frozen
    correspondences (rows at any stride, so views of K3's payload go in as
    they are); ``points`` [N, 3]: the source. A CUDA tensor launches the
    kernel on the current stream with ``work`` (:func:`workspace`, on the
    same device, used by one launch at a time): no allocation but the
    flags, no synchronization. The trial's error and rho stay in
    ``work[ERROR_SLOT]`` and ``work[RHO_SLOT]``."""
    dev = x.device
    if dev.type == "cpu":
        _count(launches, dev)
        return lm_trial_plain(x, lam, nu, h, b, error, mu_b, n_b, m0, weight, points,
                              rotation_epsilon, transformation_epsilon, plane_eps)
    _require(dev.type == "cuda", f"unsupported device {dev}")
    n = points.shape[0]
    for name, t, shape in (("x", x, (4, 4)), ("lam", lam, ()), ("nu", nu, ()), ("h", h, (6, 6)),
                           ("b", b, (6,)), ("error", error, ())):
        _require(t.dtype == torch.float32 and t.device == dev and tuple(t.shape) == shape
                 and t.is_contiguous(), f"{name} must be a contiguous float32 tensor of shape "
                 f"{shape} on {dev}")
    for name, t, cols in (("mu_b", mu_b, 3), ("n_b", n_b, 3), ("m0", m0, 3),
                          ("weight", weight, None), ("points", points, 3)):
        _check_rows(name, t, n, cols, dev)
    _require(work is not None and work.dtype == torch.float32 and work.device == dev
             and tuple(work.shape) == (WORK_SLOTS,) and work.is_contiguous(),
             f"work must be lm_trial's workspace on {dev} (cuda_lm.workspace)")
    flags = torch.empty(2, dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.library().dlo_lm_trial(
            h.data_ptr(), b.data_ptr(), error.data_ptr(), x.data_ptr(), lam.data_ptr(),
            nu.data_ptr(), mu_b.data_ptr(), mu_b.stride(0), n_b.data_ptr(), n_b.stride(0),
            m0.data_ptr(), m0.stride(0), weight.data_ptr(), weight.stride(0),
            points.data_ptr(), points.stride(0), n,
            float(np.float32(rotation_epsilon)), float(np.float32(transformation_epsilon)),
            float(np.float32(1.0 - plane_eps)), work.data_ptr(), flags.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    cuda_build.check(err, "lm_trial")
    _count(launches, dev)
    return flags


def reorthonormalize(x: torch.Tensor) -> torch.Tensor:
    """:func:`reorthonormalize_plain` of one float32 [4, 4] pose, as a new
    tensor: on a CUDA tensor one launch of one thread (the plain version
    is ~80 operations), on a CPU tensor the plain version."""
    dev = x.device
    if dev.type == "cpu":
        _count(reorth_launches, dev)
        return reorthonormalize_plain(x)
    _require(dev.type == "cuda", f"unsupported device {dev}")
    _require(x.dtype == torch.float32 and tuple(x.shape) == (4, 4),
             f"x must be a float32 [4, 4] tensor, got {x.dtype} {tuple(x.shape)}")
    x = x.contiguous()
    out = torch.empty((4, 4), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = cuda_build.library().dlo_reorthonormalize(
            x.data_ptr(), out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_build.check(err, "reorthonormalize")
    _count(reorth_launches, dev)
    return out
