"""SO(3)/SE(3) primitives on tensors, batched over leading dimensions.

Counterpart of the JAX package's ``core/se3.py``: the reference's
Sophus-derived helpers (``include/nano_gicp/gicp/so3.hpp:50-118``) plus the
quaternion kinematics of the odometry node. Small-angle cases use
``torch.where`` selects rather than Python branches, so the functions never
read a device value on the host.

Quaternions are ``[w, x, y, z]`` (Hamilton convention).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def skew(v: torch.Tensor) -> torch.Tensor:
    """Cross-product matrix. v: [..., 3] -> [..., 3, 3]."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential so(3) -> SO(3), small-angle safe. [..., 3] -> [..., 3, 3]."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    # Taylor: A ~ 1 - t^2/6, B ~ 1/2 - t^2/24
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    k = skew(w)
    kk = k @ k
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(k.shape)
    return eye + a[..., None, None] * k + b[..., None, None] * kk


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Logarithm map SO(3) -> so(3) (rotation vector). [..., 3, 3] -> [..., 3]."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    v = torch.stack(
        [
            r[..., 2, 1] - r[..., 1, 2],
            r[..., 0, 2] - r[..., 2, 0],
            r[..., 1, 0] - r[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = torch.sin(theta)
    small = theta < 1e-4
    near_pi = theta > math.pi - 1e-3
    denom = torch.where(sin_t == 0, torch.ones_like(sin_t), 2.0 * sin_t)
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / denom)
    w_generic = v * scale[..., None]
    # theta ~ pi: R ~ I + 2 [n]x^2 => n^2_i = (R_ii + 1)/2
    diag = torch.stack([r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]], dim=-1)
    n_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    sx = torch.ones_like(n_abs[..., 0])
    sy = torch.where(r[..., 0, 1] + r[..., 1, 0] < 0, -1.0, 1.0)
    sz = torch.where(r[..., 0, 2] + r[..., 2, 0] < 0, -1.0, 1.0)
    n_pi = n_abs * torch.stack([sx, sy, sz], dim=-1).to(r.dtype)
    n_pi = n_pi / torch.clamp(torch.linalg.norm(n_pi, dim=-1, keepdim=True), min=_EPS)
    w_pi = n_pi * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w_generic)


# ---------------------------------------------------------------------------
# Quaternions [w, x, y, z]
# ---------------------------------------------------------------------------

def quat_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_mul(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product. [..., 4] x [..., 4] -> [..., 4]."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] -> [..., 3, 3]; q need not be exactly normalized."""
    q = quat_normalize(q)
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(r: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] -> [..., 4] (w >= 0). Branchless Shepperd via candidate select."""
    m00, m01, m02 = r[..., 0, 0], r[..., 0, 1], r[..., 0, 2]
    m10, m11, m12 = r[..., 1, 0], r[..., 1, 1], r[..., 1, 2]
    m20, m21, m22 = r[..., 2, 0], r[..., 2, 1], r[..., 2, 2]
    tr = m00 + m11 + m22
    # four candidate 4*|q_i|^2 values
    qw2 = 1.0 + tr
    qx2 = 1.0 + m00 - m11 - m22
    qy2 = 1.0 - m00 + m11 - m22
    qz2 = 1.0 - m00 - m11 + m22
    # candidates (unnormalized), one per dominant component
    cw = torch.stack([qw2, m21 - m12, m02 - m20, m10 - m01], dim=-1)
    cx = torch.stack([m21 - m12, qx2, m01 + m10, m02 + m20], dim=-1)
    cy = torch.stack([m02 - m20, m01 + m10, qy2, m12 + m21], dim=-1)
    cz = torch.stack([m10 - m01, m02 + m20, m12 + m21, qz2], dim=-1)
    mags = torch.stack([qw2, qx2, qy2, qz2], dim=-1)
    idx = torch.argmax(mags, dim=-1)
    cand = torch.stack([cw, cx, cy, cz], dim=-2)  # [..., 4cand, 4comp]
    q = torch.take_along_dim(cand, idx[..., None, None], dim=-2)[..., 0, :]
    q = quat_normalize(q)
    # canonical sign: w >= 0
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0).to(q.dtype)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors by quaternion: [..., 4], [..., 3] -> [..., 3]."""
    qv = q[..., 1:]
    uv = torch.linalg.cross(qv, v)
    uuv = torch.linalg.cross(qv, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_angle_deg(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Rotation angle between two quaternions in degrees (``odom.cc:1136-1140``)."""
    dq = quat_mul(q1, quat_conj(q2))
    vec_norm = torch.linalg.norm(dq[..., 1:], dim=-1)
    theta = 2.0 * torch.atan2(vec_norm, dq[..., 0])
    theta = torch.where(theta > math.pi, 2 * math.pi - theta, theta)
    return torch.abs(theta) * (180.0 / math.pi)


def quat_from_two_vectors(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating vector a onto b (Eigen FromTwoVectors; gravity
    alignment, reference ``odom.cc:556-560``)."""
    a = a / torch.clamp(torch.linalg.norm(a, dim=-1, keepdim=True), min=_EPS)
    b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=_EPS)
    c = torch.linalg.cross(a, b)
    w = 1.0 + torch.sum(a * b, dim=-1)
    q = torch.cat([w[..., None], c], dim=-1)
    # antiparallel fallback: rotate pi about any axis orthogonal to a
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=a.dtype, device=a.device).expand(a.shape)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=a.dtype, device=a.device).expand(a.shape)
    ortho = torch.linalg.cross(a, ex)
    ortho = torch.where(
        torch.linalg.norm(ortho, dim=-1, keepdim=True) < 1e-6, torch.linalg.cross(a, ey), ortho
    )
    q_pi = torch.cat([torch.zeros_like(w[..., None]), ortho], dim=-1)
    q = torch.where((w < 1e-6)[..., None], q_pi, q)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SE(3) as 4x4 homogeneous matrices
# ---------------------------------------------------------------------------

def make_se3(r: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3], [..., 3] -> [..., 4, 4]."""
    batch = torch.broadcast_shapes(r.shape[:-2], t.shape[:-1])
    r = r.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([r, t[..., :, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=r.dtype, device=r.device)
    return torch.cat([top, bottom.expand(batch + (1, 4))], dim=-2)


def se3_identity(dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(4, dtype=dtype, device=device)


def se3_inverse(t: torch.Tensor) -> torch.Tensor:
    r = t[..., :3, :3]
    p = t[..., :3, 3]
    r_t = r.transpose(-1, -2)
    return make_se3(r_t, -(r_t @ p[..., None])[..., 0])


def se3_rotation(t: torch.Tensor) -> torch.Tensor:
    return t[..., :3, :3]


def se3_translation(t: torch.Tensor) -> torch.Tensor:
    return t[..., :3, 3]


def transform_points(t: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply SE(3) to points: [4, 4], [..., 3] -> [..., 3]; or B lanes'
    poses to their clouds: [B, 4, 4], [B, N, 3] -> [B, N, 3]."""
    return pts @ t[..., :3, :3].mT + t[..., None, :3, 3]


def se3_exp(tau: torch.Tensor) -> torch.Tensor:
    """Twist [rot(3), trans(3)] -> 4x4 with the reference's update
    parameterization ``delta = (so3_exp(d[0:3]), d[3:6])``
    (``lsq_registration_impl.hpp:150-153, 175-178``): the translation is
    applied directly, NOT via the SE(3) V-matrix (a pseudo-exponential)."""
    r = so3_exp(tau[..., :3])
    return make_se3(r, tau[..., 3:6])
