"""Plain PyTorch geometry of the odometry check: the scan reduction, the
keyframe clouds, radius normals, the exact 1-NN search and a Gauss-Newton
GICP solve.

Written from the DLO semantics (crop box, voxel-centroid filters, PLANE
covariances ``I - (1 - eps) n n^T``, Mahalanobis-weighted point pairs) and
the port's documented data layout (the 16-bit transfer encoding, the
Z-order and scrambled-id voxel orders and their capacity policies). It
imports torch only: nothing of the port, of JAX or of the JAX package.

:class:`Arith` fixes the precision of the matrix products (point
transforms, pose compositions, the normal equations): float64 for the
judge, float32 for a plain float32 run, and float32 with every product's
inputs rounded to TF32 (10 explicit mantissa bits) for the lower-precision
control. Searches and voxel keys are exact in every mode.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

PLANE_EPS = 1e-3
GRID_DIM = 1024
MASK32 = 0xFFFFFFFF


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> float32 rounded to nearest-even at TF32's 10 mantissa bits."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


@dataclass(frozen=True)
class Arith:
    dtype: torch.dtype = torch.float64
    tf32: bool = False

    def cast(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        a, b = a.to(self.dtype), b.to(self.dtype)
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def einsum(self, eq: str, *ops: torch.Tensor) -> torch.Tensor:
        ops = tuple(o.to(self.dtype) for o in ops)
        if self.tf32:
            ops = tuple(tf32_round(o) for o in ops)
        return torch.einsum(eq, *ops)


JUDGE = Arith(torch.float64)
FLOAT32 = Arith(torch.float32)
CONTROL_TF32 = Arith(torch.float32, tf32=True)


# -- scan reduction ----------------------------------------------------------

def crop(points: torch.Tensor, size: float | None) -> torch.Tensor:
    """Finite points outside the sensor-centred box [-size, size]^3."""
    keep = torch.all(torch.isfinite(points), dim=-1)
    if size:
        keep &= ~torch.all(points.abs() <= size, dim=-1)
    return points[keep]


def _voxel_coords(points: torch.Tensor, res: float) -> torch.Tensor:
    origin = points.amin(dim=0, keepdim=True)
    return torch.clamp(torch.floor((points - origin) / res).to(torch.int64), 0, GRID_DIM - 1)


def _spread(x: torch.Tensor) -> torch.Tensor:
    x = x & 1023
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def morton_key(c: torch.Tensor) -> torch.Tensor:
    return _spread(c[:, 0]) | (_spread(c[:, 1]) << 1) | (_spread(c[:, 2]) << 2)


def _mul32(h: torch.Tensor, const: int) -> torch.Tensor:
    lo = h * (const & 0xFFFF)
    hi = ((h * (const >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK32


def scrambled_key(c: torch.Tensor) -> torch.Tensor:
    """Murmur finalizer of the linear voxel id (a bijection on 32 bits)."""
    h = (c[:, 0] + GRID_DIM * (c[:, 1] + GRID_DIM * c[:, 2])) & MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def voxel_centroids(points: torch.Tensor, res: float, cap: int, order: str) -> torch.Tensor:
    """Centroid of every occupied voxel (origin: the cloud's min corner,
    1024 cells an axis), sums in float64. Voxels in ascending key order;
    beyond ``cap`` voxels, ``order="morton"`` keeps an even stride along
    the Z-curve (voxel i kept iff (i * cap) mod S < cap) and
    ``order="scrambled"`` the first ``cap`` in scrambled-id order."""
    if len(points) == 0:
        return points.reshape(0, 3)
    c = _voxel_coords(points, res)
    key = morton_key(c) if order == "morton" else scrambled_key(c)
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    s = len(uniq)
    sums = torch.zeros((s, 3), dtype=torch.float64, device=points.device)
    sums.index_add_(0, inv, points.to(torch.float64))
    counts = torch.bincount(inv, minlength=s).to(torch.float64)
    cent = (sums / counts[:, None]).to(torch.float32)
    if s <= cap:
        return cent
    if order == "morton":
        i = torch.arange(s, device=points.device, dtype=torch.int64)
        return cent[(i * cap) % s < cap]
    return cent[:cap]


def wire_roundtrip(points: torch.Tensor) -> torch.Tensor:
    """The 16-bit transfer encoding and its decode: per axis lo = min,
    scale = max(extent, 1e-6) / 65535, q = round((p - lo) * (1 / scale)),
    p' = q * scale + lo, all float32."""
    if len(points) == 0:
        return points
    p = points.to(torch.float32)
    lo = p.amin(dim=0)
    scale = torch.clamp(p.amax(dim=0) - lo, min=1e-6) / 65535.0
    q = torch.round(torch.clamp((p - lo) * (1.0 / scale), 0.0, 65535.0))
    return q * scale + lo


def reduce_scan(raw: torch.Tensor, cfg: dict, wire: bool) -> torch.Tensor:
    """Raw sensor-frame scan -> the registration scan: crop, voxel centroids
    in Z-order capped at n_scan, and (``wire``) the transfer encoding that
    a host-preprocessed scan travels in."""
    pre = cfg["preprocessing"]
    pts = crop(raw.to(torch.float32), pre["crop"]["size"] if pre["crop"]["use"] else None)
    pts = voxel_centroids(pts, pre["voxel_scan"]["res"], cfg["shapes"]["n_scan"], "morton")
    return wire_roundtrip(pts) if wire else pts


# -- poses ---------------------------------------------------------------------

def skew(v: torch.Tensor) -> torch.Tensor:
    z = torch.zeros_like(v[..., 0])
    x, y, w = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack([torch.stack([z, -w, y], -1), torch.stack([w, z, -x], -1),
                        torch.stack([-y, x, z], -1)], -2)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    theta = torch.linalg.norm(w)
    k = skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    if float(theta) < 1e-12:
        return eye + k
    return eye + torch.sin(theta) / theta * k + (1 - torch.cos(theta)) / theta**2 * (k @ k)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    q = q.to(torch.float64)
    w, x, y, z = (q / torch.linalg.norm(q)).unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ], -2)


def pose_matrix(rot: torch.Tensor, trans: torch.Tensor) -> torch.Tensor:
    out = torch.eye(4, dtype=rot.dtype, device=rot.device)
    out[:3, :3] = rot
    out[:3, 3] = trans.to(rot.dtype)
    return out


def inverse(t: torch.Tensor) -> torch.Tensor:
    r = t[:3, :3].mT
    return pose_matrix(r, -(r @ t[:3, 3]))


def transform(t: torch.Tensor, pts: torch.Tensor, arith: Arith) -> torch.Tensor:
    return arith.mm(pts, t[:3, :3].mT) + arith.cast(t[:3, 3])


# -- normals and search --------------------------------------------------------

def radius_normals(points: torch.Tensor, radius: float, min_neighbors: int = 4,
                   block: int = 2048) -> tuple[torch.Tensor, torch.Tensor]:
    """Unit normal (smallest eigenvector of the neighbourhood covariance) of
    every point from ALL points within ``radius``, the point itself
    counted; valid with at least ``min_neighbors``. float64, about the
    cloud's mean for conditioning."""
    p = points.to(torch.float64)
    p = p - p.mean(dim=0) if len(p) else p
    normals = torch.zeros_like(p)
    valid = torch.zeros(len(p), dtype=torch.bool, device=p.device)
    r2 = radius * radius
    for a in range(0, len(p), block):
        q = p[a:a + block]
        w = (torch.cdist(q, p) ** 2 <= r2).to(torch.float64)       # [b, N]
        n = w.sum(dim=1)
        mean = (w @ p) / n[:, None]
        second = (w @ (p[:, :, None] * p[:, None, :]).reshape(-1, 9)).reshape(-1, 3, 3)
        cov = second / n[:, None, None] - mean[:, :, None] * mean[:, None, :]
        normals[a:a + block] = torch.linalg.eigh(cov).eigenvectors[..., 0]
        valid[a:a + block] = n >= min_neighbors
    return normals, valid


def nearest(queries: torch.Tensor, targets: torch.Tensor, block: int = 4096):
    """Exact 1-NN of each query among the targets (float64): (index, distance)."""
    q = queries.to(torch.float64)
    t = targets.to(torch.float64)
    idx = torch.zeros(len(q), dtype=torch.int64, device=q.device)
    if len(t) == 0:
        return idx, torch.full((len(q),), torch.inf, dtype=torch.float64, device=q.device)
    centre = t.mean(dim=0)
    q, t = q - centre, t - centre
    for a in range(0, len(q), block):
        idx[a:a + block] = torch.cdist(q[a:a + block], t).argmin(dim=1)
    return idx, torch.linalg.norm(q - t[idx], dim=1)


@dataclass
class Cloud:
    """Points with their PLANE normals ([N, 3], [N, 3], [N] valid)."""

    points: torch.Tensor
    normals: torch.Tensor
    valid: torch.Tensor


def gicp_solve(src: Cloud, tgt: Cloud, x0: torch.Tensor, gate: float, arith: Arith,
               max_iter: int = 60, tol: float = 1e-9):
    """GICP with PLANE covariances by Gauss-Newton, correspondences (the
    nearest target within ``gate``, both normals valid) found again every
    iteration; stops when the step's largest entry is below ``tol``.
    Returns (pose [4, 4] float64, the correspondences at the last
    iteration: source mask [Ns] and target index [Ns])."""
    x = x0.to(torch.float64).clone()
    eye3 = torch.eye(3, dtype=arith.dtype, device=x.device)
    ok = torch.zeros(len(src.points), dtype=torch.bool, device=x.device)
    idx = torch.zeros(len(src.points), dtype=torch.int64, device=x.device)
    for _ in range(max_iter):
        xa = arith.cast(x)
        p_t = transform(xa, src.points, arith)
        idx, dist = nearest(p_t, tgt.points)
        ok = (dist <= gate) & src.valid & (tgt.valid[idx] if len(tgt.valid) else False)
        if int(ok.sum()) < 6:
            break
        p_t, j = p_t[ok], idx[ok]
        nb = arith.cast(tgt.normals[j])
        na = arith.mm(arith.cast(src.normals[ok]), xa[:3, :3].mT)
        cov = 2 * eye3 - (1 - PLANE_EPS) * (nb[:, :, None] * nb[:, None, :]
                                            + na[:, :, None] * na[:, None, :])
        m = torch.linalg.inv(cov)
        e = arith.cast(tgt.points[j]) - p_t
        s = skew(p_t)
        ms = arith.einsum("nij,njk->nik", m, s)
        h_tl = arith.einsum("nji,njk->ik", s, ms)
        h_tr = -arith.einsum("nji,njk->ik", s, m)
        h = torch.cat([torch.cat([h_tl, h_tr], 1), torch.cat([h_tr.mT, m.sum(0)], 1)], 0)
        me = arith.einsum("nij,nj->ni", m, e)
        b = torch.cat([arith.einsum("nji,nj->i", s, me), -me.sum(0)])
        d = torch.linalg.solve(h.to(torch.float64), -b.to(torch.float64))
        delta = pose_matrix(so3_exp(d[:3]), d[3:])
        x = arith.mm(arith.cast(delta), arith.cast(x)).to(torch.float64)
        if float(d.abs().max()) < tol:
            break
    return x, ok, idx
