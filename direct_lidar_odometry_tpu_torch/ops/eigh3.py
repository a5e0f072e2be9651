"""Closed-form symmetric 3x3 eigen-analysis, batched.

Counterpart of the JAX package's ``ops/eigh3.py``: the trigonometric
(Cardano) closed form for the eigenvalues and cross-product eigenvectors,
elementwise over the batch. Under PLANE regularization only the smallest
eigenvector (the surface normal) matters. Its sign is arbitrary.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def eigvalsh3(a: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric [..., 3, 3], ascending. Trigonometric method."""
    a00, a11, a22 = a[..., 0, 0], a[..., 1, 1], a[..., 2, 2]
    a01, a02, a12 = a[..., 0, 1], a[..., 0, 2], a[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22 + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    detb = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(detb / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def _eigvec_for(a: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector of symmetric [..., 3, 3] for eigenvalue lam [...]: the
    largest cross product of two rows of (A - lam I); degenerate cases fall
    back to the z axis."""
    eye = torch.eye(3, dtype=a.dtype, device=a.device)
    m = a - lam[..., None, None] * eye
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    norms = torch.stack(
        [torch.sum(c * c, dim=-1) for c in (c01, c02, c12)], dim=-1
    )
    best = torch.argmax(norms, dim=-1)
    cands = torch.stack([c01, c02, c12], dim=-2)  # [..., 3cand, 3]
    v = torch.take_along_dim(cands, best[..., None, None], dim=-2)[..., 0, :]
    nrm = torch.linalg.norm(v, dim=-1, keepdim=True)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=a.dtype, device=a.device)
    return torch.where(nrm > 1e-12, v / torch.clamp(nrm, min=_EPS), z)


def smallest_eigvec3(a: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(unit eigenvector of the smallest eigenvalue, eigenvalues ascending)."""
    evals = eigvalsh3(a)
    return _eigvec_for(a, evals[..., 0]), evals
