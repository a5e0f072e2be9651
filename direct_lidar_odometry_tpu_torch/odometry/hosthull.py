"""Exact host-side hull membership (QHull) — fidelity path for submap hulls.

A copy of the JAX package's ``odometry/hosthull.py`` (numpy/scipy only):
importing it from there would run that package's ``odometry/__init__``,
which imports the jitted pipeline and with it jax.

The reference computes true convex and concave (alpha-shape) hulls of the
keyframe positions with PCL/QHull every frame (``odom.cc:1017-1090``).
The device surrogate in hulls.py is fast but direction-sampled: measured
convex recall vs QHull at K=512 is <0.4 on trajectory-shaped point sets
(near-planar "pancakes" whose rim vertices have thin support cones).

This module restores exact semantics by running scipy.spatial (the same
QHull engine PCL wraps) on the HOST, off the device hot path: the runner
fetches keyframe positions asynchronously (tiny [K,3] transfer, one frame
behind — the reference already tolerates submap staleness via its
``submap_hasChanged`` gating, ``odom.cc:1309``) and feeds the membership
masks into the per-frame step as inputs. When no fresh mask is available
(first frames), the step falls back to the device surrogate.

Alpha-shape semantics follow PCL's ConcaveHull: Delaunay triangulation,
keep simplices with circumradius < alpha, boundary = points on faces
owned by exactly one kept simplex (``pcl/surface/concave_hull`` behavior,
alpha = the adaptive keyframe threshold, ``odom.cc:1063``). Near-planar
keyframe sets make 3D Delaunay ill-conditioned, so degenerate inputs fall
back 3D -> 2D(xy) -> convex, mirroring QHull's own QJ jitter tolerance.
"""

from __future__ import annotations

import numpy as np

# import at module load, NOT inside the hull functions: a lazy first-use
# import of scipy.spatial lands exactly when the first submap hull is
# rebuilt mid-sequence and stalls that frame
from scipy.spatial import ConvexHull, Delaunay, QhullError


def convex_membership_host(positions: np.ndarray) -> np.ndarray:
    """[K, 3] -> [K] bool, exact convex-hull vertex membership.

    Mirrors ``computeConvexHull`` gating: <4 points -> empty
    (``odom.cc:1019-1022``).
    """
    k = len(positions)
    out = np.zeros((k,), bool)
    if k < 4:
        return out
    try:
        hull = ConvexHull(positions, qhull_options="QJ")
        out[hull.vertices] = True
    except QhullError:
        try:  # collinear/planar degeneracy: fall back to the xy rim
            hull = ConvexHull(positions[:, :2], qhull_options="QJ")
            out[hull.vertices] = True
        except QhullError:
            out[:] = True  # fully degenerate: every point is boundary
    return out


def _circumradii(points: np.ndarray, simplices: np.ndarray) -> np.ndarray:
    """Circumradius of each d-simplex ([M, d+1] indices into [K, d])."""
    p0 = points[simplices[:, 0]]  # [M, d]
    rest = points[simplices[:, 1:]] - p0[:, None, :]  # [M, d, d]
    rhs = 0.5 * np.sum(rest * rest, axis=-1)  # [M, d]
    centers = np.full(rhs.shape, np.inf)
    # solve rest @ c = rhs per simplex; singular (flat) simplices get inf
    det = np.abs(np.linalg.det(rest))
    good = det > 1e-12
    if good.any():
        centers[good] = np.linalg.solve(
            rest[good], rhs[good][..., None]
        )[..., 0]
    return np.linalg.norm(centers, axis=-1)


def concave_membership_host(positions: np.ndarray, alpha: float) -> np.ndarray:
    """[K, 3], alpha -> [K] bool, alpha-shape boundary membership.

    Mirrors ``computeConcaveHull`` gating: <5 points -> empty
    (``odom.cc:1059-1062``).
    """
    k = len(positions)
    out = np.zeros((k,), bool)
    if k < 5:
        return out
    # PCL's ConcaveHull detects the input's effective dimension by PCA and
    # reconstructs planar clouds in 2D (pcl/surface/concave_hull
    # performReconstruction) — 3D alpha shapes of near-planar sets are
    # degenerate (every tetrahedron is flat, huge circumradius). Keyframe
    # position sets from ground robots are exactly that case.
    c = positions - positions.mean(axis=0)
    _, s, vt = np.linalg.svd(c, full_matrices=False)
    planar = s[2] < 0.05 * max(s[0], 1e-9)
    pts = c @ vt[:2].T if planar else positions
    try:
        tri = Delaunay(pts, qhull_options="QJ")
    except QhullError:
        pts = c @ vt[:2].T
        try:
            tri = Delaunay(pts, qhull_options="QJ")
        except QhullError:
            return convex_membership_host(positions)

    simp = tri.simplices  # [M, d+1]
    keep = _circumradii(pts, simp) < float(alpha)
    if not keep.any():
        # alpha smaller than every simplex: PCL returns an empty cloud;
        # submap selection then just gets no concave members this frame
        return out
    d1 = simp.shape[1]
    # faces = simplices minus one vertex; boundary faces belong to exactly
    # one KEPT simplex (either unshared, or shared with a dropped one)
    faces = {}
    kept = simp[keep]
    for drop in range(d1):
        f = np.delete(kept, drop, axis=1)
        f.sort(axis=1)
        for row in f:
            key = tuple(row)
            faces[key] = faces.get(key, 0) + 1
    for key, cnt in faces.items():
        if cnt == 1:
            out[list(key)] = True
    return out


def host_hull_masks(
    positions: np.ndarray, count: int, alpha: float, capacity: int
) -> tuple[np.ndarray, np.ndarray]:
    """Convenience: ([K,3] ring, occupancy, alpha) -> padded (cvx, ccv)."""
    cvx = np.zeros((capacity,), bool)
    ccv = np.zeros((capacity,), bool)
    n = int(count)
    if n > 0:
        p = np.asarray(positions[:n], np.float64)
        cvx[:n] = convex_membership_host(p)
        ccv[:n] = concave_membership_host(p, alpha)
    return cvx, ccv
