"""The check that decides ``correct``: the port's poses and keyframe map
against the plain reference (``geometry.py``), frame by frame.

The reference follows the program from the program's own state: for a
judged frame it takes which keyframes the port's submap held and the
keyframe ring's poses (a capture made right after that frame), and works
out again everything else from the benchmark's raw scans and the port's
emitted poses: the scan reduction, the keyframe clouds (built at the pose
emitted at their spawn frame, then moved by the ring's re-anchoring), all
normals, and the S2M registration. It reads the port's outputs only to
judge them. Numbers of one judged frame:

- ``pose_gap_m``: how far the port's pose puts the scan from where the
  reference's converged S2M pose (started from the port's pose, against
  the reference's own copy of the submap) puts it, along the surfaces'
  normals: the root mean square, over the reference's S2M pairs, of each
  source point's displacement between the two poses projected on its
  target normal. Sliding along a surface, which S2M cannot see and where
  the configuration's stopping rule leaves the solver its slack, does not
  count; the scan moving off the map does;
- ``submap_off_share``: the share of the port's submap points farther
  than ``MATCH_M`` from the reference's keyframe clouds of the same slots;
- ``s2m_corr``: the reference's S2M correspondences at its pose.

The lower-precision control puts this reference in the program's place,
computed in float32 with TF32 products (:func:`control_frame`).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference import geometry as geo

MATCH_M = 1e-3  # a submap point is the reference's when within 1 mm of it
MIN_CORR = 100  # fewer S2M correspondences: the frame tracked nothing


@dataclass
class Capture:
    """The program's state right after a judged frame (CPU or device tensors)."""

    frame: int                 # index of the frame in its drive
    submap_points: torch.Tensor
    submap_mask: torch.Tensor
    members: torch.Tensor      # [K] bool: ring slots in the submap
    kf_positions: torch.Tensor  # [K, 3]
    kf_quats: torch.Tensor     # [K, 4] wxyz
    kf_seq: torch.Tensor       # [K] spawn frame of each slot


class Drive:
    """One drive as the judge sees it: raw scans by frame (device tensors),
    the port's emitted poses by frame (float64 [4, 4]), and whether its
    scans travelled in the 16-bit wire encoding."""

    def __init__(self, cfg: dict, raw_scan, poses, wire: bool, device):
        self.cfg = cfg
        self.raw_scan = raw_scan   # frame -> [M, 3] float32 tensor of returns
        self.poses = poses         # frame -> [4, 4] float64 tensor
        self.wire = wire
        self.device = torch.device(device)
        self._scans: dict[int, geo.Cloud] = {}
        self._kf: dict[tuple, geo.Cloud] = {}

    def scan(self, frame: int) -> geo.Cloud:
        if frame not in self._scans:
            pts = geo.reduce_scan(self.raw_scan(frame).to(self.device), self.cfg, self.wire)
            res = self.cfg["preprocessing"]["voxel_scan"]["res"]
            n, v = geo.radius_normals(pts, 3.0 * res)
            self._scans[frame] = geo.Cloud(pts, n, v)
        return self._scans[frame]

    def keyframe(self, seq: int, arith: geo.Arith) -> geo.Cloud:
        """The keyframe cloud spawned at frame ``seq``, world frame at the
        emitted pose: the scan moved by the pose, submap-voxel centroids
        (scrambled order, n_keyframe), radius normals (3 x the voxel)."""
        key = (seq, arith)
        if key not in self._kf:
            cfg = self.cfg
            res = cfg["preprocessing"]["voxel_submap"]["res"]
            world = geo.transform(self.poses(seq).to(self.device), self.scan(seq).points, arith)
            pts = geo.voxel_centroids(world.to(torch.float32), res, cfg["shapes"]["n_keyframe"],
                                      "scrambled")
            n, v = geo.radius_normals(pts, 3.0 * res)
            self._kf[key] = geo.Cloud(pts, n, v)
        return self._kf[key]

    def submap(self, cap: Capture, arith: geo.Arith) -> geo.Cloud:
        """The member keyframes' clouds, each moved from its emitted spawn
        pose to the ring's pose (a loop-closure round re-anchors the ring)."""
        parts = []
        slots = torch.nonzero(cap.members.cpu()).flatten().tolist()
        for k in slots:
            seq = int(cap.kf_seq[k])
            kf = self.keyframe(seq, arith)
            ring = geo.pose_matrix(geo.quat_to_rot(cap.kf_quats[k].cpu()),
                                   cap.kf_positions[k].cpu().to(torch.float64))
            move = (ring @ geo.inverse(self.poses(seq).cpu().to(torch.float64))).to(self.device)
            pts = geo.transform(move, kf.points, arith).to(torch.float32)
            nrm = kf.normals.to(torch.float64) @ move[:3, :3].mT
            parts.append(geo.Cloud(pts, nrm, kf.valid))
        if not parts:
            z = torch.zeros((0, 3), device=self.device)
            return geo.Cloud(z, z.double(), torch.zeros(0, dtype=torch.bool, device=self.device))
        return geo.Cloud(*(torch.cat([getattr(p, f) for p in parts])
                           for f in ("points", "normals", "valid")))


def _gap(a: torch.Tensor, b: torch.Tensor, pts: torch.Tensor, normals: torch.Tensor) -> float:
    """Root mean square of the displacement of ``pts`` between poses ``a``
    and ``b`` along ``normals`` (one per point)."""
    if not len(pts):
        return float("inf")
    p = pts.to(torch.float64)
    d = geo.transform(a.to(p.device), p, geo.JUDGE) - geo.transform(b.to(p.device), p, geo.JUDGE)
    along = (d * normals.to(d)).sum(dim=1)
    return float(torch.sqrt((along * along).mean()))


def _matched_target(drive: Drive, cap: Capture, ref: geo.Cloud, pts: torch.Tensor):
    """The reference's submap points nearest to ``pts`` (the submap the
    frame registered against), and the share of ``pts`` off them."""
    idx, dist = geo.nearest(pts, ref.points)
    target = geo.Cloud(ref.points[idx], ref.normals[idx], ref.valid[idx])
    off = float((dist > MATCH_M).to(torch.float64).mean()) if len(pts) else 1.0
    return target, off


def judge_frame(drive: Drive, cap: Capture) -> dict:
    """The judge's numbers for the port's pose and submap at one frame."""
    gate = drive.cfg["gicp"]["s2m"]["max_correspondence_distance"]
    ref = drive.submap(cap, geo.FLOAT32)
    pts = cap.submap_points.to(drive.device)[cap.submap_mask.to(drive.device)]
    target, off = _matched_target(drive, cap, ref, pts)
    src = drive.scan(cap.frame)
    port = drive.poses(cap.frame).to(torch.float64)
    if not bool(torch.isfinite(port).all()):
        return {"pose_gap_m": float("inf"), "submap_off_share": off, "s2m_corr": 0}
    pose, ok, idx = geo.gicp_solve(src, target, port.to(drive.device), gate, geo.JUDGE)
    pairs = (src.points[ok], target.normals[idx[ok]])
    return {"pose_gap_m": _gap(port, pose, *pairs), "submap_off_share": off,
            "s2m_corr": int(ok.sum()), "judge_pose": pose, "pairs": pairs}


def control_frame(drive: Drive, cap: Capture, judged: dict) -> dict:
    """The control: this reference, in float32 with TF32 products, in the
    program's place at the same frame, judged as the port is."""
    gate = drive.cfg["gicp"]["s2m"]["max_correspondence_distance"]
    ref = drive.submap(cap, geo.FLOAT32)
    low = drive.submap(cap, geo.CONTROL_TF32)
    _, off = _matched_target(drive, cap, ref, low.points)
    pts = cap.submap_points.to(drive.device)[cap.submap_mask.to(drive.device)]
    idx, _ = geo.nearest(pts, low.points)
    target = geo.Cloud(low.points[idx], low.normals[idx], low.valid[idx])
    src = drive.scan(cap.frame)
    start = drive.poses(cap.frame).to(torch.float64).to(drive.device)
    pose, _, _ = geo.gicp_solve(src, target, start, gate, geo.CONTROL_TF32, tol=1e-6)
    return {"pose_gap_m": _gap(pose, judged["judge_pose"], *judged["pairs"]),
            "submap_off_share": off}


def summarize(frames: list[dict], lost: int) -> dict:
    """A run's numbers: the widest and the median ``pose_gap_m`` and the
    widest ``submap_off_share`` over the judged frames, and the frames
    lost (no finite pose, or a judged frame with too few S2M pairs)."""
    gaps = torch.tensor([f["pose_gap_m"] for f in frames], dtype=torch.float64)
    lost += sum(1 for f in frames if f.get("s2m_corr", MIN_CORR) < MIN_CORR)
    return {
        "pose_gap_max_m": float(gaps.max()) if len(gaps) else float("inf"),
        "pose_gap_median_m": float(gaps.median()) if len(gaps) else float("inf"),
        "submap_off_share": max((f["submap_off_share"] for f in frames), default=1.0),
        "lost_frames": lost,
    }
