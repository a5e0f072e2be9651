"""The plain reference of one loop-closure round, and the judge's view of it.

The round (the port's ``odometry/loopclosure.refine_and_reanchor``, run by
the runner's trigger) is followed from the program's own state, as
``judge.py`` follows a frame: the harness records the ring before the
round, the candidate pairs, each loop edge's measured ``Z_ij`` and weight,
and the program's copy of each edge's target cloud (:class:`Round`). From
that the reference works out the round again:

1. :func:`candidates`: the eligible keyframe pairs of the pre-round ring
   (both slots live, insertion-rank gap >= ``min_index_gap``, spawn-frame
   gap >= ``min_seq_gap``, distance < ``loop_radius``), the closest
   ``max_loops``, in float64;
2. each accepted loop edge is judged like an S2M frame
   (:class:`EdgeDrive`): cloud j of the reference (``judge.Drive``'s
   keyframe cloud at the pre-round ring pose) registered onto its cloud i
   by a float64 GICP with the loop gate, started from the program's ``dT
   = X_i Z_ij X_j^-1``; ``pose_gap_m`` is the RMS gap along the target
   normals, ``submap_off_share`` the share of the program's cloud i (its
   ring slot, re-anchored by every earlier round) off the reference's;
   each candidate the program rejected is measured again by the loop
   stage as the program runs it (:meth:`RoundJudge.loop_fit`: float64
   GICP of cloud j onto cloud i from identity, the loop gate and
   iteration cap); where the reference clearly accepts it (converged, at
   least :data:`CORR_MARGIN` x ``min_loop_corr`` correspondences), the
   program dropped a good edge;
3. :func:`refine_ring`: the chain of consecutive keyframes (trajectory
   order, zero residual at the pre-round poses, weighted by spawn health)
   plus the program's accepted loop edges, solved by dense float64
   Gauss-Newton;
4. the re-anchoring: the frame the program judges after the round
   (:class:`RoundDrive`) is judged against the keyframe clouds at the
   reference's refined ring, not at the program's.

What a fault reads: a candidate set that is not the reference's, or a
candidate the program rejected that the reference clearly accepts, makes
the round's judged frame lost (no finite pose); an accepted edge whose gap
exceeds :data:`EDGE_GAP_M` is a wrong constraint and counts as lost, as a
frame that tracked nothing does (its gap alone would move the median of
the judged gaps only if most edges were wrong); a skipped or wrong solve,
or a skipped re-anchoring, moves the program's ring off the reference's
and shows in the submap and the pose of the frame after the round.

Departures from the program's arithmetic, all deliberate:

- float64 throughout (the program: float32, TF32 off);
- the graph holds only the live slots (the program solves all K slots,
  with the unused ones frozen by a 1e9 diagonal: their steps are zero);
- the edge Jacobians use the exact inverse right Jacobian of SO(3) (the
  program: ``I + skew(w) / 2``) and the solve is not equilibrated (the
  program scales the float32 system by its diagonal); after the
  configuration's iterations both stand at the same minimum;
- the candidate sets are compared as sets, and a pair within 1e-4 m of the
  radius or of the ``max_loops``-th distance may fall either way;
- a rejected candidate is measured by Gauss-Newton (the program: LM, as
  configured) and called converged when one more step moves less than
  :data:`CONVERGED_STEP` (the program: its stage's epsilons); one within
  :data:`CORR_MARGIN` of ``min_loop_corr``, or not converged, may fall
  either way.

The graph takes the program's ``Z_ij``, not the reference's own GICP
result: the program stops an align once a step is under its epsilons, a
few millimetres short of the float64 minimum on sparse clouds, and that
slack, carried through the solve, would move the ring by more than the
submap's 1 mm match. The control (``control.py``) runs the round's solve
in float32 with TF32 products. Imports torch only: nothing of the port.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from benchmark.reference import geometry as geo
from benchmark.reference import judge

DAMPING = 1e-4      # the program's Levenberg floor on H's diagonal (posegraph.refine)
PIN_WEIGHT = 1e6    # its gauge prior on slot 0's step
TIE_M = 1e-4        # a candidate this close to a cut may fall either way
EDGE_GAP_M = 0.01   # an accepted loop edge judged this far off is a wrong constraint
CORR_MARGIN = 1.25  # a rejected candidate this many times min_loop_corr is clearly good
CONVERGED_STEP = 1e-3  # rad and m: a fit whose next step is below this converged


@dataclass
class Round:
    """The program's state around one loop-closure round (CPU or device
    tensors), recorded without a host read."""

    frame: int                  # the last frame stepped before the round
    count: torch.Tensor         # [] live slots before the round
    positions: torch.Tensor     # [K, 3] the ring before the round
    quats: torch.Tensor         # [K, 4] wxyz
    seq: torch.Tensor           # [K] spawn frame of each slot
    health: torch.Tensor        # [K] spawn health
    edges: torch.Tensor         # [L, 2] candidate pairs (i earlier than j)
    mask: torch.Tensor          # [L] candidate validity
    rel: torch.Tensor           # [L, 4, 4] measured Z_ij
    weight: torch.Tensor        # [L] loop weight (0: rejected)
    cloud_i: torch.Tensor       # [L, Nk, 3] the program's target cloud of each edge
    cloud_i_mask: torch.Tensor  # [L, Nk]
    post_positions: torch.Tensor  # [K, 3] the ring after the round
    post_quats: torch.Tensor      # [K, 4]


def ring_poses(positions: torch.Tensor, quats: torch.Tensor) -> torch.Tensor:
    """[K, 4, 4] float64 poses of a ring's slots."""
    rot = torch.stack([geo.quat_to_rot(q) for q in quats.cpu()]) if len(quats) else \
        torch.zeros((0, 3, 3), dtype=torch.float64)
    out = torch.eye(4, dtype=torch.float64).repeat(len(rot), 1, 1)
    out[:, :3, :3] = rot
    out[:, :3, 3] = positions.cpu().to(torch.float64)
    return out


# -- 1. candidates ---------------------------------------------------------------

def candidates(positions, seq, count: int, pg: dict) -> tuple[set, set, int]:
    """(the pairs that must be candidates, the pairs that may be, the
    fewest there may be): the eligible (i, j) pairs of the ring, i the
    earlier by insertion rank, closest first, at most ``max_loops``; a
    pair within :data:`TIE_M` of the radius or of the last one's distance
    may fall either way."""
    pos = positions.cpu().to(torch.float64)[:count]
    sq = seq.cpu().to(torch.int64)[:count]
    rank = torch.empty(count, dtype=torch.int64)
    rank[torch.argsort(sq, stable=True)] = torch.arange(count)
    d = torch.cdist(pos, pos)
    ok = ((rank[None, :] > rank[:, None]) & (rank[None, :] - rank[:, None] >= pg["min_index_gap"])
          & ((sq[None, :] - sq[:, None]).abs() >= pg["min_seq_gap"])
          & (d < pg["loop_radius"] + TIE_M))
    i, j = torch.nonzero(ok, as_tuple=True)
    dist = d[i, j]
    pairs = [(int(i[o]), int(j[o]), float(dist[o])) for o in torch.argsort(dist, stable=True)]
    n = pg["max_loops"]
    cut = pairs[n - 1][2] if len(pairs) >= n else float("inf")
    inside = [p for p in pairs if p[2] < pg["loop_radius"] - TIE_M]
    sure = {(a, b) for a, b, x in inside[:n] if x < cut - TIE_M}
    maybe = {(a, b) for a, b, x in pairs if x <= cut + TIE_M}
    return sure, maybe, min(n, len(inside))


def candidates_agree(rnd: Round, pg: dict) -> bool:
    """Whether the program's candidate pairs are the reference's."""
    sure, maybe, least = candidates(rnd.positions, rnd.seq, int(rnd.count), pg)
    on = rnd.mask.cpu().tolist()
    port = {tuple(e) for e, m in zip(rnd.edges.cpu().tolist(), on) if m}
    return sure <= port <= maybe and least <= len(port) <= pg["max_loops"]


# -- 3. the graph ------------------------------------------------------------------

def _vee(m: torch.Tensor) -> torch.Tensor:
    return torch.stack([m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                        m[..., 1, 0] - m[..., 0, 1]], dim=-1)


def so3_log(r: torch.Tensor) -> torch.Tensor:
    """Rotation vectors of [..., 3, 3] rotations (angles below pi)."""
    v = _vee(r)
    s = torch.linalg.norm(v, dim=-1) / 2
    c = (r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2] - 1) / 2
    theta = torch.atan2(s, c)
    small = theta < 1e-6
    k = torch.where(small, 0.5 + theta * theta / 12, theta / (2 * torch.where(small, 1.0, s)))
    return k[..., None] * v


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rotations of [..., 3] rotation vectors (Rodrigues)."""
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    k = geo.skew(w)
    small = theta < 1e-6
    a = torch.where(small, 1 - theta**2 / 6, torch.sin(theta) / torch.where(small, 1.0, theta))
    b = torch.where(small, 0.5 - theta**2 / 24,
                    (1 - torch.cos(theta)) / torch.where(small, 1.0, theta) ** 2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * k + b * (k @ k)


def jr_inv(w: torch.Tensor) -> torch.Tensor:
    """The inverse right Jacobian of SO(3) at [..., 3]."""
    theta = torch.linalg.norm(w, dim=-1)[..., None, None]
    k = geo.skew(w)
    small = theta < 1e-4
    t = torch.where(small, 1.0, theta)
    c = torch.where(small, 1 / 12 + theta**2 / 720,
                    1 / t**2 - (1 + torch.cos(t)) / (2 * t * torch.sin(t)))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + 0.5 * k + c * (k @ k)


def _inv(t: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(t)
    rt = t[..., :3, :3].mT
    out[..., :3, :3] = rt
    out[..., :3, 3] = -(rt @ t[..., :3, 3:])[..., 0]
    out[..., 3, 3] = 1
    return out


def _edge_terms(xi, xj, z, arith: geo.Arith):
    """Residual r = [log R_E, t_E] of E = Z^-1 X_i^-1 X_j and its Jacobians
    for the right perturbations X <- X (Exp(w), v) (R Exp(w), t + R v)."""
    a = arith.mm(_inv(xi), xj)
    e = arith.mm(_inv(z), a)
    w = so3_log(e[..., :3, :3])
    r = torch.cat([w, e[..., :3, 3]], dim=-1)
    zero = torch.zeros_like(e[..., :3, :3])
    jinv = jr_inv(w)
    rzt = z[..., :3, :3].mT
    j_j = torch.cat([torch.cat([jinv, zero], -1), torch.cat([zero, e[..., :3, :3]], -1)], -2)
    j_i = torch.cat([torch.cat([-arith.mm(jinv, a[..., :3, :3].mT), zero], -1),
                     torch.cat([arith.mm(rzt, geo.skew(a[..., :3, 3])), -rzt], -1)], -2)
    return r, j_i, j_j


def solve_graph(poses: torch.Tensor, edges: torch.Tensor, rel: torch.Tensor,
                weights: torch.Tensor, iterations: int, arith: geo.Arith) -> torch.Tensor:
    """Gauss-Newton over [n] poses for the weighted residuals of the
    edges, slot 0 pinned by a prior on its step, the program's damping on
    the diagonal; the normal system is assembled block by block and solved
    densely in ``arith``'s precision."""
    n = len(poses)
    x = arith.cast(poses)
    z = arith.cast(rel)
    w = arith.cast(weights)
    i, j = edges[:, 0], edges[:, 1]
    diag = torch.full((6 * n,), DAMPING, dtype=x.dtype)
    diag[:6] += PIN_WEIGHT
    for _ in range(iterations):
        r, j_i, j_j = _edge_terms(x[i], x[j], z, arith)
        h = torch.zeros((n, n, 6, 6), dtype=x.dtype)
        b = torch.zeros((n, 6), dtype=x.dtype)
        wm = w[:, None, None]
        for (p, jp), (q, jq) in (((i, j_i), (i, j_i)), ((i, j_i), (j, j_j)),
                                 ((j, j_j), (i, j_i)), ((j, j_j), (j, j_j))):
            h.index_put_((p, q), wm * arith.mm(jp.mT, jq), accumulate=True)
        b.index_add_(0, i, w[:, None] * arith.mm(j_i.mT, r[..., None])[..., 0])
        b.index_add_(0, j, w[:, None] * arith.mm(j_j.mT, r[..., None])[..., 0])
        h = h.permute(0, 2, 1, 3).reshape(6 * n, 6 * n) + torch.diag(diag)
        d = torch.linalg.solve(h, -b.reshape(-1)).reshape(n, 6)
        step = torch.eye(4, dtype=x.dtype).repeat(n, 1, 1)
        step[:, :3, :3] = so3_exp(d[:, :3])
        step[:, :3, 3] = d[:, 3:]
        x = arith.mm(x, step)
    return x.to(torch.float64)


def refine_ring(positions, quats, seq, health, count: int, loops: list, pg: dict,
                arith: geo.Arith = geo.JUDGE) -> torch.Tensor:
    """The round's refined poses [count, 4, 4] (float64) of the live slots:
    the chain through consecutive keyframes in spawn order, each link at its
    pre-round relative pose with weight ``chain_weight`` x ``(m / max(h,
    m))^2`` (``h`` the larger spawn health of its ends, ``m`` the lower
    median over the live slots, at least 1e-6), plus ``loops``: (i, j,
    Z_ij [4, 4], weight) each."""
    x = ring_poses(positions[:count], quats[:count])
    sq = seq.cpu().to(torch.int64)[:count]
    hl = health.cpu().to(torch.float64)[:count]
    order = torch.argsort(sq, stable=True)
    a, b = order[:-1], order[1:]
    med = torch.clamp(torch.sort(hl).values[(count - 1) // 2], min=1e-6)
    info = (med / torch.maximum(torch.maximum(hl[a], hl[b]), med)) ** 2
    edges = [torch.stack([a, b], 1)]
    rel = [_inv(x[a]) @ x[b]]
    wts = [pg["chain_weight"] * info]
    for li, lj, zl, wl in loops:
        edges.append(torch.tensor([[li, lj]]))
        rel.append(zl.cpu().to(torch.float64)[None])
        wts.append(torch.tensor([float(wl)], dtype=torch.float64))
    return solve_graph(x, torch.cat(edges), torch.cat(rel), torch.cat(wts), pg["iterations"], arith)


# -- 2. and 4.: the judged frames ----------------------------------------------------

def ring_cloud(drive: judge.Drive, seq: int, ring: torch.Tensor, arith: geo.Arith) -> geo.Cloud:
    """The keyframe cloud spawned at frame ``seq`` moved from its emitted
    spawn pose to the ring pose ``ring`` ([4, 4] float64), as
    ``judge.Drive.submap`` moves each member."""
    kf = drive.keyframe(seq, arith)
    move = (ring.cpu().to(torch.float64)
            @ geo.inverse(drive.poses(seq).cpu().to(torch.float64))).to(drive.device)
    pts = geo.transform(move, kf.points, arith).to(torch.float32)
    return geo.Cloud(pts, kf.normals.to(torch.float64) @ move[:3, :3].mT, kf.valid)


class RoundJudge:
    """One recorded round against the reference: its candidates, its
    accepted edges as frames, and the refined ring (float64, or the
    control's float32 with TF32 products) with which the frame after the
    round is judged."""

    def __init__(self, base: judge.Drive, rnd: Round, pg: dict):
        self.base, self.rnd, self.pg = base, rnd, pg
        self.count = int(rnd.count)
        self.x = ring_poses(rnd.positions, rnd.quats)
        self.seq = rnd.seq.cpu().tolist()
        self.agree = candidates_agree(rnd, pg)
        mask, good = rnd.mask.cpu(), rnd.weight.cpu() > 0
        self.accepted = torch.nonzero(mask & good).flatten().tolist()
        self.rejected = torch.nonzero(mask & ~good).flatten().tolist()
        self._refined: dict[bool, torch.Tensor] = {}
        self._gap: dict[int, float] = {}
        self._fit: dict[int, tuple[int, float]] = {}

    def slot_cloud(self, slot: int, arith: geo.Arith) -> geo.Cloud:
        return ring_cloud(self.base, self.seq[slot], self.x[slot], arith)

    def pair(self, e: int) -> tuple[int, int]:
        i, j = self.rnd.edges[e].cpu().tolist()
        return i, j

    def port_dt(self, e: int) -> torch.Tensor:
        """The program's dT of edge ``e``: X_i Z_ij X_j^-1 (float64)."""
        i, j = self.pair(e)
        return self.x[i] @ self.rnd.rel[e].cpu().to(torch.float64) @ _inv(self.x[j])

    def edge_capture(self, e: int) -> judge.Capture:
        r = self.rnd
        return judge.Capture(r.frame, r.cloud_i[e], r.cloud_i_mask[e],
                             torch.zeros(0, dtype=torch.bool), r.positions, r.quats, r.seq)

    def edge_gap(self, e: int) -> float:
        """The judged gap of edge ``e`` (``judge.judge_frame`` from the
        program's dT)."""
        if e not in self._gap:
            self._gap[e] = judge.judge_frame(EdgeDrive(self, e, probe=True),
                                             self.edge_capture(e))["pose_gap_m"]
        return self._gap[e]

    def loop_fit(self, e: int) -> tuple[int, float]:
        """The loop stage on candidate ``e`` in float64: the reference's
        cloud j registered onto its cloud i from identity, with the loop
        gate and at most ``loop_max_iterations`` Gauss-Newton steps.
        Returns (correspondences at the result, the largest entry of one
        more step's rotation vector and translation)."""
        if e not in self._fit:
            i, j = self.pair(e)
            src, tgt = self.slot_cloud(j, geo.FLOAT32), self.slot_cloud(i, geo.FLOAT32)
            gate = self.pg["loop_corr_distance"]
            eye = torch.eye(4, dtype=torch.float64, device=self.base.device)
            x, _, _ = geo.gicp_solve(src, tgt, eye, gate, geo.JUDGE,
                                     max_iter=self.pg["loop_max_iterations"])
            nxt, ok, _ = geo.gicp_solve(src, tgt, x, gate, geo.JUDGE, max_iter=1)
            step = (nxt @ _inv(x)).cpu()
            move = torch.cat([so3_log(step[:3, :3]), step[:3, 3]]).abs().max()
            self._fit[e] = int(ok.sum()), float(move)
        return self._fit[e]

    def missed(self) -> list[int]:
        """The candidates the program rejected that the reference's loop
        stage clearly accepts: converged, and at least :data:`CORR_MARGIN`
        x ``min_loop_corr`` correspondences."""
        least = CORR_MARGIN * self.pg["min_loop_corr"]
        return [e for e in self.rejected
                if self.loop_fit(e)[0] >= least and self.loop_fit(e)[1] < CONVERGED_STEP]

    def refined(self, control: bool) -> torch.Tensor:
        """[count, 4, 4] the refined ring from the program's measured edges."""
        if control not in self._refined:
            loops = [(*self.pair(e), self.rnd.rel[e], float(self.rnd.weight[e]))
                     for e in self.accepted]
            self._refined[control] = refine_ring(
                self.rnd.positions, self.rnd.quats, self.rnd.seq, self.rnd.health, self.count,
                loops, self.pg, geo.CONTROL_TF32 if control else geo.JUDGE)
        return self._refined[control]


_NAN = torch.full((4, 4), float("nan"), dtype=torch.float64)


class EdgeDrive(judge.Drive):
    """One accepted loop edge served to ``judge.judge_frame`` as a frame:
    the scan is the reference's cloud j, the submap its cloud i (both at
    the pre-round ring), the pose the program's dT, the gate the loop's.
    An edge whose judged gap exceeds :data:`EDGE_GAP_M` is a wrong
    constraint in the round's graph: it gives no finite pose and so
    counts as lost (``probe``: the pose as it is, for measuring the gap)."""

    def __init__(self, rj: RoundJudge, e: int, probe: bool = False):
        b = rj.base
        gicp = b.cfg["gicp"]
        cfg = {**b.cfg, "gicp": {**gicp, "s2m": {
            **gicp["s2m"], "max_correspondence_distance": rj.pg["loop_corr_distance"]}}}
        super().__init__(cfg, b.raw_scan, self._pose, b.wire, b.device)
        self.rj, self.e, self.probe = rj, e, probe
        self.i, self.j = rj.pair(e)

    def _pose(self, frame: int) -> torch.Tensor:
        if not self.probe and self.rj.edge_gap(self.e) > EDGE_GAP_M:
            return _NAN
        return self.rj.port_dt(self.e)

    def scan(self, frame: int) -> geo.Cloud:
        return self.rj.slot_cloud(self.j, geo.FLOAT32)

    def submap(self, cap: judge.Capture, arith: geo.Arith) -> geo.Cloud:
        return self.rj.slot_cloud(self.i, arith)


class RoundDrive(judge.Drive):
    """The frame after a round, judged against the keyframe clouds at the
    reference's refined ring (slots spawned since keep the program's ring
    pose). A round whose candidates differ from the reference's, or that
    rejected a candidate the reference clearly accepts, gives the frame no
    finite pose: it counts as lost."""

    def __init__(self, rj: RoundJudge):
        b = rj.base
        super().__init__(b.cfg, b.raw_scan, self._pose, b.wire, b.device)
        self._scans, self.rj = b._scans, rj

    def _pose(self, frame: int) -> torch.Tensor:
        sound = self.rj.agree and not self.rj.missed()
        return self.rj.base.poses(frame) if sound else _NAN

    def submap(self, cap: judge.Capture, arith: geo.Arith) -> geo.Cloud:
        rj = self.rj
        refined = rj.refined(arith.tf32)
        parts = []
        for k in torch.nonzero(cap.members.cpu()).flatten().tolist():
            seq = int(cap.kf_seq[k])
            if k < rj.count and seq == rj.seq[k]:
                ring = refined[k]
            else:
                ring = geo.pose_matrix(geo.quat_to_rot(cap.kf_quats[k].cpu()),
                                       cap.kf_positions[k].cpu().to(torch.float64))
            parts.append(ring_cloud(rj.base, seq, ring, arith))
        if not parts:
            return super().submap(cap, arith)
        return geo.Cloud(*(torch.cat([getattr(p, f) for p in parts])
                           for f in ("points", "normals", "valid")))


def judged_frames(base: judge.Drive, rnd: Round, next_capture: judge.Capture, pg: dict) -> list:
    """(drive, capture) pairs of one judged round for ``judge.judge_frame``:
    each accepted loop edge, then the frame after the round."""
    rj = RoundJudge(base, rnd, pg)
    edges = [(EdgeDrive(rj, e), rj.edge_capture(e)) for e in rj.accepted]
    return edges + [(RoundDrive(rj), next_capture)]
