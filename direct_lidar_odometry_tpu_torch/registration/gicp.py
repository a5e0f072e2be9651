"""GICP registration: 1-NN correspondences + Mahalanobis + Gauss-Newton /
Levenberg-Marquardt on SE(3).

Counterpart of the JAX package's ``registration/gicp.py`` (the reference's
``NanoGICP`` + ``LsqRegistration``), on every backend of
``config.resolve_backend``:

- ``_update_correspondences`` (``nano_gicp_impl.hpp:173-211``): 1-NN of
  the transformed source in the target, gated by
  ``max_correspondence_distance``, plus PLANE Mahalanobis weights rebuilt
  from stored normals. The search is kernel K2 on ``"pallas"`` (alias
  ``"pallas_unfused"``), K4 on ``"pallas_mxu"`` (``ops/cuda_nn.py``), the
  exhaustive tiled search on ``"brute"`` (``ops/bruteforce.py``) and the
  hash grid on ``"hashgrid"`` (``ops/hashgrid.py``, ``cap`` candidates a
  cell); the last two are tensor ops, no hand kernel;
- ``_linearize`` (``:213-270``): residuals, Jacobians and the H/b sums; on
  the ``"pallas_fused"`` backend all of it, search included, is kernel K3
  (``ops/cuda_gicp.py``); of one lane or of B;
- ``ops/cuda_lm.compute_error_plain`` (``:272-296``): error with frozen
  correspondences, for the LM gain-ratio test;
- :func:`align` (``lsq_registration_impl.hpp:89-208``): the outer loop and
  the LM inner retry loop, with the reference's lambda/nu schedule, the
  rho gain test and the convergence test
  ``max(|R-I|/rot_eps, |t|/trans_eps) < 1``. Each LM trial (the damped
  solve, the error of the trial estimate, rho and the updates) and the
  re-orthonormalization of the guess are kernel K7 on a CUDA device and
  its plain version on the CPU (``ops/cuda_lm.py``).

The JAX package runs both loops as ``lax.while_loop`` on the device. Here
they are Python loops; each inner iteration reads its two flags (accept,
converged) in ONE host read (``utils/sync.py``), and nothing else in the
loop waits for the device: x, lambda and nu stay in device tensors, updated
with ``torch.where``. On a CUDA device the pruned-kernel backends replay
the work between two reads (an outer iteration up to its first LM trial's
flags, or one more trial) as a captured CUDA graph, one pair of graphs per
shape and stage; the CPU, ``"brute"`` and ``"hashgrid"`` issue the same
operations one by one.

:func:`align_batched` registers B independent lanes at once on every
backend (the JAX package's ``align`` under ``jax.vmap``): sources,
targets (a hash grid too) and guesses carry a leading [B], ``_linearize``
serves all lanes at once, and each lane's LM state (x,
lambda, nu, iterations, converged, failed) lives in [B] tensors. The loops
run while any lane is live; a lane that has finished keeps its carry
frozen (``torch.where``), and each inner iteration still reads its flags,
now [2, B], in one host read. Each lane's sums, reducing products and 4x4
pose products run in the single-sequence operations
(``utils/lanes.per_lane``), so a lane follows its own :func:`align` bit
for bit.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from direct_lidar_odometry_tpu_torch.config import GicpStageConfig
from direct_lidar_odometry_tpu_torch.core import se3
from direct_lidar_odometry_tpu_torch.core.cloud import gather_rows
from direct_lidar_odometry_tpu_torch.ops import (
    bruteforce, cuda_gicp, cuda_lm, cuda_nn, hashgrid, morton,
)
from direct_lidar_odometry_tpu_torch.registration.covariance import PLANE_EPS, cov_from_normal
from direct_lidar_odometry_tpu_torch.utils import graphs, sync
from direct_lidar_odometry_tpu_torch.utils.lanes import per_lane


def is_pallas(backend: str) -> bool:
    """All pruned-kernel backends: "pallas" (1-NN kernel K2 + tensor-op
    linearization), "pallas_mxu" (K4 instead of K2), "pallas_fused" (the
    fused kernel K3); "pallas_unfused" is an alias of "pallas"."""
    return backend.startswith("pallas")


class GicpTarget(NamedTuple):
    """A registration target in original point order with its search
    index (the reference's kd-tree build, ``nano_gicp_impl.hpp:127,137``):
    on the pruned-kernel backends the cloud is Morton-sorted and
    ``chunk_lo``/``chunk_hi`` hold its [3, Nt//512] chunk AABBs; on
    ``"hashgrid"`` ``grid`` is its hash index; ``"brute"`` needs none."""

    points: torch.Tensor         # [Nt, 3]
    mask: torch.Tensor           # [Nt]
    normals: torch.Tensor        # [Nt, 3]
    normals_valid: torch.Tensor  # [Nt]
    chunk_lo: torch.Tensor | None = None  # [3, Nt//512] (pruned-kernel backends)
    chunk_hi: torch.Tensor | None = None
    grid: hashgrid.HashGrid | None = None  # ("hashgrid")


class GicpSource(NamedTuple):
    points: torch.Tensor         # [Ns, 3]
    mask: torch.Tensor           # [Ns]
    normals: torch.Tensor        # [Ns, 3]
    normals_valid: torch.Tensor  # [Ns]


class GicpResult(NamedTuple):
    """:func:`align`'s result; :func:`align_batched` gives every field a
    leading [B], with ``iterations`` (int32), ``converged`` and
    ``lm_failed`` (bool) as [B] device tensors."""

    transform: torch.Tensor          # [4, 4] final estimate
    hessian: torch.Tensor            # [6, 6] final accepted H
    iterations: int                  # outer iterations executed
    converged: bool
    lm_failed: bool                  # "lm not converged!!" analog
    final_error: torch.Tensor        # f32, last linearization error sum
    num_correspondences: torch.Tensor  # int32 at the last linearization


def make_target(
    points, mask, normals, normals_valid, radius=None, table_size=None,
    backend: str = "pallas",
) -> GicpTarget:
    """Build the backend's search index over the target: chunk AABBs over a
    Morton-ordered cloud (contiguous tensors) on the pruned-kernel
    backends, a hash grid of cell ``radius`` and ``table_size`` slots on
    ``"hashgrid"``, nothing on ``"brute"``; each lane's over [B, T, 3]
    clouds."""
    chunk_lo = chunk_hi = grid = None
    if is_pallas(backend):
        chunk_lo, chunk_hi = morton.chunk_aabbs(points, mask, morton.TARGET_CHUNK)
    elif backend == "hashgrid":
        grid = hashgrid.build(points, mask, radius, table_size)
    return GicpTarget(
        points=points, mask=mask, normals=normals, normals_valid=normals_valid,
        chunk_lo=chunk_lo, chunk_hi=chunk_hi, grid=grid,
    )


def _sym_inv3(m: torch.Tensor) -> torch.Tensor:
    """Analytic inverse of symmetric [..., 3, 3] via the adjugate."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e = m[..., 1, 1], m[..., 1, 2]
    f = m[..., 2, 2]
    co_a = d * f - e * e
    co_b = c * e - b * f
    co_c = b * e - c * d
    det = a * co_a + b * co_b + c * co_c
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, torch.ones_like(det))
    i00 = co_a * inv_det
    i01 = co_b * inv_det
    i02 = co_c * inv_det
    i11 = (a * f - c * c) * inv_det
    i12 = (b * c - a * e) * inv_det
    i22 = (a * d - b * b) * inv_det
    row0 = torch.stack([i00, i01, i02], dim=-1)
    row1 = torch.stack([i01, i11, i12], dim=-1)
    row2 = torch.stack([i02, i12, i22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


class _Linearization(NamedTuple):
    h: torch.Tensor           # [6, 6]
    b: torch.Tensor           # [6]
    error: torch.Tensor       # scalar
    corr: torch.Tensor        # [Ns] target index (-1 = none)
    weight: torch.Tensor      # [Ns] f32 0/1 correspondence mask
    mu_b: torch.Tensor        # [Ns, 3] frozen correspondence target points
    n_b: torch.Tensor         # [Ns, 3] frozen correspondence target normals
    m0: torch.Tensor          # [Ns, 3] source normals rotated by the frozen R
    n_corr: torch.Tensor      # int32


def _update_correspondences(
    x0: torch.Tensor, src: GicpSource, target: GicpTarget, cfg: GicpStageConfig,
    backend: str, cap: int,
):
    """1-NN + Mahalanobis. Reference nano_gicp_impl.hpp:173-211.

    Serves the unfused backends; "pallas_fused" takes the fused kernel in
    :func:`_linearize` and never calls this. With B lanes (x0 [B, 4, 4],
    clouds [B, N, ...], a batched grid) one search serves them all."""
    r = x0[..., :3, :3]
    p_t = se3.transform_points(x0, src.points)  # [Ns, 3]
    radius = cfg.max_correspondence_distance
    if is_pallas(backend):
        idx, _, found = cuda_nn.query_1nn_sorted(
            target.points, target.mask, target.chunk_lo, target.chunk_hi,
            p_t, src.mask, radius, mxu=(backend == "pallas_mxu"),
        )
    elif backend == "brute":
        tile = min(8192, target.points.shape[-2])
        idx, _, found = bruteforce.query_1nn(target.points, target.mask, p_t, src.mask, radius,
                                             tile=tile)
    else:
        idx, _, found = hashgrid.query_1nn(target.grid, p_t, src.mask, radius, cap)
    j = torch.clamp(idx, min=0)
    # both endpoints need usable normals
    ok = found & src.normals_valid & gather_rows(target.normals_valid, j)
    # C_B + R C_A R^T = 2 I - (1-eps)(nB nB^T + (R nA)(R nA)^T)
    n_a_rot = src.normals @ r.mT
    n_b = gather_rows(target.normals, j)
    mahal = _sym_inv3(cov_from_normal(n_b) + cov_from_normal(n_a_rot))
    w = ok.to(torch.float32)
    mahal = mahal * w[..., None, None]
    corr = torch.where(ok, j, -1)
    return corr, w, mahal, p_t, n_b, n_a_rot


def _linearize(
    x0: torch.Tensor, src: GicpSource, target: GicpTarget, cfg: GicpStageConfig,
    backend: str, seed_corr: torch.Tensor | None = None, cap: int = 16,
) -> _Linearization:
    """Reference nano_gicp_impl.hpp:213-270 as one masked reduction.

    backend "pallas_fused": one pass of kernel K3 (search, Mahalanobis and
    the H/b sums). ``seed_corr``: previous-iteration correspondences that
    warm-start K3's branch-and-bound (the result is exactly the unseeded
    one; :func:`align` does not seed, as in the JAX package). Over B lanes
    (x0 [B, 4, 4], clouds [B, N, ...]) one search, one K3 launch or one
    tensor-op pass serves them all, and each lane's sums run in the
    single-sequence operations (``utils/lanes.per_lane``).
    """
    if backend == "pallas_fused":
        p_t = se3.transform_points(x0, src.points)
        m0 = src.normals @ x0[..., :3, :3].mT
        fl = cuda_gicp.fused_linearize(
            target.points, target.mask, target.normals, target.normals_valid,
            target.chunk_lo, target.chunk_hi, p_t, m0, src.mask & src.normals_valid,
            cfg.max_correspondence_distance, PLANE_EPS, seed_corr=seed_corr,
        )
        return _Linearization(h=fl.h, b=fl.b, error=fl.error, corr=fl.corr, weight=fl.weight,
                              mu_b=fl.mu_b, n_b=fl.n_b, m0=m0, n_corr=fl.n_corr)

    corr, weight, mahal, p_t, n_b, m0 = _update_correspondences(x0, src, target, cfg, backend,
                                                                cap)
    mu_b = gather_rows(target.points, torch.clamp(corr, min=0))
    if x0.dim() == 3:
        h, b, err, n_corr = per_lane(_normal_equations, p_t, mu_b, weight, mahal)
    else:
        h, b, err, n_corr = _normal_equations(p_t, mu_b, weight, mahal)
    return _Linearization(h=h, b=b, error=err, corr=corr, weight=weight,
                          mu_b=mu_b, n_b=n_b, m0=m0, n_corr=n_corr)


def _normal_equations(p_t, mu_b, weight, mahal):
    """H [6, 6], b [6], the error and n_corr of one cloud's weighted
    correspondences (the masked reduction of :func:`_linearize`)."""
    e = (mu_b - p_t) * weight[..., None]               # [Ns, 3]
    me = torch.einsum("nij,nj->ni", mahal, e)         # [Ns, 3]
    err = torch.sum(e * me)
    # J = [ skew(p_t) | -I ]  (3x6). Blocks of H = J^T M J:
    #   H = [[ S^T M S,  -S^T M ], [ -M S,  M ]],  b = [ S^T M e, -M e ]
    s = se3.skew(p_t)                                  # [Ns, 3, 3]
    ms = torch.einsum("nij,njk->nik", mahal, s)        # M S
    stms = torch.einsum("nji,njk->nik", s, ms)         # S^T (M S)
    stm = torch.einsum("nji,njk->nik", s, mahal)       # S^T M
    h_tl = torch.sum(stms, dim=0)
    h_tr = -torch.sum(stm, dim=0)
    h_br = torch.sum(mahal, dim=0)
    h = torch.cat(
        [torch.cat([h_tl, h_tr], dim=1), torch.cat([h_tr.T, h_br], dim=1)], dim=0
    )
    b_top = torch.einsum("nji,nj->i", s, me)
    b_bot = -torch.sum(me, dim=0)
    b = torch.cat([b_top, b_bot])
    n_corr = torch.sum(weight).to(torch.int32)
    return h, b, err, n_corr


class _LmState(NamedTuple):
    """:func:`align`'s optimizer state, on the device for the whole call and
    updated in place: the estimate, LM's lambda and nu, whether lambda
    still waits for its first linearization, and on a CUDA device the LM
    trial kernel's workspace (``ops/cuda_lm.workspace``)."""

    x: torch.Tensor      # [4, 4]
    lam: torch.Tensor    # f32
    nu: torch.Tensor     # f32
    fresh: torch.Tensor  # bool
    work: torch.Tensor | None


def _lm_state(x: torch.Tensor) -> _LmState:
    dev = x.device
    return _LmState(x=x, lam=torch.zeros((), dtype=torch.float32, device=dev),
                    nu=torch.full((), 2.0, dtype=torch.float32, device=dev),
                    fresh=torch.ones((), dtype=torch.bool, device=dev),
                    work=cuda_lm.workspace(dev))


def _lm_trial(st: _LmState, src: GicpSource, lin: _Linearization,
              cfg: GicpStageConfig) -> torch.Tensor:
    """One trial of step_lm (lsq_registration_impl.hpp:169-206) on ``lin``:
    the damped step, the gain ratio rho, then lambda, nu and x updated in
    place as an accepted (rho >= 0) or a rejected step updates them
    (``ops/cuda_lm.lm_trial``: kernel K7 on a CUDA device). Returns the
    [accept, converged] flags."""
    return cuda_lm.lm_trial(st.x, st.lam, st.nu, lin.h, lin.b, lin.error, lin.mu_b, lin.n_b,
                            lin.m0, lin.weight, src.points, cfg.rotation_epsilon,
                            cfg.transformation_epsilon, PLANE_EPS, st.work)


def _iteration(st: _LmState, src: GicpSource, target: GicpTarget, cfg: GicpStageConfig,
               backend: str, cap: int) -> tuple[_Linearization, torch.Tensor]:
    """One outer iteration up to its first host read: linearize at x, then
    LM's first trial (lambda initialised on the call's first linearization,
    nu reset to 2), or the whole GN step (step_gn,
    lsq_registration_impl.hpp:142-158, which always moves x). Returns the
    linearization and the flags the host reads: [accept, converged] (LM) or
    converged (GN)."""
    lin = _linearize(st.x, src, target, cfg, backend, cap=cap)
    if cfg.optimizer == "lm":
        lam0 = cfg.lm_init_lambda_factor * torch.max(torch.abs(torch.diagonal(lin.h)))
        st.lam.copy_(torch.where(st.fresh, lam0, st.lam))
        st.fresh.fill_(False)
        st.nu.fill_(2.0)
        return lin, _lm_trial(st, src, lin, cfg)
    d = cuda_lm.solve6(lin.h, lin.b)
    delta = se3.se3_exp(d)
    st.x.copy_(cuda_lm.reorthonormalize_plain(delta @ st.x))
    return lin, cuda_lm.is_converged(delta, cfg.rotation_epsilon, cfg.transformation_epsilon)


def _clone(t: torch.Tensor | None) -> torch.Tensor | None:
    return None if t is None else t.clone()


class _Iterations:
    """:func:`align`'s iterations on one optimizer state: issued operation by
    operation, or, once :meth:`captured` has captured them, replayed from
    two CUDA graphs: ``graph`` (:func:`_iteration`) and under LM
    ``retry_graph`` (one more :func:`_lm_trial` on the iteration's
    linearization). A replay reads the instance's static copies of the
    source, the target and the state (:meth:`load`) and leaves its
    linearization and flags in the tensors the capture returned. Each
    iteration and retry counts the LM trial kernels it launched or
    replayed (``gicp_trial.kernel``)."""

    def __init__(self, src, target, x0, cfg, backend, cap):
        self.src, self.target, self.cfg, self.backend, self.cap = src, target, cfg, backend, cap
        self.st = _lm_state(x0)
        self.lin = self.flags = self.retry_flags = None
        self.graph = self.retry_graph = None
        self.graph_trials = self.retry_trials = 0

    def iteration(self) -> tuple[_Linearization, torch.Tensor]:
        if self.graph is None:
            launched = cuda_lm.launches["cuda"]
            self.lin, self.flags = _iteration(self.st, self.src, self.target, self.cfg,
                                              self.backend, self.cap)
            _count_trials(cuda_lm.launches["cuda"] - launched)
        else:
            self.graph.replay()
            sync.count("gicp_graph.replays")
            _count_trials(self.graph_trials)
        return self.lin, self.flags

    def retry(self) -> torch.Tensor:
        if self.retry_graph is None:
            launched = cuda_lm.launches["cuda"]
            flags = _lm_trial(self.st, self.src, self.lin, self.cfg)
            _count_trials(cuda_lm.launches["cuda"] - launched)
            return flags
        self.retry_graph.replay()
        sync.count("gicp_graph.replays")
        _count_trials(self.retry_trials)
        return self.retry_flags

    @classmethod
    def captured(cls, src, target, x0, cfg, backend, cap) -> _Iterations:
        """Static copies of the inputs, and both graphs captured on the
        device's side stream (``utils/graphs.side_stream``), each in a private
        memory pool, after one eager run there that builds what a capture
        cannot (the kernel library, the cuBLAS and cuSOLVER handles and
        workspaces, the constants)."""
        run = cls(GicpSource(*map(_clone, src)), GicpTarget(*map(_clone, target)), x0.clone(),
                  cfg, backend, cap)
        side = graphs.side_stream(x0.device)
        side.wait_stream(torch.cuda.current_stream(x0.device))
        with torch.cuda.stream(side):  # the warm run, counted nowhere
            lin, _ = _iteration(run.st, run.src, run.target, cfg, backend, cap)
            if cfg.optimizer == "lm":
                _lm_trial(run.st, run.src, lin, cfg)
        run.graph, (run.lin, run.flags), run.graph_trials = _capture(side, run.iteration)
        if cfg.optimizer == "lm":
            run.retry_graph, run.retry_flags, run.retry_trials = _capture(side, run.retry)
        torch.cuda.current_stream(x0.device).wait_stream(side)
        return run

    def load(self, src: GicpSource, target: GicpTarget, x0: torch.Tensor) -> _Iterations:
        for mine, theirs in zip((*self.src, *self.target), (*src, *target)):
            if mine is not None:
                mine.copy_(theirs)
        self.st.x.copy_(x0)
        self.st.fresh.fill_(True)
        return self


def _capture(side, body):
    """(the graph, what ``body`` returned, the LM trial kernels it holds):
    ``utils/graphs.capture``, counted as ``gicp_graph.captures``."""
    recorded = cuda_lm.launches["captured"]
    graph, out = graphs.capture(side, body, "gicp_graph.captures")
    return graph, out, cuda_lm.launches["captured"] - recorded


def _count_trials(n: int) -> None:
    """Count ``n`` LM trials run by kernel K7 (none on the CPU)."""
    if n:
        sync.count("gicp_trial.kernel", n)


_GRAPHS: dict[tuple, _Iterations] = {}


def release_graphs() -> None:
    """Drop every captured graph with its static buffers and memory pool;
    the next :func:`align` of each key captures again."""
    _GRAPHS.clear()


def _iterations(src: GicpSource, target: GicpTarget, x0: torch.Tensor, cfg: GicpStageConfig,
                backend: str, cap: int) -> tuple[_Iterations, bool]:
    """The iterations of this call and whether they replay graphs: on a
    CUDA device with a pruned-kernel backend the captured iterations of
    the call's key, captured on its first use (the tensor-op backends
    ``"brute"`` and ``"hashgrid"`` stay the plain route, as on the CPU).
    The key holds everything the captured work depends on: the backend,
    the shapes, dtype and device of the clouds, the stage's gate,
    convergence epsilons, initial lambda factor and optimizer, and
    ``cap``."""
    if x0.device.type != "cuda" or not is_pallas(backend):
        return _Iterations(src, target, x0, cfg, backend, cap), False
    key = (backend, x0.device, src.points.dtype, tuple(src.points.shape),
           tuple(target.points.shape), tuple(target.chunk_lo.shape),
           cfg.max_correspondence_distance, cfg.rotation_epsilon, cfg.transformation_epsilon,
           cfg.lm_init_lambda_factor, cfg.optimizer, cap)
    run = _GRAPHS.get(key)
    if run is None:
        run = _GRAPHS[key] = _Iterations.captured(src, target, x0, cfg, backend, cap)
    return run.load(src, target, x0), True


def align(
    src: GicpSource,
    target: GicpTarget,
    guess: torch.Tensor,
    cfg: GicpStageConfig,
    backend: str = "pallas",
    cap: int = 16,
) -> GicpResult:
    """Register ``src`` onto ``target`` starting from ``guess`` (4x4).

    ``LsqRegistration::computeTransformation`` with the reference-default
    LM inner step, or plain GN when ``cfg.optimizer == "gn"``. One host
    read per inner iteration (LM) or per outer iteration (GN); x, lambda
    and nu stay on the device. ``backend``: "pallas" (or its alias
    "pallas_unfused"), "pallas_mxu", "pallas_fused", "brute" or "hashgrid"
    (see config.resolve_backend); ``cap``: the hash grid's candidates a
    cell (``shapes.cell_cap_1nn``). On a CUDA device a pruned-kernel
    backend replays each iteration and each LM retry as one captured CUDA
    graph (:func:`_iterations`); elsewhere the same operations run one by
    one. The result shares no memory with the graphs.
    Counts its outer iterations and its LM (or GN) steps under the caller's
    innermost span (``align_iters.<span>``, ``lm_steps.<span>``), and on a
    CUDA device its graph replays, its eagerly run iterations and its LM
    trials run by kernel K7 (``gicp_graph.replays``,
    ``gicp_graph.eager_iters``, ``gicp_trial.kernel``; ``utils/sync.py``).
    """
    x0 = cuda_lm.reorthonormalize(guess.to(torch.float32))
    on_card = x0.device.type == "cuda"
    with torch.cuda.device(x0.device) if on_card else contextlib.nullcontext():
        run, graphed = _iterations(src, target, x0, cfg, backend, cap)
        lin = None
        iters, steps, converged, failed = 0, 0, False, False
        while iters < cfg.max_iterations and not converged and not failed:
            lin, flags = run.iteration()
            if cfg.optimizer == "lm":
                # step_lm (lsq_registration_impl.hpp:161-208): retry on the same
                # linearization until a step is accepted or already converged
                steps, trials = steps + 1, 1
                accept, conv = sync.read(flags)
                while not (accept or conv) and trials < cfg.lm_max_iterations:
                    steps, trials = steps + 1, trials + 1
                    accept, conv = sync.read(run.retry())
                # the reference returns true on acceptance and on a rejected
                # step that is already below the convergence test
                ok = accept or conv
            else:
                steps += 1
                ok, conv = True, sync.read(flags)
            converged = ok and conv
            failed = not ok
            iters += 1
        if lin is None:
            dev = x0.device
            hessian = torch.eye(6, dtype=torch.float32, device=dev)
            err = torch.zeros((), dtype=torch.float32, device=dev)
            n_corr = torch.zeros((), dtype=torch.int32, device=dev)
        else:
            # clones: the next load or replay overwrites graph memory
            hessian, err, n_corr = lin.h.clone(), lin.error.clone(), lin.n_corr.clone()
        transform = run.st.x.clone()
    stage = sync.site()
    sync.count(f"align_iters.{stage}", iters)
    sync.count(f"lm_steps.{stage}", steps)
    if on_card:  # counted at 0 too: its presence tells a graph-capable program
        sync.count("gicp_graph.eager_iters", 0 if graphed else iters)
    return GicpResult(
        transform=transform,
        hessian=hessian,
        iterations=iters,
        converged=converged,
        lm_failed=failed,
        final_error=err,
        num_correspondences=n_corr,
    )


def align_batched(
    src: GicpSource,
    target: GicpTarget,
    guess: torch.Tensor,
    cfg: GicpStageConfig,
    backend: str = "pallas",
    active: tuple[torch.Tensor, list] | None = None,
    cap: int = 16,
) -> GicpResult:
    """:func:`align` over B lanes: ``src`` and ``target`` with a leading [B]
    (``make_target`` over [B, T, 3] clouds), ``guess`` [B, 4, 4]; every
    backend of :func:`align`, ``cap`` as there.

    Each lane follows :func:`align`'s loops on its own state: the outer loop
    runs while some lane is live (below ``max_iterations``, neither
    converged nor failed), the LM inner loop while some live lane has not
    accepted or converged; a lane that has left either loop keeps its x,
    lambda and nu. One host read per inner iteration ([2, B] flags: accept,
    converged) for all lanes, as :func:`align` reads two. ``active`` (a [B]
    bool tensor and the same flags already read on the host) runs only
    those lanes; the others return their guess, reorthonormalized, and zero
    iterations.
    """
    dev = guess.device
    lanes = guess.shape[0]
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    use_lm = cfg.optimizer == "lm"

    x = cuda_lm.reorthonormalize_plain(guess.to(torch.float32))
    if active is None:
        live_dev = torch.ones((lanes,), dtype=torch.bool, device=dev)
        live = [True] * lanes
    else:
        live_dev, live = active[0].clone(), list(active[1])
    iters = [0] * lanes
    iters_dev = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    conv_dev = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    failed_dev = torch.zeros((lanes,), dtype=torch.bool, device=dev)
    h_fin = eye6.expand(lanes, 6, 6)
    err_fin = torch.zeros((lanes,), dtype=torch.float32, device=dev)
    nc_fin = torch.zeros((lanes,), dtype=torch.int32, device=dev)
    lam = None
    while any(live):
        lin = _linearize(x, src, target, cfg, backend, cap=cap)
        if use_lm:
            # step_lm (lsq_registration_impl.hpp:161-208), lane by lane
            if lam is None:  # every lane's first linearization
                lam = cfg.lm_init_lambda_factor * torch.amax(
                    torch.abs(torch.diagonal(lin.h, dim1=-2, dim2=-1)), dim=-1)
            nu = torch.full((lanes,), 2.0, dtype=torch.float32, device=dev)
            inner, inner_dev = list(live), live_dev
            ok, conv = [False] * lanes, [False] * lanes
            ok_dev = torch.zeros_like(live_dev)
            conv_in = torch.zeros_like(live_dev)
            x_new = x
            for _ in range(cfg.lm_max_iterations):
                if not any(inner):
                    break
                d = cuda_lm.solve6(lin.h + lam[:, None, None] * eye6, lin.b)
                delta = se3.se3_exp(d)
                xi = cuda_lm.reorthonormalize_plain(per_lane(torch.matmul, delta, x))
                yi = cuda_lm.compute_error_plain(xi, src.points, lin.mu_b, lin.n_b, lin.m0,
                                                 lin.weight, PLANE_EPS)
                denom = per_lane(torch.dot, d, lam[:, None] * d - lin.b)
                denom = torch.where(torch.abs(denom) > 1e-30, denom, 1e-30)
                rho = (lin.error - yi) / denom
                flags = torch.stack([rho >= 0.0, cuda_lm.is_converged(
                    delta, cfg.rotation_epsilon, cfg.transformation_epsilon)])
                accept_h, conv_h = sync.read(flags)
                accept, stop = flags[0], flags[0] | flags[1]
                acc = inner_dev & accept
                rej = inner_dev & ~accept
                lam = torch.where(acc, lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0),
                                  torch.where(rej, nu * lam, lam))
                nu = torch.where(rej, 2.0 * nu, nu)
                x_new = torch.where(acc[:, None, None], xi, x_new)
                # the reference returns true on acceptance and on a rejected
                # step that is already below the convergence test
                done = inner_dev & stop
                ok_dev = ok_dev | done
                conv_in = torch.where(done, flags[1], conv_in)
                inner_dev = inner_dev & ~stop
                for b in range(lanes):
                    if inner[b] and (accept_h[b] or conv_h[b]):
                        ok[b], conv[b], inner[b] = True, bool(conv_h[b]), False
        else:
            # step_gn (lsq_registration_impl.hpp:142-158)
            d = cuda_lm.solve6(lin.h, lin.b)
            delta = se3.se3_exp(d)
            x_new = cuda_lm.reorthonormalize_plain(per_lane(torch.matmul, delta, x))
            conv_in = cuda_lm.is_converged(delta, cfg.rotation_epsilon, cfg.transformation_epsilon)
            conv = sync.read(conv_in)
            ok, ok_dev = list(live), live_dev
        moved = live_dev & ok_dev
        x = torch.where(moved[:, None, None], x_new, x)
        iters_dev = iters_dev + live_dev.to(torch.int32)
        h_fin = torch.where(live_dev[:, None, None], lin.h, h_fin)
        err_fin = torch.where(live_dev, lin.error, err_fin)
        nc_fin = torch.where(live_dev, lin.n_corr, nc_fin)
        conv_dev = conv_dev | (moved & conv_in)
        failed_dev = failed_dev | (live_dev & ~ok_dev)
        live_dev = live_dev & ok_dev & ~conv_in & (iters_dev < cfg.max_iterations)
        for b in range(lanes):
            if live[b]:
                iters[b] += 1
                live[b] = ok[b] and not conv[b] and iters[b] < cfg.max_iterations
    return GicpResult(
        transform=x,
        hessian=h_fin,
        iterations=iters_dev,
        converged=conv_dev,
        lm_failed=failed_dev,
        final_error=err_fin,
        num_correspondences=nc_fin,
    )
