"""The per-frame odometry step.

Counterpart of the JAX package's ``odometry/pipeline.py`` (reference
``icpCB`` + ``getNextPose``, ``odom.cc:629-697, 792-852``):

    preprocess -> spaciousness/adaptive -> S2S GICP (coarse, then full) ->
    propagate -> submap select/assemble -> S2M GICP -> staged-gate rescue ->
    pose -> keyframe spawn -> carry scan as next target

The stages are module functions, called in that order by
:func:`odom_frame`, which opens a ``step.*`` span around each (they open
none): :func:`front` (preprocess, spaciousness, keyframe threshold),
:func:`_scan_normals`, the S2S plan :func:`s2s_passes` with
:func:`s2s_align` each, :func:`submap_stage`, :func:`s2m_stage` and the
rescue :func:`rescue_stage`, :func:`keyframe_stage`, and :func:`finish`
(the next state and the :class:`FrameResult`). The stage tools
(``tools_torch/ablate_step.py``, ``profile_stages.py``,
``micro_align.py``) call them too.

The first frame goes through :func:`init_frame` (``initializeInputTarget``,
``odom.cc:472-507``). Shapes are fixed by ``cfg.shapes``. PyTorch runs
eagerly, so the JAX package's ``lax.cond`` branches become Python ``if`` on
host reads (``utils/sync.py``): the rescue trigger, the submap change and
the keyframe spawn, one read each per frame, besides GICP's loop exits.
Between them, on a CUDA device with a pruned-kernel backend,
:func:`odom_frame` replays each stretch outside GICP from a CUDA graph
captured on its first use (``utils/graphs.py``, :func:`_stretches`): the
front and the normals, the submap selection and rebuild, the keyframe
decision and spawn, and what the frame hands on (:func:`_carried`). The
stage functions take that runner as ``run``; the CPU, "brute",
"hashgrid", the batched step and the stage tools run the same stage
functions operation by operation.

The backend (``config.resolve_backend``) picks each stage's branch, as in
the JAX package: on the pruned-kernel backends the scan and the submap are
Z-ordered, normals come from the radius moments (K1) and the GICP search is
K2, K4 or the fused K3; on "brute" and "hashgrid" the scan stays in voxel
order, normals come from k-NN (exact, or two-scale hash grid) and the
search is the exhaustive or the hash-grid tensor op. With
``host_preprocess`` the scan arrives already voxelized and Z-ordered.

Normals are computed ONCE per scan and reused as the S2M source normals
and, via the carried previous scan, as the next frame's S2S target normals
(reference ``odom.cc:815, 818``).

:func:`init_frame` and :func:`odom_frame_batched` run B independent
sequences in lock-step on a batched state (``parallel/batched.py``), the
JAX package's step under ``jax.vmap``, on every backend: the same stages
over a leading lane dimension, each kernel launched (or each tensor-op
search run) once for all lanes, the three branches
(rescue, submap rebuild, keyframe spawn) one host read of a [B] flag each,
run for the lanes that need them. Each lane equals the single-sequence
:func:`odom_frame` with ``hull_masks=None``. The batched step shares the
pieces that do not depend on the lanes (:func:`front`,
:func:`s2s_passes` with :func:`s2s_target`, :func:`s2m_target`,
:func:`rescue_due`, :func:`wide_gate`, :func:`guarded_pose`,
:func:`finish`; those that must differ by lanes branch on a tensor's
rank) and runs its lanes through the batched forms (``gicp.align_batched``,
``submap.assemble_submap_batched``, ``keyframes.maybe_spawn_batched``).
"""

from __future__ import annotations

import dataclasses

import torch

from direct_lidar_odometry_tpu_torch.config import DloConfig, GicpStageConfig, resolve_backend
from direct_lidar_odometry_tpu_torch.core import se3
from direct_lidar_odometry_tpu_torch.core.cloud import PointCloud, gather_rows
from direct_lidar_odometry_tpu_torch.ops import hashgrid, morton, preprocess as prep, voxel
from direct_lidar_odometry_tpu_torch.odometry import adaptive, keyframes, submap
from direct_lidar_odometry_tpu_torch.odometry.state import FrameResult, OdomState, empty_state
from direct_lidar_odometry_tpu_torch.registration import covariance, gicp
from direct_lidar_odometry_tpu_torch.utils import graphs, sync
from direct_lidar_odometry_tpu_torch.utils.lanes import lanes_where, per_lane


def preprocess_scan(
    raw_points: torch.Tensor, raw_mask: torch.Tensor, cfg: DloConfig, backend: str | None = None,
) -> PointCloud:
    """NaN/crop mask + voxel downsample into the n_scan capacity (reference
    ``preprocessPoints``, ``odom.cc:443-465``), Z-ordered on the
    pruned-kernel backends. Raw clouds with a leading lane dimension are
    prepared lane by lane."""
    if cfg.host_preprocess:
        # the host already ran NaN/crop/voxel and emitted Z-ordered voxel
        # centroids (io/hostprep.py, the device path's semantics); the
        # invalid slots were padded by the wire decode
        return PointCloud(points=raw_points, mask=raw_mask)
    backend = backend or resolve_backend(cfg)
    crop = cfg.preprocessing.crop.size if cfg.preprocessing.crop.use else None
    c = prep.preprocess(PointCloud(points=raw_points, mask=raw_mask), crop)
    if cfg.preprocessing.voxel_scan.use:
        res = cfg.preprocessing.voxel_scan.res
        if gicp.is_pallas(backend):
            # ONE sort does voxel grouping AND the Z-ordering the pruned kernels need
            return voxel.voxel_downsample_morton(c, res, out_capacity=cfg.shapes.n_scan)
        return voxel.voxel_downsample(c, res, out_capacity=cfg.shapes.n_scan)
    # no voxel: compact valid points to the front and truncate to capacity
    order = torch.sort((~c.mask).to(torch.uint8), stable=True).indices[..., : cfg.shapes.n_scan]
    c = PointCloud(points=gather_rows(c.points, order), mask=gather_rows(c.mask, order))
    if gicp.is_pallas(backend):
        c = PointCloud(*morton.sort_cloud(c.points, c.mask))
    return c


def _scan_normals(scan: PointCloud, cfg: DloConfig, backend: str | None = None) -> covariance.Normals:
    backend = backend or resolve_backend(cfg)
    k = cfg.gicp.s2s.k_correspondences
    chunk = min(cfg.shapes.knn_query_chunk, cfg.shapes.n_scan)
    if backend == "brute":
        return covariance.estimate_normals_brute(scan.points, scan.mask, k=k, chunk=chunk)
    if not gicp.is_pallas(backend):
        return covariance.estimate_normals_twoscale(
            scan.points, scan.mask, k=k, table_size=cfg.shapes.grid_table_size,
            cap=cfg.shapes.cell_cap_knn, chunk=chunk,
        )
    res = cfg.preprocessing.voxel_scan.res if cfg.preprocessing.voxel_scan.use else 0.25
    clo, chi = morton.chunk_aabbs(scan.points, scan.mask, morton.TARGET_CHUNK)
    return covariance.estimate_normals_radius_sorted(
        scan.points, scan.mask, clo, chi, radius=3.0 * res
    )


def init_frame(
    cfg: DloConfig,
    state: OdomState,
    raw_points: torch.Tensor,
    raw_mask: torch.Tensor,
) -> OdomState:
    """First frame: set the S2S target and spawn the first keyframe. Also
    of every lane of a batched state (raw_points [B, N, 3], raw_mask
    [B, N])."""
    backend = resolve_backend(cfg)
    scan = preprocess_scan(raw_points, raw_mask, cfg, backend)
    nrm = _scan_normals(scan, cfg, backend)
    spac = adaptive.update_spaciousness(
        state.spaciousness, scan.points, scan.mask, cfg.adaptive.lpf_alpha
    )
    cloud_kf, nrm_kf = keyframes.make_keyframe_cloud(scan, state.pose, cfg, backend)
    position = se3.se3_translation(state.pose)
    quat = se3.rotmat_to_quat(se3.se3_rotation(state.pose))
    kf, _, _ = keyframes.insert(state.keyframes, position, quat, cloud_kf, nrm_kf,
                                seq=state.frame_idx)
    return state._replace(
        prev_points=scan.points,
        prev_mask=scan.mask,
        prev_normals=nrm.normals,
        prev_normals_valid=nrm.valid,
        keyframes=kf,
        spaciousness=spac,
        frame_idx=state.frame_idx + 1,
    )


def _per_corr(res: gicp.GicpResult) -> torch.Tensor:
    return res.final_error / torch.clamp(res.num_correspondences, min=1).to(torch.float32)


def _guess(cfg: DloConfig, state: OdomState, imu_prior: torch.Tensor) -> torch.Tensor:
    """The S2S initial guess (odom.cc:801-806), [..., 4, 4]."""
    if cfg.s2s_prior == "constant_velocity":
        # previous relative motion; an IMU rotation (when fed) overrides it
        if cfg.imu.use:
            return se3.make_se3(imu_prior[..., :3, :3], state.last_delta[..., :3, 3])
        return state.last_delta
    return imu_prior  # reference behavior (odom.cc:801-806)


def front(cfg: DloConfig, spaciousness: torch.Tensor, raw_points: torch.Tensor,
          raw_mask: torch.Tensor, backend: str) -> tuple[PointCloud, torch.Tensor, torch.Tensor]:
    """The frame's scan (:func:`preprocess_scan`), the spaciousness
    low-passed from the state's ``spaciousness`` and the keyframe distance
    threshold it sets (``odom.cc:650-659, 1188-1199``); each lane's over
    raw clouds [B, N, ...]."""
    scan = preprocess_scan(raw_points, raw_mask, cfg, backend)
    spac = adaptive.update_spaciousness(
        spaciousness, scan.points, scan.mask, cfg.adaptive.lpf_alpha
    )
    if cfg.adaptive.use:
        thresh_dist = adaptive.keyframe_thresh_from_spaciousness(spac)
    else:
        thresh_dist = torch.full_like(spac, cfg.keyframe.thresh_dist)
    return scan, spac, thresh_dist


def coarse_stride(cfg: DloConfig) -> int:
    """The coarse S2S stride: ``gicp.s2s_coarse_stride``, lowered to the
    nearest stride whose strided scan keeps whole Morton chunks."""
    cs = max(1, int(cfg.gicp.s2s_coarse_stride))
    while cs > 1 and (cfg.shapes.n_scan // cs) % morton.TARGET_CHUNK != 0:
        cs -= 1
    return cs


def s2s_passes(cfg: DloConfig) -> list[tuple[int, GicpStageConfig]]:
    """(stride, stage config) of each S2S align (``odom.cc:801-809``), in
    order, each seeded by the one before; the last is the S2S result.
    Coarse to fine: at a :func:`coarse_stride` > 1 an align over every
    stride-th point of the Morton-sorted clouds, capped at
    ``s2s_coarse_max_iterations``, then the full-resolution align with the
    reference's own convergence criteria, only with ``s2s_full_polish``
    (see GicpConfig.s2s_coarse_stride); at stride 1 the full align alone."""
    cs = coarse_stride(cfg)
    s2s = cfg.gicp.s2s
    passes = []
    if cs > 1:
        passes.append((cs, dataclasses.replace(
            s2s, max_iterations=min(cfg.gicp.s2s_coarse_max_iterations, s2s.max_iterations))))
    if cs == 1 or cfg.gicp.s2s_full_polish:
        passes.append((1, s2s))
    return passes


def strided(tensors, stride: int) -> tuple:
    """Every ``stride``-th row of each tensor, made contiguous (each lane's
    rows when the first, the points, is [B, N, 3]); at stride 1 the
    tensors themselves."""
    if stride == 1:
        return tuple(tensors)
    rows = (slice(None),) * (tensors[0].dim() - 2) + (slice(None, None, stride),)
    return tuple(t[rows].contiguous() for t in tensors)


def s2s_target(cfg: DloConfig, state: OdomState, stride: int, backend: str) -> gicp.GicpTarget:
    """The S2S target: every ``stride``-th point of the previous scan, with
    its normals."""
    prev = strided((state.prev_points, state.prev_mask, state.prev_normals,
                    state.prev_normals_valid), stride)
    return gicp.make_target(*prev, cfg.gicp.s2s.max_correspondence_distance,
                            cfg.shapes.grid_table_size, backend)


def s2s_align(cfg: DloConfig, state: OdomState, src: gicp.GicpSource, guess: torch.Tensor,
              stride: int, stage: GicpStageConfig, backend: str) -> gicp.GicpResult:
    """One align of :func:`s2s_passes`: every ``stride``-th point of the
    scan onto :func:`s2s_target`, from ``guess``."""
    src = gicp.GicpSource(*strided(src, stride))
    return gicp.align(src, s2s_target(cfg, state, stride, backend), guess, stage, backend,
                      cfg.shapes.cell_cap_1nn)


def submap_stage(cfg: DloConfig, state: OdomState, t_s2s_global: torch.Tensor,
                 thresh_dist: torch.Tensor, directions: torch.Tensor,
                 hull_masks: tuple[torch.Tensor, torch.Tensor, bool] | None,
                 backend: str, run=graphs.eager) -> tuple[OdomState, bool]:
    """The submap's keyframes around the S2S-propagated position, and the
    submap rebuilt if they changed (``odom.cc:825-834``): the state and
    the changed flag. The selection and the rebuild are stretches of
    ``run``."""
    query_pos = se3.se3_translation(t_s2s_global)
    sel = run(submap.select_submap_keyframes, state.keyframes, state.submap_members, query_pos,
              thresh_dist, cfg, directions, hull_masks)
    return submap.assemble_submap(state, sel, query_pos, cfg, backend, run)


def s2m_target(state: OdomState, backend: str) -> gicp.GicpTarget:
    """The S2M target over the state's submap (each lane's with lanes)."""
    cloud = (state.submap_points, state.submap_mask, state.submap_normals,
             state.submap_normals_valid)
    if gicp.is_pallas(backend):
        # the submap is Z-ordered at assembly; its AABBs are cheap per frame
        return gicp.make_target(*cloud)
    # "hashgrid": the grid built at assembly; "brute": no index
    return gicp.GicpTarget(*cloud, grid=state.submap_grid)


def rescue_due(cfg: DloConfig, src: gicp.GicpSource, s2s_res: gicp.GicpResult,
               s2m_res: gicp.GicpResult) -> torch.Tensor:
    """Whether the staged-gate rescue (GicpConfig.s2m_rescue) is due, on
    the device: either stage's per-correspondence Mahalanobis error says
    the solver stalled outside the tight S2M basin. [B] with lanes."""
    s2s_per = _per_corr(s2s_res)
    s2m_per = _per_corr(s2m_res)
    n_valid_src = torch.clamp(torch.sum(src.mask.to(torch.int32), dim=-1), min=1).to(torch.float32)
    corr_frac = s2m_res.num_correspondences.to(torch.float32) / n_valid_src
    s2m_unhealthy = (
        (s2m_per > cfg.gicp.rescue_s2m_error)
        | (corr_frac < cfg.gicp.rescue_min_corr_frac)
        | (s2m_res.num_correspondences == 0)
    )
    s2s_alarm = (s2s_per > cfg.gicp.rescue_s2s_error) & (
        s2m_per > cfg.gicp.rescue_s2m_corroborate * cfg.gicp.rescue_s2m_error
    )
    return s2m_unhealthy | s2s_alarm


def wide_gate(cfg: DloConfig) -> GicpStageConfig:
    """The rescue's first align: the S2M stage at ``rescue_corr_distance``."""
    return dataclasses.replace(cfg.gicp.s2m, max_correspondence_distance=cfg.gicp.rescue_corr_distance)


def s2m_stage(cfg: DloConfig, state: OdomState, src: gicp.GicpSource, guess: torch.Tensor,
              s2s_res: gicp.GicpResult, backend: str,
              ) -> tuple[gicp.GicpTarget, gicp.GicpResult, bool]:
    """S2M, the scan against the submap from the S2S-propagated ``guess``
    (``odom.cc:837-847``): the target, the result, and whether the rescue
    is due (one host read, with ``s2m_rescue``)."""
    target = s2m_target(state, backend)
    res = gicp.align(src, target, guess, cfg.gicp.s2m, backend, cfg.shapes.cell_cap_1nn)
    return target, res, cfg.gicp.s2m_rescue and sync.read(rescue_due(cfg, src, s2s_res, res))


def rescue_stage(cfg: DloConfig, src: gicp.GicpSource, target: gicp.GicpTarget,
                 guess: torch.Tensor, backend: str) -> gicp.GicpResult:
    """The staged-gate rescue: register with the wide gate from ``guess``,
    then re-refine on the S2M ``target`` at the reference gate."""
    wide_target = target
    if backend == "hashgrid":
        # the grid's cell is the build radius: the wide gate needs its own
        # grid over the same submap
        wide_target = gicp.make_target(*target[:4], cfg.gicp.rescue_corr_distance,
                                       cfg.shapes.submap_table_size, backend)
    cap = cfg.shapes.cell_cap_1nn
    r1 = gicp.align(src, wide_target, guess, wide_gate(cfg), backend, cap)
    return gicp.align(src, target, r1.transform, cfg.gicp.s2m, backend, cap)


def guarded_pose(s2m_res: gicp.GicpResult, t_s2s_global: torch.Tensor) -> torch.Tensor:
    """The frame's pose: the S2M estimate, or the S2S-propagated pose where
    S2M found no correspondences (tracking lost) rather than garbage."""
    return torch.where((s2m_res.num_correspondences > 0)[..., None, None], s2m_res.transform,
                       t_s2s_global)


def keyframe_stage(cfg: DloConfig, state: OdomState, scan: PointCloud, pose: torch.Tensor,
                   thresh_dist: torch.Tensor, s2m_res: gicp.GicpResult, backend: str,
                   run=graphs.eager):
    """The keyframe spawn (``odom.cc:678, 1097-1181``): (store, spawned,
    evicted, slot). The decision and the spawn are stretches of ``run``."""
    return keyframes.maybe_spawn(state.keyframes, scan, pose, cfg, thresh_dist,
                                 seq=state.frame_idx, health=_per_corr(s2m_res), backend=backend,
                                 run=run)


def _relative(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return se3.se3_inverse(a) @ b


def _carried(state_pose: torch.Tensor, pose: torch.Tensor, members: torch.Tensor,
             evicted: torch.Tensor, frame_idx: torch.Tensor, scan: PointCloud,
             nrm: covariance.Normals, spac: torch.Tensor, thresh_dist: torch.Tensor,
             count: torch.Tensor, slot: torch.Tensor) -> tuple:
    """Every tensor the frame hands on: the cached submap's members (an
    eviction clears them), the relative motion, the next frame index, the
    pose's position and quaternion, and the rest as they came."""
    # eviction rewrote a slot under a possibly-unchanged membership mask:
    # clearing the cached members forces a submap rebuild next frame
    members = torch.where(evicted[..., None], False, members)
    last_delta = (per_lane(_relative, state_pose, pose) if pose.dim() == 3
                  else _relative(state_pose, pose))
    position = se3.se3_translation(pose)
    quat = se3.rotmat_to_quat(se3.se3_rotation(pose))
    return (members, last_delta, frame_idx + 1, position, quat, pose, scan, nrm, spac,
            thresh_dist, count, evicted, slot)


def finish(state: OdomState, scan: PointCloud, nrm: covariance.Normals, spac: torch.Tensor,
           thresh_dist: torch.Tensor, pose: torch.Tensor, s2s_res: gicp.GicpResult,
           s2m_res: gicp.GicpResult, submap_changed: torch.Tensor,
           spawn: tuple, run=graphs.eager) -> tuple[OdomState, FrameResult]:
    """The next state, which carries the scan as the next S2S target, and
    the frame's :class:`FrameResult`; ``spawn`` is the keyframe stage's
    (store, spawned, evicted, slot). Each lane's with lanes. What the
    frame hands on is one stretch of ``run``, whose outputs outlive it."""
    kf, spawned, kf_evicted, kf_slot = spawn
    (members, last_delta, frame_idx, position, quat, pose, scan, nrm, spac, thresh_dist, count,
     kf_evicted, kf_slot) = run(_carried, state.pose, pose, state.submap_members, kf_evicted,
                                state.frame_idx, scan, nrm, spac, thresh_dist, kf.count, kf_slot,
                                keep=True)
    new_state = state._replace(
        submap_members=members,
        pose=pose,
        t_s2s=pose,  # T_s2s_prev <- T (odom.cc:843)
        last_delta=last_delta,
        prev_points=scan.points,
        prev_mask=scan.mask,
        prev_normals=nrm.normals,
        prev_normals_valid=nrm.valid,
        keyframes=kf._replace(count=count),
        spaciousness=spac,
        frame_idx=frame_idx,
    )
    result = FrameResult(
        pose=pose,
        position=position,
        quat=quat,
        new_keyframe=spawned,
        kf_slot=kf_slot,
        kf_evicted=kf_evicted,
        num_keyframes=count,
        submap_changed=submap_changed,
        spaciousness=spac,
        keyframe_thresh_dist=thresh_dist,
        s2s_iterations=s2s_res.iterations,
        s2s_error=s2s_res.final_error,
        s2s_num_corr=s2s_res.num_correspondences,
        s2s_converged=s2s_res.converged,
        s2m_iterations=s2m_res.iterations,
        s2m_error=s2m_res.final_error,
        s2m_num_corr=s2m_res.num_correspondences,
        s2m_converged=s2m_res.converged,
    )
    return new_state, result


def _stretches(state: OdomState, backend: str):
    """How :func:`odom_frame` runs its stretches outside GICP
    (``utils/graphs.py``): on a CUDA device with a pruned-kernel backend and
    one sequence, replayed from CUDA graphs on the state's keyframe ring,
    as ``gicp.align`` replays its iterations; elsewhere one operation at a
    time (counted on a card)."""
    if state.pose.device.type != "cuda":
        return graphs.eager
    if not gicp.is_pallas(backend) or state.keyframes.count.dim():
        return graphs.eager_on_card
    return _ring_graphs(state)


def _ring_graphs(state: OdomState) -> graphs.Stretches:
    """The graphs of the state's keyframe ring, which read and write the
    ring and the submap cache where they are."""
    kf = state.keyframes
    return graphs.Stretches(kf.positions, (
        kf.positions, kf.quats, kf.points, kf.masks, kf.normals, kf.normals_valid, kf.seq,
        kf.health, state.submap_points, state.submap_mask, state.submap_normals,
        state.submap_normals_valid))


def odom_frame(
    cfg: DloConfig,
    directions: torch.Tensor,
    state: OdomState,
    raw_points: torch.Tensor,
    raw_mask: torch.Tensor,
    imu_prior: torch.Tensor,
    hull_masks: tuple[torch.Tensor, torch.Tensor, bool] | None = None,
) -> tuple[OdomState, FrameResult]:
    """One odometry frame (reference ``icpCB`` body + ``getNextPose``).

    ``state`` is consumed: its keyframe ring and submap cache are written in
    place, so only the returned state may be used afterwards. The frame is
    the span ``step``, each stage a ``step.*`` span (``utils/sync.py``).
    """
    with sync.span("step"):
        return _odom_frame(cfg, directions, state, raw_points, raw_mask, imu_prior, hull_masks)


def _odom_frame(
    cfg: DloConfig,
    directions: torch.Tensor,
    state: OdomState,
    raw_points: torch.Tensor,
    raw_mask: torch.Tensor,
    imu_prior: torch.Tensor,
    hull_masks: tuple[torch.Tensor, torch.Tensor, bool] | None,
) -> tuple[OdomState, FrameResult]:
    backend = resolve_backend(cfg)
    run = _stretches(state, backend)
    with sync.span("step.preprocess"):
        scan, spac, thresh_dist = run(front, cfg, state.spaciousness, raw_points, raw_mask,
                                      backend)
    # per-scan normals, computed exactly once (odom.cc:815,818)
    with sync.span("step.normals"):
        nrm = run(_scan_normals, scan, cfg, backend)
    src = gicp.GicpSource(
        points=scan.points, mask=scan.mask, normals=nrm.normals, normals_valid=nrm.valid,
    )
    guess = _guess(cfg, state, imu_prior)
    for stride, stage in s2s_passes(cfg):
        with sync.span("step.s2s_coarse" if stride > 1 else "step.s2s"):
            s2s_res = s2s_align(cfg, state, src, guess, stride, stage, backend)
        guess = s2s_res.transform
    # propagate S2S into the global frame (odom.cc:812, 926-943)
    t_s2s_global = state.t_s2s @ s2s_res.transform
    with sync.span("step.submap"):
        state, submap_changed = submap_stage(cfg, state, t_s2s_global, thresh_dist, directions,
                                             hull_masks, backend, run)
    with sync.span("step.s2m"):
        s2m_tgt, s2m_res, rescue = s2m_stage(cfg, state, src, t_s2s_global, s2s_res, backend)
    if rescue:
        with sync.span("step.rescue"):
            s2m_res = rescue_stage(cfg, src, s2m_tgt, t_s2s_global, backend)
    pose = guarded_pose(s2m_res, t_s2s_global)
    with sync.span("step.keyframe"):
        spawn = keyframe_stage(cfg, state, scan, pose, thresh_dist, s2m_res, backend, run)
    return finish(state, scan, nrm, spac, thresh_dist, pose, s2s_res, s2m_res, submap_changed,
                  spawn, run)


def _select(flags: torch.Tensor, new: gicp.GicpResult, old: gicp.GicpResult) -> gicp.GicpResult:
    """Per lane, ``new`` where the [B] ``flags`` are set, else ``old``."""
    return gicp.GicpResult(*(torch.where(flags.reshape(flags.shape + (1,) * (a.dim() - 1)), a, b)
                             for a, b in zip(new, old)))


def odom_frame_batched(
    cfg: DloConfig,
    directions: torch.Tensor,
    state: OdomState,
    raw_points: torch.Tensor,
    raw_mask: torch.Tensor,
    imu_prior: torch.Tensor,
) -> tuple[OdomState, FrameResult]:
    """:func:`odom_frame` of B lanes in lock-step: a batched state, raw
    scans [B, N, 3] / [B, N], IMU priors [B, 4, 4]; the device hull
    surrogates (``hull_masks=None``); every backend. Returns the state and
    a :class:`FrameResult` of [B] tensors.

    Host reads: the GICP loops' flags ([2, B] per inner iteration, so as
    many reads as the slowest lane needs), then one [B] read each for the
    rescue, the submap change and the keyframe spawn, whatever B. A branch
    no lane takes does not run; the lanes that take it run it together and
    its results go to them alone. ``state`` is consumed as in
    :func:`odom_frame`.
    """
    backend = resolve_backend(cfg)
    cap = cfg.shapes.cell_cap_1nn
    scan, spac, thresh_dist = front(cfg, state.spaciousness, raw_points, raw_mask, backend)
    nrm = _scan_normals(scan, cfg, backend)
    src = gicp.GicpSource(
        points=scan.points, mask=scan.mask, normals=nrm.normals, normals_valid=nrm.valid,
    )
    guess = _guess(cfg, state, imu_prior)
    for stride, stage in s2s_passes(cfg):
        s2s_res = gicp.align_batched(gicp.GicpSource(*strided(src, stride)),
                                     s2s_target(cfg, state, stride, backend), guess, stage,
                                     backend, cap=cap)
        guess = s2s_res.transform
    t_s2s_global = per_lane(torch.matmul, state.t_s2s, s2s_res.transform)

    query_pos = se3.se3_translation(t_s2s_global)
    sel = submap.select_submap_keyframes(
        state.keyframes, state.submap_members, query_pos, thresh_dist, cfg, directions,
    )
    state, submap_changed = submap.assemble_submap_batched(state, sel, query_pos, cfg, backend)

    # S2M, and the staged-gate rescue for the lanes that need it
    s2m_tgt = s2m_target(state, backend)
    s2m_res = gicp.align_batched(src, s2m_tgt, t_s2s_global, cfg.gicp.s2m, backend, cap=cap)
    if cfg.gicp.s2m_rescue:
        rescue = rescue_due(cfg, src, s2s_res, s2m_res)
        rescue_h = sync.read(rescue)
        if any(rescue_h):
            active = (rescue, rescue_h)
            wide_target = s2m_tgt
            if backend == "hashgrid":
                # the wide gate's own grid, built for the rescued lanes
                # alone; the other lanes keep their S2M grid (their results
                # are not used)
                lanes = lanes_where(rescue, sum(rescue_h))
                wide = hashgrid.build(state.submap_points[lanes], state.submap_mask[lanes],
                                      cfg.gicp.rescue_corr_distance, cfg.shapes.submap_table_size)
                wide_target = s2m_tgt._replace(grid=hashgrid.HashGrid(
                    *(g.index_copy(0, lanes, w) for g, w in zip(state.submap_grid, wide))))
            r1 = gicp.align_batched(src, wide_target, t_s2s_global, wide_gate(cfg), backend,
                                    active, cap=cap)
            r2 = gicp.align_batched(src, s2m_tgt, r1.transform, cfg.gicp.s2m, backend, active,
                                    cap=cap)
            s2m_res = _select(rescue, r2, s2m_res)
    pose = guarded_pose(s2m_res, t_s2s_global)

    spawn = keyframes.maybe_spawn_batched(
        state.keyframes, scan, pose, cfg, thresh_dist,
        seq=state.frame_idx, health=_per_corr(s2m_res), backend=backend,
    )
    return finish(state, scan, nrm, spac, thresh_dist, pose, s2s_res, s2m_res, submap_changed,
                  spawn)


def fresh_state(cfg: DloConfig, initial_pose: torch.Tensor | None = None, device="cuda") -> OdomState:
    return empty_state(cfg, initial_pose, device)
