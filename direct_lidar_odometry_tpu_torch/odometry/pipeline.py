"""The per-frame odometry step.

Counterpart of the JAX package's ``odometry/pipeline.py`` (reference
``icpCB`` + ``getNextPose``, ``odom.cc:629-697, 792-852``):

    preprocess -> spaciousness/adaptive -> S2S GICP (coarse, then full) ->
    propagate -> submap select/assemble -> S2M GICP -> staged-gate rescue ->
    pose -> keyframe spawn -> carry scan as next target

The first frame goes through :func:`init_frame` (``initializeInputTarget``,
``odom.cc:472-507``). Shapes are fixed by ``cfg.shapes``. PyTorch runs
eagerly, so the JAX package's ``lax.cond`` branches become Python ``if`` on
host reads (``utils/sync.py``): the rescue trigger, the submap change and
the keyframe spawn, one read each per frame, besides GICP's loop exits.

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
:func:`odom_frame` with ``hull_masks=None``.
"""

from __future__ import annotations

import dataclasses

import torch

from direct_lidar_odometry_tpu_torch.config import DloConfig, resolve_backend
from direct_lidar_odometry_tpu_torch.core import se3
from direct_lidar_odometry_tpu_torch.core.cloud import PointCloud, gather_rows
from direct_lidar_odometry_tpu_torch.ops import hashgrid, morton, preprocess as prep, voxel
from direct_lidar_odometry_tpu_torch.odometry import adaptive, keyframes, submap
from direct_lidar_odometry_tpu_torch.odometry.state import FrameResult, OdomState, empty_state
from direct_lidar_odometry_tpu_torch.registration import covariance, gicp
from direct_lidar_odometry_tpu_torch.utils import sync
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
    place, so only the returned state may be used afterwards.
    """
    backend = resolve_backend(cfg)
    shapes = cfg.shapes
    cap = shapes.cell_cap_1nn
    # --- preprocessing + metrics (odom.cc:650-659) ---
    scan = preprocess_scan(raw_points, raw_mask, cfg, backend)
    spac = adaptive.update_spaciousness(
        state.spaciousness, scan.points, scan.mask, cfg.adaptive.lpf_alpha
    )
    if cfg.adaptive.use:
        thresh_dist = adaptive.keyframe_thresh_from_spaciousness(spac)
    else:
        thresh_dist = torch.full_like(spac, cfg.keyframe.thresh_dist)

    # --- per-scan normals, computed exactly once (odom.cc:815,818) ---
    nrm = _scan_normals(scan, cfg, backend)
    src = gicp.GicpSource(
        points=scan.points, mask=scan.mask, normals=nrm.normals, normals_valid=nrm.valid,
    )

    # --- S2S: current scan against previous scan (odom.cc:801-809) ---
    guess = _guess(cfg, state, imu_prior)

    # Coarse-to-fine S2S: a coarse align over every cs-th point of the
    # Morton-sorted clouds seeds the full-resolution align, which keeps the
    # reference's own convergence criteria (see GicpConfig.s2s_coarse_stride).
    # The strided views are made contiguous here, at the call site.
    cs = max(1, int(cfg.gicp.s2s_coarse_stride))
    while cs > 1 and (shapes.n_scan // cs) % morton.TARGET_CHUNK != 0:
        cs -= 1  # degrade to the nearest stride that keeps chunk alignment
    coarse_res = None
    if cs > 1:
        coarse_src = gicp.GicpSource(*(t[::cs].contiguous() for t in src))
        coarse_target = gicp.make_target(
            state.prev_points[::cs].contiguous(), state.prev_mask[::cs].contiguous(),
            state.prev_normals[::cs].contiguous(),
            state.prev_normals_valid[::cs].contiguous(),
            cfg.gicp.s2s.max_correspondence_distance, shapes.grid_table_size, backend,
        )
        coarse_cfg = dataclasses.replace(
            cfg.gicp.s2s,
            max_iterations=min(cfg.gicp.s2s_coarse_max_iterations, cfg.gicp.s2s.max_iterations),
        )
        coarse_res = gicp.align(coarse_src, coarse_target, guess, coarse_cfg, backend, cap)
        guess = coarse_res.transform
    if coarse_res is not None and not cfg.gicp.s2s_full_polish:
        s2s_res = coarse_res
    else:
        s2s_target = gicp.make_target(
            state.prev_points, state.prev_mask, state.prev_normals, state.prev_normals_valid,
            cfg.gicp.s2s.max_correspondence_distance, shapes.grid_table_size, backend,
        )
        s2s_res = gicp.align(src, s2s_target, guess, cfg.gicp.s2s, backend, cap)

    # --- propagate S2S into the global frame (odom.cc:812, 926-943) ---
    t_s2s_global = state.t_s2s @ s2s_res.transform

    # --- submap selection + assembly (odom.cc:825-834) ---
    query_pos = se3.se3_translation(t_s2s_global)
    sel = submap.select_submap_keyframes(
        state.keyframes, state.submap_members, query_pos, thresh_dist, cfg,
        directions, hull_masks,
    )
    state, submap_changed = submap.assemble_submap(state, sel, query_pos, cfg, backend)

    # --- S2M: scan against submap, S2S-propagated guess (odom.cc:837-847) ---
    submap_cloud = (state.submap_points, state.submap_mask, state.submap_normals,
                    state.submap_normals_valid)
    if gicp.is_pallas(backend):
        # the submap is Z-ordered at assembly; its AABBs are cheap per frame
        s2m_target = gicp.make_target(*submap_cloud)
    else:
        # "hashgrid": the grid built at assembly; "brute": no index
        s2m_target = gicp.GicpTarget(*submap_cloud, grid=state.submap_grid)
    s2m_res = gicp.align(src, s2m_target, t_s2s_global, cfg.gicp.s2m, backend, cap)

    if cfg.gicp.s2m_rescue:
        # Staged-gate rescue (GicpConfig.s2m_rescue): when either stage's
        # per-correspondence Mahalanobis error says the solver stalled
        # outside the tight S2M basin, re-register with the wide gate and
        # re-refine at the reference gate.
        s2s_per = _per_corr(s2s_res)
        s2m_per = _per_corr(s2m_res)
        n_valid_src = torch.clamp(torch.sum(src.mask.to(torch.int32)), min=1).to(torch.float32)
        corr_frac = s2m_res.num_correspondences.to(torch.float32) / n_valid_src
        s2m_unhealthy = (
            (s2m_per > cfg.gicp.rescue_s2m_error)
            | (corr_frac < cfg.gicp.rescue_min_corr_frac)
            | (s2m_res.num_correspondences == 0)
        )
        s2s_alarm = (s2s_per > cfg.gicp.rescue_s2s_error) & (
            s2m_per > cfg.gicp.rescue_s2m_corroborate * cfg.gicp.rescue_s2m_error
        )
        if sync.read(s2m_unhealthy | s2s_alarm):
            wide_cfg = dataclasses.replace(
                cfg.gicp.s2m, max_correspondence_distance=cfg.gicp.rescue_corr_distance,
            )
            wide_target = s2m_target
            if backend == "hashgrid":
                # the grid's cell is the build radius: the wide gate needs
                # its own grid over the same submap
                wide_target = gicp.make_target(*submap_cloud, cfg.gicp.rescue_corr_distance,
                                               shapes.submap_table_size, backend)
            r1 = gicp.align(src, wide_target, t_s2s_global, wide_cfg, backend, cap)
            s2m_res = gicp.align(src, s2m_target, r1.transform, cfg.gicp.s2m, backend, cap)

    # guard: no submap correspondences (tracking lost) -> keep the
    # S2S-propagated pose rather than garbage
    pose = torch.where(s2m_res.num_correspondences > 0, s2m_res.transform, t_s2s_global)

    # --- keyframing (odom.cc:678, 1097-1181) ---
    kf, spawned, kf_evicted, kf_slot = keyframes.maybe_spawn(
        state.keyframes, scan, pose, cfg, thresh_dist,
        seq=state.frame_idx, health=_per_corr(s2m_res), backend=backend,
    )
    # eviction rewrote a slot under a possibly-unchanged membership mask:
    # clearing the cached members forces a submap rebuild next frame
    submap_members = torch.where(kf_evicted, False, state.submap_members)

    new_state = state._replace(
        submap_members=submap_members,
        pose=pose,
        t_s2s=pose,  # T_s2s_prev <- T (odom.cc:843)
        last_delta=se3.se3_inverse(state.pose) @ pose,
        prev_points=scan.points,
        prev_mask=scan.mask,
        prev_normals=nrm.normals,
        prev_normals_valid=nrm.valid,
        keyframes=kf,
        spaciousness=spac,
        frame_idx=state.frame_idx + 1,
    )
    result = FrameResult(
        pose=pose,
        position=se3.se3_translation(pose),
        quat=se3.rotmat_to_quat(se3.se3_rotation(pose)),
        new_keyframe=spawned,
        kf_slot=kf_slot,
        kf_evicted=kf_evicted,
        num_keyframes=kf.count,
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
    shapes = cfg.shapes
    cap = shapes.cell_cap_1nn
    scan = preprocess_scan(raw_points, raw_mask, cfg, backend)
    spac = adaptive.update_spaciousness(
        state.spaciousness, scan.points, scan.mask, cfg.adaptive.lpf_alpha
    )
    if cfg.adaptive.use:
        thresh_dist = adaptive.keyframe_thresh_from_spaciousness(spac)
    else:
        thresh_dist = torch.full_like(spac, cfg.keyframe.thresh_dist)

    nrm = _scan_normals(scan, cfg, backend)
    src = gicp.GicpSource(
        points=scan.points, mask=scan.mask, normals=nrm.normals, normals_valid=nrm.valid,
    )

    # --- S2S, coarse then full, as odom_frame ---
    guess = _guess(cfg, state, imu_prior)
    cs = max(1, int(cfg.gicp.s2s_coarse_stride))
    while cs > 1 and (shapes.n_scan // cs) % morton.TARGET_CHUNK != 0:
        cs -= 1
    coarse_res = None
    if cs > 1:
        coarse_src = gicp.GicpSource(*(t[:, ::cs].contiguous() for t in src))
        coarse_target = gicp.make_target(
            state.prev_points[:, ::cs].contiguous(), state.prev_mask[:, ::cs].contiguous(),
            state.prev_normals[:, ::cs].contiguous(),
            state.prev_normals_valid[:, ::cs].contiguous(),
            cfg.gicp.s2s.max_correspondence_distance, shapes.grid_table_size, backend,
        )
        coarse_cfg = dataclasses.replace(
            cfg.gicp.s2s,
            max_iterations=min(cfg.gicp.s2s_coarse_max_iterations, cfg.gicp.s2s.max_iterations),
        )
        coarse_res = gicp.align_batched(coarse_src, coarse_target, guess, coarse_cfg, backend,
                                        cap=cap)
        guess = coarse_res.transform
    if coarse_res is not None and not cfg.gicp.s2s_full_polish:
        s2s_res = coarse_res
    else:
        s2s_target = gicp.make_target(
            state.prev_points, state.prev_mask, state.prev_normals, state.prev_normals_valid,
            cfg.gicp.s2s.max_correspondence_distance, shapes.grid_table_size, backend,
        )
        s2s_res = gicp.align_batched(src, s2s_target, guess, cfg.gicp.s2s, backend, cap=cap)
    t_s2s_global = per_lane(torch.matmul, state.t_s2s, s2s_res.transform)

    # --- submap selection + assembly ---
    query_pos = se3.se3_translation(t_s2s_global)
    sel = submap.select_submap_keyframes(
        state.keyframes, state.submap_members, query_pos, thresh_dist, cfg, directions,
    )
    state, submap_changed = submap.assemble_submap_batched(state, sel, query_pos, cfg, backend)

    # --- S2M, and the staged-gate rescue for the lanes that need it ---
    submap_cloud = (state.submap_points, state.submap_mask, state.submap_normals,
                    state.submap_normals_valid)
    if gicp.is_pallas(backend):
        s2m_target = gicp.make_target(*submap_cloud)
    else:
        s2m_target = gicp.GicpTarget(*submap_cloud, grid=state.submap_grid)
    s2m_res = gicp.align_batched(src, s2m_target, t_s2s_global, cfg.gicp.s2m, backend, cap=cap)
    if cfg.gicp.s2m_rescue:
        s2s_per = _per_corr(s2s_res)
        s2m_per = _per_corr(s2m_res)
        n_valid_src = torch.clamp(torch.sum(src.mask.to(torch.int32), dim=-1), min=1)
        corr_frac = s2m_res.num_correspondences.to(torch.float32) / n_valid_src.to(torch.float32)
        s2m_unhealthy = (
            (s2m_per > cfg.gicp.rescue_s2m_error)
            | (corr_frac < cfg.gicp.rescue_min_corr_frac)
            | (s2m_res.num_correspondences == 0)
        )
        s2s_alarm = (s2s_per > cfg.gicp.rescue_s2s_error) & (
            s2m_per > cfg.gicp.rescue_s2m_corroborate * cfg.gicp.rescue_s2m_error
        )
        rescue = s2m_unhealthy | s2s_alarm
        rescue_h = sync.read(rescue)
        if any(rescue_h):
            wide_cfg = dataclasses.replace(
                cfg.gicp.s2m, max_correspondence_distance=cfg.gicp.rescue_corr_distance,
            )
            active = (rescue, rescue_h)
            wide_target = s2m_target
            if backend == "hashgrid":
                # the wide gate's own grid, built for the rescued lanes
                # alone; the other lanes keep their S2M grid (their results
                # are not used)
                lanes = lanes_where(rescue, sum(rescue_h))
                wide = hashgrid.build(state.submap_points[lanes], state.submap_mask[lanes],
                                      cfg.gicp.rescue_corr_distance, shapes.submap_table_size)
                wide_target = s2m_target._replace(grid=hashgrid.HashGrid(
                    *(g.index_copy(0, lanes, w) for g, w in zip(state.submap_grid, wide))))
            r1 = gicp.align_batched(src, wide_target, t_s2s_global, wide_cfg, backend, active,
                                    cap=cap)
            r2 = gicp.align_batched(src, s2m_target, r1.transform, cfg.gicp.s2m, backend, active,
                                    cap=cap)
            s2m_res = _select(rescue, r2, s2m_res)

    pose = torch.where((s2m_res.num_correspondences > 0)[:, None, None], s2m_res.transform,
                       t_s2s_global)

    # --- keyframing ---
    kf, spawned, kf_evicted, kf_slot = keyframes.maybe_spawn_batched(
        state.keyframes, scan, pose, cfg, thresh_dist,
        seq=state.frame_idx, health=_per_corr(s2m_res), backend=backend,
    )
    submap_members = torch.where(kf_evicted[:, None], False, state.submap_members)

    new_state = state._replace(
        submap_members=submap_members,
        pose=pose,
        t_s2s=pose,
        last_delta=per_lane(lambda a, b: se3.se3_inverse(a) @ b, state.pose, pose),
        prev_points=scan.points,
        prev_mask=scan.mask,
        prev_normals=nrm.normals,
        prev_normals_valid=nrm.valid,
        keyframes=kf,
        spaciousness=spac,
        frame_idx=state.frame_idx + 1,
    )
    result = FrameResult(
        pose=pose,
        position=se3.se3_translation(pose),
        quat=se3.rotmat_to_quat(se3.se3_rotation(pose)),
        new_keyframe=spawned,
        kf_slot=kf_slot,
        kf_evicted=kf_evicted,
        num_keyframes=kf.count,
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


def fresh_state(cfg: DloConfig, initial_pose: torch.Tensor | None = None, device="cuda") -> OdomState:
    return empty_state(cfg, initial_pose, device)
