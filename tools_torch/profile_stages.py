"""Per-stage profile of the per-frame step at the bench's shapes.

Port of the JAX package's ``tools/profile_stages.py``.

    python3 tools_torch/profile_stages.py [--small]

Measures each stage of ``pipeline.odom_frame`` as a call of its own on real
data: the bench frame of ``ablate_step.capture_frame`` (``bench.py``'s
operating point and world, the state after 8 frames through
``OdometryRunner``, frame 8 encoded as the runner encodes it, the transfer
not quantized). Rows, in the JAX tool's order and under its names:
"preprocess+morton", "normals", "s2s make_target" (the S2S targets the
step builds: the strided one at the coarse stride, the full-resolution one
only with ``s2s_full_polish``), "s2s align" (the step's S2S aligns, seeded
as in the step), "submap select+assemble" (spaciousness, selection through
the device hull surrogates, the rebuild if the members changed), "s2m
align" (S2M and the staged-gate rescue), "keyframe maybe_spawn" (the
step's pose, threshold, sequence number and health; ``spawned`` says
whether it spawned) and "FULL step (odom_frame)". Each row carries
``devprof.stage_profile``'s columns: the median synced ms of ``n`` calls,
the device operations and busy ms of one call (torch.profiler), its host
reads and its K1-K6 launches. A stage that writes the state in place runs
on a copy of its own, so every call does the same work. The host's
preprocessing of the frame (``runner._prep_points``) is timed apart; with
``cfg=production_cfg(small).replace(host_preprocess=False)`` the device
step voxelizes the raw scan instead.

Runs on the card and raises without one; on the CPU call :func:`run` with
``device="cpu"`` and a small config.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import production_cfg  # noqa: E402
from direct_lidar_odometry_tpu_torch.config import DloConfig, resolve_backend  # noqa: E402
from direct_lidar_odometry_tpu_torch.core import se3  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry import adaptive, keyframes, pipeline, submap  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry.state import clone_state  # noqa: E402
from direct_lidar_odometry_tpu_torch.registration import gicp  # noqa: E402
from tools_torch import ablate_step, devprof  # noqa: E402

STAGES = ("preprocess+morton", "normals", "s2s make_target", "s2s align",
          "submap select+assemble", "s2m align", "keyframe maybe_spawn", "FULL step (odom_frame)")


def submap_stage(cfg: DloConfig, state, scan, t_s2s_global, directions, backend):
    """Spaciousness, threshold, submap selection and assembly, as the step
    runs them; returns (state, threshold)."""
    spac = adaptive.update_spaciousness(state.spaciousness, scan.points, scan.mask,
                                        cfg.adaptive.lpf_alpha)
    thresh = ablate_step.thresh_dist(cfg, spac)
    query_pos = se3.se3_translation(t_s2s_global)
    sel = submap.select_submap_keyframes(state.keyframes, state.submap_members, query_pos,
                                         thresh, cfg, directions)
    state, _ = submap.assemble_submap(state, sel, query_pos, cfg, backend)
    return state, thresh


def run(small: bool = False, device="cuda", cfg: DloConfig | None = None, frames: int = 8,
        n: int = 8) -> list[dict]:
    """The stage rows (``stage`` and ``stage_profile``'s columns; the
    keyframe row also ``spawned``). ``cfg`` defaults to
    ``production_cfg(small)``."""
    cfg = (production_cfg(small) if cfg is None else cfg).replace(quantize_transfer=False)
    fr = ablate_step.capture_frame(cfg, small, device, frames)
    cfg, dev, state = fr.cfg, fr.device, fr.state
    backend = resolve_backend(cfg)
    host_prep_ms = float(np.median([devprof.synced_ms(lambda: fr.runner._prep_points(fr.raw),
                                                      "cpu") for _ in range(n)]))
    print(f"# device={dev.type} backend={backend} n_scan={cfg.shapes.n_scan} "
          f"host_preprocess={cfg.host_preprocess} host prep ms (median of {n}): {host_prep_ms}",
          file=sys.stderr)

    # the stages' inputs, each the output of the stage before, as in the step
    scan = pipeline.preprocess_scan(fr.points, fr.mask, cfg, backend)
    nrm = pipeline._scan_normals(scan, cfg, backend)
    src = gicp.GicpSource(scan.points, scan.mask, nrm.normals, nrm.valid)
    guess = pipeline._guess(cfg, state, fr.imu_prior)
    passes = ablate_step.s2s_passes(cfg)
    targets = [ablate_step.s2s_target(cfg, state, backend, s) for s, _ in passes]
    s2s = ablate_step.s2s_aligns(cfg, src, targets, guess, backend)
    t_global = state.t_s2s @ s2s[-1].transform
    state2, thresh = submap_stage(cfg, clone_state(state), scan, t_global, fr.directions, backend)
    s2m_res = ablate_step.s2m_align(cfg, state2, src, t_global, s2s[-1], backend)
    pose = torch.where(s2m_res.num_correspondences > 0, s2m_res.transform, t_global)
    print(f"# s2s iters={[r.iterations for r in s2s]} s2m iters={s2m_res.iterations}",
          file=sys.stderr)

    st_sub, st_full = clone_state(state), clone_state(state)
    kf_ring = clone_state(state2.keyframes)
    stages = [
        lambda: pipeline.preprocess_scan(fr.points, fr.mask, cfg, backend),
        lambda: pipeline._scan_normals(scan, cfg, backend),
        lambda: [ablate_step.s2s_target(cfg, state, backend, s) for s, _ in passes],
        lambda: ablate_step.s2s_aligns(cfg, src, targets, guess, backend),
        lambda: submap_stage(cfg, st_sub, scan, t_global, fr.directions, backend),
        lambda: ablate_step.s2m_align(cfg, state2, src, t_global, s2s[-1], backend),
        lambda: keyframes.maybe_spawn(kf_ring, scan, pose, cfg, thresh, seq=state.frame_idx,
                                      health=pipeline._per_corr(s2m_res), backend=backend),
        lambda: pipeline.odom_frame(cfg, fr.directions, st_full, fr.points, fr.mask,
                                    fr.imu_prior),
    ]
    rows = [dict(stage=name, **devprof.stage_profile(fn, n, dev))
            for name, fn in zip(STAGES, stages)]
    rows[STAGES.index("keyframe maybe_spawn")]["spawned"] = bool(stages[6]()[1])
    return rows


def main() -> None:
    rows = run(**ablate_step.parse_argv(sys.argv[1:]))
    print(f"{'stage':28s} {devprof.PROFILE_HEADER}")
    for r in rows:
        print(f"{r['stage']:28s} {devprof.format_profile(r)}")
    for r in rows:
        print(f"# row {json.dumps(r)}")


if __name__ == "__main__":
    main()
