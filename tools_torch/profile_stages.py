"""Per-stage profile of the per-frame step at the bench's shapes.

Port of the JAX package's ``tools/profile_stages.py``.

    python3 tools_torch/profile_stages.py [--small]

Measures each stage of ``pipeline.odom_frame`` as a call of its own on real
data: the bench frame of ``ablate_step.capture_frame`` (``bench.py``'s
operating point and world, the state after 8 frames through
``OdometryRunner``, frame 8 encoded as the runner encodes it, the transfer
not quantized). Rows, in the JAX tool's order and under its names, each
calling the step's own stage functions (``pipeline.py``):
"preprocess+morton" (``front``: the scan, spaciousness and keyframe
threshold), "normals", "s2s make_target" (the S2S targets the
step builds: the strided one at the coarse stride, the full-resolution one
only with ``s2s_full_polish``), "s2s align" (the step's S2S aligns, seeded
as in the step), "submap select+assemble" (``submap_stage``: selection
through the device hull surrogates, the rebuild if the members changed),
"s2m align" (``s2m_stage`` and the staged-gate rescue), "keyframe
maybe_spawn" (``keyframe_stage`` on the step's pose, threshold, sequence
number and health; ``spawned`` says whether it spawned) and "FULL step
(odom_frame)". Each row carries
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

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bench_torch import production_cfg  # noqa: E402
from direct_lidar_odometry_tpu_torch.config import DloConfig, resolve_backend  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry import pipeline  # noqa: E402
from direct_lidar_odometry_tpu_torch.odometry.state import clone_state  # noqa: E402
from direct_lidar_odometry_tpu_torch.registration import gicp  # noqa: E402
from tools_torch import ablate_step, devprof  # noqa: E402

STAGES = ("preprocess+morton", "normals", "s2s make_target", "s2s align",
          "submap select+assemble", "s2m align", "keyframe maybe_spawn", "FULL step (odom_frame)")


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
    scan, _, thresh = pipeline.front(cfg, state.spaciousness, fr.points, fr.mask, backend)
    nrm = pipeline._scan_normals(scan, cfg, backend)
    src = gicp.GicpSource(scan.points, scan.mask, nrm.normals, nrm.valid)
    guess = pipeline._guess(cfg, state, fr.imu_prior)
    passes = pipeline.s2s_passes(cfg)
    targets = [pipeline.s2s_target(cfg, state, s, backend) for s, _ in passes]

    def s2s_aligns():  # the step's S2S aligns on the targets built above
        res, g = [], guess
        for (stride, stage), target in zip(passes, targets):
            res.append(gicp.align(gicp.GicpSource(*pipeline.strided(src, stride)), target, g,
                                  stage, backend, cfg.shapes.cell_cap_1nn))
            g = res[-1].transform
        return res

    def s2m(st):  # S2M and the rescue, as the step runs them
        target, res, rescue = pipeline.s2m_stage(cfg, st, src, t_global, s2s[-1], backend)
        return pipeline.rescue_stage(cfg, src, target, t_global, backend) if rescue else res

    s2s = s2s_aligns()
    t_global = state.t_s2s @ s2s[-1].transform
    state2, _ = pipeline.submap_stage(cfg, clone_state(state), t_global, thresh, fr.directions,
                                      None, backend)
    s2m_res = s2m(state2)
    pose = pipeline.guarded_pose(s2m_res, t_global)
    print(f"# s2s iters={[r.iterations for r in s2s]} s2m iters={s2m_res.iterations}",
          file=sys.stderr)

    st_sub, st_full = clone_state(state), clone_state(state)
    st_kf = state2._replace(keyframes=clone_state(state2.keyframes))
    stages = [
        lambda: pipeline.front(cfg, state.spaciousness, fr.points, fr.mask, backend),
        lambda: pipeline._scan_normals(scan, cfg, backend),
        lambda: [pipeline.s2s_target(cfg, state, s, backend) for s, _ in passes],
        s2s_aligns,
        lambda: pipeline.submap_stage(cfg, st_sub, t_global, thresh, fr.directions, None, backend),
        lambda: s2m(state2),
        lambda: pipeline.keyframe_stage(cfg, st_kf, scan, pose, thresh, s2m_res, backend),
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
