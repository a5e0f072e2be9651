"""Typed configuration tree, the same schema as the JAX package's.

The dataclass tree is kept field for field identical to
``direct_lidar_odometry_tpu/config.py`` so that one YAML file (e.g.
``cfg/tpu_dlo.yaml``) loads the same tree in both packages. It is a copy,
not an import: importing any module of the JAX package first runs that
package's ``__init__``, which imports jax, and the port never imports jax.
Only :func:`resolve_backend` differs.

Mirrors the reference's parameter names and defaults so that runs are
comparable knob-for-knob:

- reference ``cfg/dlo.yaml:10-25``   (high-level toggles)
- reference ``cfg/params.yaml:10-71`` (pipeline numerics)
- reference ``src/dlo/odom.cc:182-260`` (``getParams`` defaults)
- reference ``impl/lsq_registration_impl.hpp:49-63`` (optimizer defaults)

On top of the algorithmic knobs, :class:`ShapeConfig` adds the static-shape
budget: every per-frame tensor has a fixed capacity with a validity mask,
so the keyframe ring and the submap cache are allocated once.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Mapping

import yaml


@dataclass(frozen=True)
class CropBoxConfig:
    """Inverse crop box removing the robot body near the sensor.

    Reference: ``odom.cc:122-124`` (setNegative(true), box = [-size, +size]^3),
    params at ``cfg/params.yaml:26-28``.
    """

    use: bool = True
    size: float = 1.0


@dataclass(frozen=True)
class VoxelFilterConfig:
    """PCL-style centroid voxel grid (``odom.cc:126-127``)."""

    use: bool = True
    res: float = 0.25


@dataclass(frozen=True)
class PreprocessingConfig:
    """Scan preprocessing (reference ``odom.cc:443-465``)."""

    crop: CropBoxConfig = field(default_factory=CropBoxConfig)
    voxel_scan: VoxelFilterConfig = field(default_factory=VoxelFilterConfig)
    voxel_submap: VoxelFilterConfig = field(
        default_factory=lambda: VoxelFilterConfig(use=True, res=0.5)
    )


@dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe spawn thresholds (``cfg/params.yaml:38-40``, ``odom.cc:203-204``)."""

    thresh_dist: float = 5.0  # meters; overridden adaptively when adaptive=True
    thresh_rot: float = 45.0  # degrees


@dataclass(frozen=True)
class SubmapConfig:
    """Submap keyframe selection counts (``cfg/params.yaml:42-46``)."""

    knn: int = 10  # k nearest keyframes by pose distance
    kcv: int = 10  # k nearest among convex-hull keyframes
    kcc: int = 10  # k nearest among concave-hull keyframes


@dataclass(frozen=True)
class ImuConfig:
    """IMU usage and calibration (``cfg/dlo.yaml:16``, ``cfg/params.yaml:48-50``)."""

    use: bool = False
    calib_time: float = 3.0  # seconds of static gyro/accel averaging
    buffer_size: int = 2000  # reference circular buffer depth (odom.h:166)


@dataclass(frozen=True)
class GicpStageConfig:
    """Per-stage GICP parameters — one instance for S2S, one for S2M.

    Reference: ``cfg/params.yaml:52-71``, applied at ``odom.cc:100-114``.
    ``rotation_epsilon`` is the LsqRegistration default (2e-3,
    ``lsq_registration_impl.hpp:53``) which the reference never overrides.
    """

    k_correspondences: int = 10
    max_correspondence_distance: float = 1.0
    max_iterations: int = 32
    transformation_epsilon: float = 0.01
    rotation_epsilon: float = 2e-3
    # Levenberg-Marquardt knobs (lsq_registration_impl.hpp:57-60)
    optimizer: str = "lm"  # "lm" (reference default) or "gn"
    lm_max_iterations: int = 10
    lm_init_lambda_factor: float = 1e-9


@dataclass(frozen=True)
class GicpConfig:
    min_num_points: int = 10  # scan rejection threshold (odom.cc:638-641)
    s2s: GicpStageConfig = field(
        default_factory=lambda: GicpStageConfig(
            k_correspondences=10, max_correspondence_distance=1.0
        )
    )
    s2m: GicpStageConfig = field(
        default_factory=lambda: GicpStageConfig(
            k_correspondences=20, max_correspondence_distance=0.5
        )
    )
    # S2S coarse stride: when > 1, a coarse scan-to-scan align over every
    # k-th point of the Morton-sorted scan (a spatially uniform subsample)
    # runs first and SEEDS the full-resolution S2S align, which keeps the
    # reference's own convergence criteria (odom.cc:803-812), so the S2S
    # fixed point is that of stride 1. 1 disables the coarse stage;
    # n_scan // stride must stay a multiple of 512.
    s2s_coarse_stride: int = 4
    # When False (and the coarse stage is active), the S2S result is the
    # coarse align alone and seeds S2M directly; the staged-gate rescue
    # below is then the safety net for a seed outside the S2M basin.
    s2s_full_polish: bool = True
    # Iteration cap for the coarse stage alone: it only produces a seed, and
    # S2M's own convergence (and the rescue) absorb what it leaves.
    s2s_coarse_max_iterations: int = 8
    # Staged-gate S2M rescue (framework robustness addition — the
    # reference prints "lm not converged!!" and carries on,
    # lsq_registration_impl.hpp:105-108). Plane-to-plane GICP can stall in
    # a local minimum when its initial guess lands outside the S2M 0.5 m
    # correspondence basin. When the per-correspondence Mahalanobis error
    # of either stage exceeds its threshold, S2M re-runs with the wide
    # ``rescue_corr_distance`` gate and then re-refines at the reference's
    # own 0.5 m gate, so the final operating point is unchanged. False
    # positives only cost time, never accuracy.
    s2m_rescue: bool = True
    rescue_corr_distance: float = 1.5
    rescue_s2s_error: float = 1.0   # per-correspondence S2S error trigger
    rescue_s2m_error: float = 0.35  # per-correspondence S2M error trigger
    # S2M is also unhealthy when it matched too small a fraction of the
    # valid source points (a seed outside the 0.5 m basin can only match
    # the accidental overlap)
    rescue_min_corr_frac: float = 0.25
    # The S2S alarm alone only triggers the rescue when S2M shows
    # corroborating stress: per-correspondence error above this fraction of
    # the S2M threshold (the strided coarse stage can stall at elevated
    # error on healthy frames that S2M then converges on).
    rescue_s2m_corroborate: float = 0.5  # fraction of rescue_s2m_error


@dataclass(frozen=True)
class AdaptiveConfig:
    """Spaciousness-adaptive keyframe threshold (``odom.cc:990-1010, 1188-1204``).

    Spaciousness = low-pass filtered median point range:
    ``s_t = 0.95 * s_{t-1} + 0.05 * median(range)``; mapped onto the
    keyframe distance threshold by the reference's step function.
    """

    use: bool = True
    lpf_alpha: float = 0.95
    # (spaciousness lower bound, threshD) steps, reference odom.cc:1188-1199
    # s > 20 -> 10.0 ; 10 < s <= 20 -> 5.0 ; 5 < s <= 10 -> 1.0 ; s <= 5 -> 0.5


@dataclass(frozen=True)
class InitialPoseConfig:
    """Optional known start pose (``odom.cc:600-617``, ``cfg/params.yaml:14-24``)."""

    use: bool = False
    position: tuple[float, float, float] = (0.0, 0.0, 0.0)
    orientation_wxyz: tuple[float, float, float, float] = (1.0, 0.0, 0.0, 0.0)


@dataclass(frozen=True)
class PoseGraphConfig:
    """Loop-closure + pose-graph refinement (capability add — the reference
    has no loop closure or global refinement, SURVEY.md §5).

    When ``use`` is on, the runner periodically searches the keyframe ring
    for revisits (pose distance < ``loop_radius`` with insertion-index gap
    >= ``min_index_gap``), re-registers the revisited keyframe clouds with
    GICP to get measured loop constraints, and refines all keyframe poses
    by dense SE(3) Gauss-Newton (parallel/posegraph.py), re-anchoring the
    map and the current pose.
    """

    use: bool = False
    refine_every_kf: int = 12    # trigger after this many new keyframes
    check_every: int = 16        # frames between (host-synced) trigger checks
    loop_radius: float = 7.0     # candidate keyframe pose distance [m]
    min_index_gap: int = 12      # minimum insertion-RANK separation — counts
    #   SURVIVING keyframes, so heavy eviction shrinks effective gaps
    min_seq_gap: int = 0         # minimum spawn-FRAME separation (eviction-
    #   invariant travel-time proxy; 0 = disabled). Prefer this for long
    #   evicting runs (round-4 advisor finding on rank-unit gaps)
    max_loops: int = 4           # loop edges registered per refinement
    iterations: int = 8          # Gauss-Newton iterations
    chain_weight: float = 1.0
    loop_weight: float = 2.0
    min_loop_corr: int = 200     # reject loop edges with fewer GICP matches
    # loop registration must swallow the accumulated drift, so its
    # correspondence gate is much wider than the tightly-guessed S2M stage
    loop_corr_distance: float = 2.0
    loop_max_iterations: int = 48


@dataclass(frozen=True)
class MapConfig:
    """Map aggregation node equivalent (``cfg/dlo.yaml:23-25``, ``map.cc:100-131``)."""

    publish_freq: float = 1.0
    leaf_size: float = 0.25
    # keep per-point intensity through to map export (PointXYZI parity,
    # reference dlo/dlo.h:50). Host-side sidecar only — the device hot path
    # never sees intensity (it is algorithmically unused in the reference
    # too); the runner mirrors keyframe scans and the exporter re-derives
    # an intensity-carrying map with the same voxel semantics.
    carry_intensity: bool = False


@dataclass(frozen=True)
class ShapeConfig:
    """Static-shape budget (fixed tensor capacities plus validity masks).

    Every array in the jitted per-frame step has a fixed shape drawn from
    here; actual sizes are tracked with validity masks. These defaults suit
    KITTI-class 64-beam data; tests shrink them.
    """

    n_raw: int = 131072        # max points in a raw input scan
    n_scan: int = 32768        # max points in a preprocessed scan
    n_keyframe: int = 16384    # max points in a stored (submap-voxeled) keyframe
    max_keyframes: int = 512   # keyframe ring capacity
    max_submap_kf: int = 32    # max keyframes concatenated into the submap
                               # (reference cap is knn+kcv+kcc = 30 pre-dedup)
    n_submap_flat: int | None = 65536   # assembled-submap point budget: on
                               # change, the S*Nk concatenation is pruned to
                               # the n_submap_flat points nearest the current
                               # pose (None = keep all S*Nk). Bounds the
                               # per-iteration S2M search cost.
    imu_window: int = 256      # max IMU samples between consecutive scans
    # hash-grid neighbor search shape knobs
    grid_table_size: int = 2 ** 16   # hash table slots for scan-sized grids
    submap_table_size: int = 2 ** 18 # hash table slots for the submap grid
    cell_cap_1nn: int = 16     # candidates gathered per cell for 1-NN queries
    cell_cap_knn: int = 48     # candidates gathered per cell for k-NN (cov) queries
    knn_query_chunk: int = 4096  # query chunking for the kNN candidate tensor
    # hull surrogate directions (device-side convex-extremal membership)
    hull_directions: int = 64


@dataclass(frozen=True)
class DloConfig:
    """Root configuration, mirroring reference ``cfg/dlo.yaml`` + ``cfg/params.yaml``."""

    version: str = "0.1.0"
    # Neighbor-search backend (see resolve_backend): the AABB-pruned kernel
    # paths "pallas" (alias "pallas_unfused"; "auto" means it), "pallas_mxu"
    # and "pallas_fused", or the tensor-op searches "brute" (exhaustive) and
    # "hashgrid" (sorted cell-hash index).
    nn_backend: str = "auto"
    # S2S initial guess: "imu" = the reference behavior (IMU rotational
    # prior when enabled, identity otherwise; odom.cc:801-806);
    # "constant_velocity" = seed with the previous frame's relative motion
    # (framework addition — typically halves GICP iterations; when the IMU
    # is enabled its rotation overrides the CV rotation).
    s2s_prior: str = "imu"
    # Host->device scan transfer encoding: uint16 + per-frame affine
    # (core/cloud.py QuantizedScan, <1 mm quantization at 60 m extent,
    # 2.2x less PCIe/ICI traffic). Framework addition — the reference is
    # single-process and never serializes the raw scan.
    quantize_transfer: bool = True
    # Run NaN/crop/voxel/Morton preprocessing on the HOST (C++ or numpy,
    # io/hostprep.py; in the runner's scan encode, which prepare_chunk can
    # run in a caller's thread) instead of on the device: the device step
    # then starts from <= n_scan Z-ordered voxel centroids — no 131k-point
    # device sort, less wire traffic. Framework addition; semantics match
    # the device path. Off when preprocessing.voxel_scan is off.
    host_preprocess: bool = False
    adaptive: AdaptiveConfig = field(default_factory=AdaptiveConfig)
    gravity_align: bool = False  # cfg/dlo.yaml:17 (needs IMU)
    initial_pose: InitialPoseConfig = field(default_factory=InitialPoseConfig)
    preprocessing: PreprocessingConfig = field(default_factory=PreprocessingConfig)
    keyframe: KeyframeConfig = field(default_factory=KeyframeConfig)
    submap: SubmapConfig = field(default_factory=SubmapConfig)
    imu: ImuConfig = field(default_factory=ImuConfig)
    gicp: GicpConfig = field(default_factory=GicpConfig)
    posegraph: PoseGraphConfig = field(default_factory=PoseGraphConfig)
    map: MapConfig = field(default_factory=MapConfig)
    shapes: ShapeConfig = field(default_factory=ShapeConfig)

    def replace(self, **kw: Any) -> "DloConfig":
        return dataclasses.replace(self, **kw)


# Every backend of the JAX package. The AABB-pruned kernel paths ("pallas"
# and its variants) launch the CUDA kernels on a CUDA tensor and run the
# kernels' plain PyTorch versions on a CPU tensor; "brute" and "hashgrid"
# are tensor ops (the JAX package's are XLA-lowered jnp code) and run on
# the device of their inputs.
PORTED_BACKENDS = ("auto", "pallas", "pallas_unfused", "pallas_mxu", "pallas_fused",
                   "brute", "hashgrid")


def resolve_backend(cfg: "DloConfig") -> str:
    """The backend name itself, as in the JAX package, with "auto" ->
    "pallas", the port's production path on every device (the JAX package
    resolves "auto" to "hashgrid" off the TPU). An unknown name raises."""
    if cfg.nn_backend not in PORTED_BACKENDS:
        raise ValueError(
            f"unknown nn_backend={cfg.nn_backend!r} (one of: {', '.join(PORTED_BACKENDS)})"
        )
    return "pallas" if cfg.nn_backend == "auto" else cfg.nn_backend


def submap_flat_size(cfg: "DloConfig") -> int:
    full = cfg.shapes.max_submap_kf * cfg.shapes.n_keyframe
    return min(cfg.shapes.n_submap_flat or full, full)


def _build(cls, data: Mapping[str, Any]):
    """Recursively build a dataclass from a nested mapping (unknown keys rejected)."""
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(cls)}
    for key, value in data.items():
        if key not in fields:
            raise KeyError(f"unknown config key {key!r} for {cls.__name__}")
        ftype = fields[key].type
        # resolve the dataclass type of nested fields from the default factory
        default = fields[key].default_factory() if fields[key].default_factory is not dataclasses.MISSING else None  # type: ignore[misc]
        if dataclasses.is_dataclass(default) and isinstance(value, Mapping):
            kwargs[key] = _build(type(default), value)
        elif isinstance(value, list):
            kwargs[key] = tuple(value)
        else:
            kwargs[key] = value
    return cls(**kwargs)


def config_from_dict(data: Mapping[str, Any]) -> DloConfig:
    """Build a :class:`DloConfig` from a nested mapping, e.g.
    ``dataclasses.asdict`` of the JAX package's config (unknown keys rejected)."""
    return _build(DloConfig, data)


def load_config(path: str | None = None, overrides: Mapping[str, Any] | None = None) -> DloConfig:
    """Load a :class:`DloConfig` from a YAML file plus dotted-key overrides.

    The YAML schema is this module's dataclass tree (see ``cfg/tpu_dlo.yaml``),
    the functional equivalent of the reference's two-file ROS-param scheme
    (``launch/dlo.launch:22-23,41``).
    """
    data: dict[str, Any] = {}
    if path is not None:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
    cfg = _build(DloConfig, data)
    if overrides:
        for dotted, value in overrides.items():
            cfg = _override(cfg, dotted.split("."), value)
    return cfg


def _override(node, keys, value):
    if len(keys) == 1:
        if isinstance(value, list):
            value = tuple(value)
        return dataclasses.replace(node, **{keys[0]: value})
    child = getattr(node, keys[0])
    return dataclasses.replace(node, **{keys[0]: _override(child, keys[1:], value)})
