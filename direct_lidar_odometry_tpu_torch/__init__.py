"""Direct LiDAR Odometry in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch/CUDA port of ``direct_lidar_odometry_tpu`` (the JAX package,
which stays in the repository as the reference the port is tested
against). The subpackage layout mirrors the JAX package's, so every module
has an obvious counterpart:

- ``core``: SE(3) math and masked fixed-capacity point clouds;
- ``ops``: preprocessing, Morton sort, voxel filter, 3x3 eigen-analysis,
  the wrappers of the six CUDA kernels (``ops/cuda_nn.py``: 1-NN K2, K4,
  K5; ``ops/cuda_cov.py``: radius moments K1, K6; ``ops/cuda_gicp.py``:
  the fused GICP linearization K3; sources in ``csrc/``) and the tensor-op
  searches of the "brute" and "hashgrid" backends;
- ``registration``: normals and GICP;
- ``odometry``: state, keyframes, submap, the per-frame step, the runner
  and the keyframe map;
- ``io``: synthetic worlds, KITTI, trajectory and PLY files, ATE/RPE, host
  preprocessing (``io/hostprep.py``) and the ctypes binding of the native
  host library ``cpp/dlo_host.cpp`` (``io/native.py``, built at first use);
- ``parallel``: the keyframe pose graph, the multi-sequence batched step
  (``parallel/batched.py``) and its sharding over ``torch.distributed``
  (``parallel/sharded.py``);
- ``utils``: precision pin, host-read counter, lane helpers, checkpoint,
  dashboard;
- ``cli``: the process entry point (``python -m direct_lidar_odometry_tpu_torch``).

The port imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from direct_lidar_odometry_tpu_torch.config import DloConfig, load_config

__all__ = ["DloConfig", "load_config", "__version__"]
