"""Direct LiDAR Odometry in PyTorch, with hand-written CUDA kernels for Hopper.

The PyTorch/CUDA port of ``direct_lidar_odometry_tpu`` (the JAX package,
which stays in the repository as the reference the port is tested
against). The subpackage layout mirrors the JAX package's, so every module
has an obvious counterpart:

- ``core``: SE(3) math and masked fixed-capacity point clouds;
- ``ops``: preprocessing, Morton sort, voxel filter, 3x3 eigen-analysis and
  the two kernels of the per-frame path (``ops/cuda_nn.py``,
  ``ops/cuda_cov.py``, sources in ``csrc/``);
- ``registration``: normals and GICP;
- ``odometry``: state, keyframes, submap, the per-frame step and the runner.

The port imports ``torch`` and never ``jax``.
"""

__version__ = "0.1.0"

from direct_lidar_odometry_tpu_torch.config import DloConfig, load_config

__all__ = ["DloConfig", "load_config", "__version__"]
