"""Long-drive entry points of the PyTorch port: the accuracy ladder.

One module per tool of the JAX package's ``tools/`` that drives the system
at length, under the tool's own name: ``long_validation``,
``staleness_sweep``, ``hull_ab`` and ``trace_frames``. Each imports torch,
numpy and ``direct_lidar_odometry_tpu_torch`` only, exposes a function that
returns the rows its JAX counterpart prints (under the same keys), and runs
on the card unless the caller passes ``device="cpu"``.
"""
