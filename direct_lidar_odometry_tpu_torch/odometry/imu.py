"""IMU handling: host buffering and calibration, gyro integration, gravity
alignment.

Counterpart of the JAX package's ``odometry/imu.py``:

- ``imuCB`` (reference ``odom.cc:704-785``): static calibration averaging
  gyro and accel, then bias-corrected gyro samples into a circular buffer
  (:class:`ImuBuffer`, a numpy copy of the JAX package's class);
- ``integrateIMU`` (``odom.cc:859-919``): gyro-only quaternion integration
  of the samples between two scan stamps into a rotational S2S prior.
  :func:`integrate_window_host` (numpy copy) is what the runner uses;
  :func:`integrate_window` is the tensor version;
- ``gravityAlign`` (``odom.cc:535-579``): rotate the measured gravity onto
  +z for the initial orientation (:func:`gravity_align_quat`).

The numpy parts are copied, not imported, because importing any module of
the JAX package runs that package's ``__init__``; ``tests/test_torch_imu.py``
holds each copy against its original.
"""

from __future__ import annotations

import numpy as np
import torch

from direct_lidar_odometry_tpu_torch.core import se3


class ImuBuffer:
    """Host-side circular buffer with static-bias calibration.

    Rows: (stamp, wx, wy, wz, ax, ay, az). Gyro is stored bias-corrected
    once calibrated (accel is stored raw, as the reference does).
    """

    def __init__(self, calib_time: float = 3.0, buffer_size: int = 2000):
        self.calib_time = calib_time
        self.buffer = np.zeros((buffer_size, 7), np.float64)
        self.size = 0
        self.head = 0
        self.first_stamp: float | None = None
        self.calibrated = calib_time <= 0.0
        self._calib_sum = np.zeros(6)
        self._calib_n = 0
        self.gyro_bias = np.zeros(3)
        self.accel_mean = np.zeros(3)

    def push(self, stamp: float, gyro, accel) -> None:
        gyro = np.asarray(gyro, np.float64)
        accel = np.asarray(accel, np.float64)
        if self.first_stamp is None:
            self.first_stamp = stamp
        if not self.calibrated:
            if stamp - self.first_stamp < self.calib_time:
                self._calib_sum += np.concatenate([gyro, accel])
                self._calib_n += 1
                return
            if self._calib_n > 0:
                avg = self._calib_sum / self._calib_n
                self.gyro_bias = avg[:3]
                self.accel_mean = avg[3:]
            self.calibrated = True
        row = np.concatenate([[stamp], gyro - self.gyro_bias, accel])
        self.buffer[self.head] = row
        self.head = (self.head + 1) % len(self.buffer)
        self.size = min(self.size + 1, len(self.buffer))

    def window(self, t0: float, t1: float, width: int) -> tuple[np.ndarray, int]:
        """Measurements with t0 <= stamp <= t1, sorted, padded to ``width``
        (the collection at reference ``odom.cc:864-881``)."""
        data = self.buffer[: self.size]
        sel = data[(data[:, 0] >= t0) & (data[:, 0] <= t1)]
        sel = sel[np.argsort(sel[:, 0])][:width]
        out = np.zeros((width, 7), np.float32)
        out[: len(sel)] = sel
        return out, len(sel)


def integrate_window(window: torch.Tensor, count: torch.Tensor | int) -> torch.Tensor:
    """Gyro-only quaternion integration -> rotation-only 4x4 prior (tensors).

    Reference ``odom.cc:885-918``: the first in-window sample only seeds the
    previous stamp; each later sample integrates
    ``q <- q + 0.5 * q (x) (0, w) * dt`` with its own angular velocity; the
    result is normalized. window: [W, 7] rows (stamp, wx, wy, wz, ax, ay,
    az); count: valid rows. A host loop over the W rows, with no host read.
    """
    q = se3.quat_identity(device=window.device)
    prev = window[0, 0]
    count = torch.as_tensor(count, device=window.device)
    for idx in range(window.shape[0]):
        stamp = window[idx, 0]
        ox, oy, oz = window[idx, 1], window[idx, 2], window[idx, 3]
        in_window = idx < count
        dt = torch.where(in_window & (idx > 0), stamp - prev, 0.0)
        qw, qx, qy, qz = q.unbind()
        dq = torch.stack([
            -0.5 * (qx * ox + qy * oy + qz * oz),
            0.5 * (qw * ox - qz * oy + qy * oz),
            0.5 * (qz * ox + qw * oy - qx * oz),
            0.5 * (qx * oy - qy * ox + qw * oz),
        ])
        q = q + dq * dt
        prev = torch.where(in_window, stamp, prev)
    q = se3.quat_normalize(q)
    return se3.make_se3(se3.quat_to_rotmat(q), torch.zeros(3, dtype=torch.float32,
                                                           device=window.device))


def integrate_window_host(window: np.ndarray, count: int) -> np.ndarray:
    """NumPy version of :func:`integrate_window`, the runner's prior path:
    sensor-rate bookkeeping stays on the host, and the [4, 4] result goes to
    the device with the frame. Same Euler quaternion kinematics (reference
    ``odom.cc:885-918``)."""
    q = np.array([1.0, 0.0, 0.0, 0.0])
    if count <= 0:
        out = np.eye(4, dtype=np.float32)
        return out
    prev = window[0, 0]
    for i in range(1, int(count)):
        stamp = window[i, 0]
        ox, oy, oz = window[i, 1:4]
        dt = stamp - prev
        qw, qx, qy, qz = q
        dq = np.array([
            -0.5 * (qx * ox + qy * oy + qz * oz),
            0.5 * (qw * ox - qz * oy + qy * oz),
            0.5 * (qz * ox + qw * oy - qx * oz),
            0.5 * (qx * oy - qy * ox + qw * oz),
        ])
        q = q + dq * dt
        prev = stamp
    q = q / max(np.linalg.norm(q), 1e-12)
    w, x, y, z = q
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = R
    return out


def gravity_align_quat(accel_mean: torch.Tensor) -> torch.Tensor:
    """Quaternion rotating the measured gravity direction onto +z
    (reference ``odom.cc:556-560``, FromTwoVectors onto (0, 0, 1))."""
    grav = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32, device=accel_mean.device)
    return se3.quat_from_two_vectors(accel_mean.to(torch.float32), grav)
