"""Float32 precision guard.

Geometry does not survive reduced-precision matrix products: point
transforms, Jacobian products and pose compositions in a 10-bit mantissa
(TF32) or 8-bit mantissa (bf16) drift odometry by metres. On an NVIDIA card
PyTorch may route float32 matrix products through TF32 tensor cores
(``torch.backends.cuda.matmul.allow_tf32``) and float32 convolutions through
TF32 in cuDNN (``torch.backends.cudnn.allow_tf32``, on by default). The
runner calls :func:`pin_float32` at construction so every product of the
port runs in full float32.
"""

from __future__ import annotations

import torch


def pin_float32() -> None:
    """Pin full-float32 matrix products and turn TF32 off everywhere."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

