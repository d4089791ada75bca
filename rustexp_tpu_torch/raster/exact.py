"""Host float32 helpers of the camera chains, shared by the transform
(raster/pipeline.py) and the shade's ray unprojection (raster/shade.py).

Every product and sum rounds on its own and the products chain left to
right, as the reference's scalar code does, so the CPU and the card build
the same matrices.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import trace


def _host_eye(eye) -> torch.Tensor:
    if isinstance(eye, torch.Tensor):
        return eye.detach().to("cpu", torch.float32)
    return torch.as_tensor(np.asarray(eye, np.float32))


def _device_eye(eye, device) -> torch.Tensor:
    """The eye as f32 [3] on `device` (the span sync.upload.eye)."""
    return trace.upload("eye", _host_eye(eye), device)


def _cross3_exact(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _mm4_exact(a, b):
    """Fixed-order 4x4 @ 4x4: s = a[i,0]*b[0,j]; s += a[i,1]*b[1,j]; ..."""
    s = a[:, 0:1] * b[0:1, :]
    s = s + a[:, 1:2] * b[1:2, :]
    s = s + a[:, 2:3] * b[2:3, :]
    return s + a[:, 3:4] * b[3:4, :]
