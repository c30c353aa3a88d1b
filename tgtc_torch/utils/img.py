"""Float ↔ uint8 images with the JAX package's one rounding convention
(port of tgtc/utils/img.py): ``to_uint8`` clips to [0, 1], scales by 255
and rounds to nearest with +0.5 before the truncating cast; ``from_uint8``
is its exact inverse scale."""

from __future__ import annotations

import torch


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] float image → uint8, rounded to nearest, on ``x``'s device."""
    return (x.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)


def from_uint8(x: torch.Tensor) -> torch.Tensor:
    """uint8 image → [0, 1] float32 on ``x``'s device (identity on floats)."""
    return x.to(torch.float32) / 255.0 if x.dtype == torch.uint8 else x
