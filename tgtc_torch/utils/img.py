"""Float → uint8 images with the JAX package's one rounding convention
(port of ``to_uint8`` in tgtc/utils/img.py): clip to [0, 1], scale by 255
and round to nearest with +0.5 before the truncating cast."""

from __future__ import annotations

import torch


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] float image → uint8, rounded to nearest, on ``x``'s device."""
    return (x.clamp(0.0, 1.0) * 255.0 + 0.5).to(torch.uint8)
