"""Helpers of the reference VGG — port of the part of tgtc/models/vgg.py
that the decoder uses. ``VggEncoder`` and ``ceil_max_pool`` come with the
C1 trainer (ROADMAP.md queue 1, items 13 and 15): C3 never runs the VGG."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def reflect_pad(x: torch.Tensor, p: int = 1) -> torch.Tensor:
    """Reflection padding of the two spatial axes of an NCHW tensor (the
    JAX function pads NHWC; the port's convolutions run NCHW)."""
    return F.pad(x, (p, p, p, p), mode="reflect")
