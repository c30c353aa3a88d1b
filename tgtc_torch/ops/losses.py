"""Losses and metrics — port of tgtc/ops/losses.py."""

from __future__ import annotations

import math

import torch


def img2mse(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((x - y) ** 2)


def img2l1(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(x - y))


def mse2psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log(mse) / math.log(10.0)


def l2_norm(x: torch.Tensor) -> torch.Tensor:
    """``sqrt(sum(x²) + 1e-8)``: the eps inside the root keeps the gradient
    finite at 0."""
    return torch.sqrt(torch.sum(x ** 2) + 1e-8)


def cosine_similarity(a: torch.Tensor, b: torch.Tensor, dim: int = -1,
                      eps: float = 1e-8) -> torch.Tensor:
    """Per-element cosine similarity along ``dim``. The eps lives INSIDE
    the sqrt so the gradient stays finite at zero vectors."""
    dot = torch.sum(a * b, dim=dim)
    na = torch.sqrt(torch.sum(a * a, dim=dim) + eps * eps)
    nb = torch.sqrt(torch.sum(b * b, dim=dim) + eps * eps)
    return dot / (na * nb)
