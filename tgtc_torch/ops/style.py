"""AdaIN / style-statistics ops — port of tgtc/ops/style.py.

NHWC tensors, as in the JAX package: channel mean/std, adaptive instance
normalization, mean-std normalization (the reference's ``normal``), the
Gram-matrix style loss and CORAL colour transfer.
"""

from __future__ import annotations

from typing import Tuple

import torch


def calc_mean_std(feat: torch.Tensor, eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(batch, channel) spatial mean and std of NHWC features, each
    ``[B, 1, 1, C]``. The variance is torch's unbiased (n − 1) one, and eps
    sits inside the square root."""
    mean = feat.mean(dim=(1, 2), keepdim=True)
    var = feat.var(dim=(1, 2), keepdim=True, correction=1)
    return mean, torch.sqrt(var + eps)


def adaptive_instance_normalization(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
    """AdaIN: ``content`` renormalized to the statistics of ``style``."""
    c_mean, c_std = calc_mean_std(content)
    s_mean, s_std = calc_mean_std(style)
    return (content - c_mean) / c_std * s_std + s_mean


def mean_variance_norm(feat: torch.Tensor) -> torch.Tensor:
    """Mean-std normalization (the StyTrans content loss's ``normal``)."""
    mean, std = calc_mean_std(feat)
    return (feat - mean) / std


def gram_matrix(feat: torch.Tensor) -> torch.Tensor:
    """``[B, C, C]`` Gram matrix of NHWC features over ``C·H·W``."""
    b, h, w, c = feat.shape
    f = feat.reshape(b, h * w, c)
    return torch.einsum("bnc,bnd->bcd", f, f) / (c * h * w)


def gram_style_loss(input_feat: torch.Tensor, target_feat: torch.Tensor) -> torch.Tensor:
    return torch.mean((gram_matrix(input_feat) - gram_matrix(target_feat)) ** 2)


def coral(source: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """CORAL colour transfer of a ``[H, W, 3]`` image in [0, 1] to the
    colour statistics of ``target``."""
    def flat(x):  # [3, N]
        return x.reshape(-1, 3).T

    def norm_stats(f):
        mean = f.mean(dim=1, keepdim=True)
        std = f.std(dim=1, keepdim=True, correction=0) + 1e-8
        return (f - mean) / std, mean, std

    def cov(f):
        return f @ f.T + torch.eye(3, dtype=f.dtype, device=f.device)

    def matrix_power(m, e):
        vals, vecs = torch.linalg.eigh(m)
        return vecs @ torch.diag(vals ** e) @ vecs.T

    sf, _, _ = norm_stats(flat(source))
    tf, t_mean, t_std = norm_stats(flat(target))
    s_white = matrix_power(cov(sf), -0.5) @ sf
    s_colored = matrix_power(cov(tf), 0.5) @ s_white
    return (s_colored * t_std + t_mean).T.reshape(source.shape)
