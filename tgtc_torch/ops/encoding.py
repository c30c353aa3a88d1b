"""NeRF positional (Fourier-feature) encoding — port of tgtc/ops/encoding.py.

Feature order matches the reference Embedder:
``[x, sin(2^0 x)(D), cos(2^0 x)(D), sin(2^1 x)(D), ...]``.
"""

from __future__ import annotations

import torch


def encoding_dim(input_dim: int, num_freqs: int, include_input: bool = True) -> int:
    """Feature size produced by :func:`positional_encoding`."""
    out = input_dim * num_freqs * 2
    if include_input:
        out += input_dim
    return out


def positional_encoding(
    x: torch.Tensor,
    num_freqs: int,
    include_input: bool = True,
    log_sampling: bool = True,
) -> torch.Tensor:
    """Encode ``x[..., D]`` into ``[..., encoding_dim(D, num_freqs)]``."""
    if num_freqs == 0:
        return x if include_input else x[..., :0]
    if log_sampling:
        freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    else:
        freqs = torch.linspace(1.0, 2.0 ** (num_freqs - 1), num_freqs,
                               dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]                    # [..., F, D]
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # [..., F, 2, D]
    enc = enc.reshape(*x.shape[:-1], num_freqs * 2 * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
