"""The 3D style field: two style MLPs and the variational latent table —
port of tgtc/models/style_field.py.

* :class:`StyleMLPBeforeConcat` — input ``[pts_embed | latent]``, the
  latent re-injected at every layer, ``pts_embed`` again at layer index
  ``skip``; the reference's construction loop breaks at the skip, so it has
  ``min(style_d - 1, skip + 1)`` layers (5 for ``style_d`` 8).
* :class:`StyleMLPWildMultilayers` — input ``[base_remap | concat_features |
  pts_embed]`` plus the latent at every layer (``pts_embed`` again at
  ``skip``): ``style_d - 1`` hidden layers, then ``rgb_out`` on ``[h |
  latent]`` and a sigmoid.
* The latent table is a plain dict ``{"latents" [S, F, D], "mu" [S, D],
  "logvar" [S, D]}`` of tensors, as in the JAX package.

Both MLPs use the reference's torch layer names, ``layers.{i}``; in the
style MLP the last ``layers.{n}`` is ``rgb_out``. A reference
``style_*.tar`` state dict therefore loads without renaming. Random draws
come from an explicit ``torch.Generator`` or are passed in as tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from tgtc_torch.device import DeviceLike, resolve_device

TRUNK_W = 256  # the NeRF trunk's base_remap width


@dataclasses.dataclass(frozen=True)
class StyleFieldConfig:
    style_d: int = 8        # reference --style_D
    width: int = 256        # reference --netwidth
    latent_dim: int = 32    # reference --vae_latent
    embed_dim: int = 63     # embed_freq_coor * 6 + 3
    skip: int = 4

    @property
    def n_concat(self) -> int:
        """Layers of the concat MLP (the reference's loop breaks at the skip)."""
        return min(self.style_d - 1, self.skip + 1)


class StyleMLPBeforeConcat(nn.Module):
    """``(pts_embed [N, E], latent [N, D]) -> concat_features [N, width]``."""

    def __init__(self, cfg: StyleFieldConfig):
        super().__init__()
        self.cfg = cfg
        layers = []
        for i in range(cfg.n_concat):
            n_in = (cfg.embed_dim if i == 0 else cfg.width) + cfg.latent_dim
            n_in += cfg.embed_dim if i == cfg.skip else 0
            layers.append(nn.Linear(n_in, cfg.width))
        self.layers = nn.ModuleList(layers)

    def forward(self, x_embed: torch.Tensor, latent: torch.Tensor) -> torch.Tensor:
        h = x_embed
        for i, layer in enumerate(self.layers):
            h = torch.cat([h, latent], dim=-1)
            if i == self.cfg.skip:
                h = torch.cat([h, x_embed], dim=-1)
            h = torch.relu(layer(h))
        return h


class StyleMLPWildMultilayers(nn.Module):
    """``(pts_embed [N, E], concated [N, 256 + width], latent [N, D]) -> rgb
    [N, 3]``. ``layers.{style_d - 1}`` is the reference's ``rgb_out``."""

    def __init__(self, cfg: StyleFieldConfig):
        super().__init__()
        self.cfg = cfg
        layers = []
        for i in range(cfg.style_d - 1):
            n_in = TRUNK_W + cfg.width + cfg.embed_dim if i == 0 else cfg.width
            n_in += cfg.latent_dim + (cfg.embed_dim if i == cfg.skip else 0)
            layers.append(nn.Linear(n_in, cfg.width))
        layers.append(nn.Linear(cfg.width + cfg.latent_dim, 3))
        self.layers = nn.ModuleList(layers)

    def forward(self, x_embed: torch.Tensor, concated: torch.Tensor,
                latent: torch.Tensor) -> torch.Tensor:
        h = torch.cat([concated, x_embed], dim=-1)
        for i, layer in enumerate(self.layers[:-1]):
            h = torch.cat([h, latent], dim=-1)
            if i == self.cfg.skip:
                h = torch.cat([h, x_embed], dim=-1)
            h = torch.relu(layer(h))
        return torch.sigmoid(self.layers[-1](torch.cat([h, latent], dim=-1)))


def make_style_mlps(cfg: StyleFieldConfig, generator: Optional[torch.Generator] = None,
                    device: DeviceLike = None
                    ) -> Tuple[StyleMLPBeforeConcat, StyleMLPWildMultilayers]:
    """Both style MLPs with LeCun-normal weights and zero biases (the flax
    ``Dense`` default), drawn from ``generator``, on ``device``."""
    dev = resolve_device(device)
    models = (StyleMLPBeforeConcat(cfg), StyleMLPWildMultilayers(cfg))
    with torch.no_grad():
        for model in models:
            for layer in model.layers:
                fan_in = layer.weight.shape[1]
                layer.weight.copy_(torch.randn(layer.weight.shape, generator=generator)
                                   * fan_in ** -0.5)
                layer.bias.zero_()
    return models[0].to(dev), models[1].to(dev)


# ---------------------------------------------------------------- latents


def init_latents(generator: Optional[torch.Generator], style_num: int, frame_num: int,
                 latent_dim: int, device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """A standard-normal latent table with standard-normal ``mu`` and
    ``logvar`` per style."""
    dev = resolve_device(device)
    draw = lambda *shape: torch.randn(shape, generator=generator).to(dev)
    return {"latents": draw(style_num, frame_num, latent_dim),
            "mu": draw(style_num, latent_dim),
            "logvar": draw(style_num, latent_dim)}


def set_latents_from_vae(latent_state: Dict[str, torch.Tensor], mu: torch.Tensor,
                         logvar: torch.Tensor, eps: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None
                         ) -> Dict[str, torch.Tensor]:
    """Reseed the table by reparameterised sampling from per-style VAE stats:
    ``eps * exp(logvar / 2) + mu`` for every frame. ``eps [S, F, D]`` is the
    standard-normal draw; drawn from ``generator`` when not given."""
    s, f, d = latent_state["latents"].shape
    if eps is None:
        eps = torch.randn((s, f, d), generator=generator).to(mu.device)
    return {"latents": eps * torch.exp(0.5 * logvar[:, None, :]) + mu[:, None, :],
            "mu": mu, "logvar": logvar}


def _gather_clamped(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` with JAX's gather rule: negative ids count from the
    end once, then every id is clamped into range (torch would raise)."""
    n = table.shape[0]
    ids = torch.where(ids < 0, ids + n, ids).clamp(0, n - 1)
    return table[ids]


def lookup_latents(latent_state: Dict[str, torch.Tensor], style_ids: torch.Tensor,
                   frame_ids: torch.Tensor, sigma_scale: float = 1.0,
                   llff_tile: bool = True) -> torch.Tensor:
    """Per-ray latents ``[R, D]``, shrunk toward the style mean by
    ``sigma_scale``. ``llff_tile`` keeps the reference's x7 tiling of the
    table before the flat lookup. Ids past the table's end take its last
    row, as JAX's gather does (a 120-pose spiral can outrun a small
    scene's table even after the tiling)."""
    s, f, d = latent_state["latents"].shape
    table = latent_state["latents"].reshape(-1, d)
    if llff_tile:
        table = table.repeat(7, 1)
    latents = _gather_clamped(table, style_ids.long() * f + frame_ids.long())
    mu = _gather_clamped(latent_state["mu"], style_ids.long())
    return mu + sigma_scale * (latents - mu)


def latent_minus_logp(latent_state: Dict[str, torch.Tensor], style_ids: torch.Tensor,
                      frame_ids: torch.Tensor, sigma_scale: float = 1.0,
                      llff_tile: bool = True, epsilon: float = 1e-3) -> torch.Tensor:
    """Gaussian prior loss on the looked-up latents; divides by std + eps,
    not the variance, as the reference does."""
    latents = lookup_latents(latent_state, style_ids, frame_ids, sigma_scale, llff_tile)
    mu = _gather_clamped(latent_state["mu"], style_ids.long()).detach()
    logvar = _gather_clamped(latent_state["logvar"], style_ids.long()).detach()
    return torch.mean(torch.sum((latents - mu) ** 2 / (torch.exp(0.5 * logvar) + epsilon),
                                dim=-1))
