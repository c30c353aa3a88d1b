"""MLP VAE over the 1024-d style-feature vectors — port of tgtc/models/vae.py.

Encoder and decoder are ``depth - 1`` ReLU Linear layers of ``width``; the
latent has ``latent_dim`` dimensions; the loss is the per-feature batch-mean
squared error summed over features plus ``kl_lambda`` times the KL term.
Phases D and E use it frozen to seed the latent table.

The layers carry the reference's torch names (``encoder.fc_layers.{i}``,
``encoder.fc_layer_mu``, ``encoder.fc_layer_log_var``,
``decoder.fc_layers.{i}``, ``decoder.output_layer``), so a reference
``vae.pth`` loads with ``load_state_dict``. The reparameterisation's ε is
passed in or drawn from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from tgtc_torch.device import DeviceLike, resolve_device


@dataclasses.dataclass(frozen=True)
class VaeConfig:
    data_dim: int = 1024
    latent_dim: int = 32
    width: int = 512
    depth: int = 4
    kl_lambda: float = 0.1


def _mlp(n_in: int, width: int, n: int) -> nn.ModuleList:
    return nn.ModuleList(nn.Linear(n_in if i == 0 else width, width) for i in range(n))


class VaeEncoder(nn.Module):
    def __init__(self, cfg: VaeConfig):
        super().__init__()
        self.fc_layers = _mlp(cfg.data_dim, cfg.width, cfg.depth - 1)
        n_in = cfg.width if cfg.depth > 1 else cfg.data_dim
        self.fc_layer_mu = nn.Linear(n_in, cfg.latent_dim)
        self.fc_layer_log_var = nn.Linear(n_in, cfg.latent_dim)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for layer in self.fc_layers:
            x = torch.relu(layer(x))
        return self.fc_layer_mu(x), self.fc_layer_log_var(x)


class VaeDecoder(nn.Module):
    def __init__(self, cfg: VaeConfig):
        super().__init__()
        self.fc_layers = _mlp(cfg.latent_dim, cfg.width, cfg.depth - 1)
        n_in = cfg.width if cfg.depth > 1 else cfg.latent_dim
        self.output_layer = nn.Linear(n_in, cfg.data_dim)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        for layer in self.fc_layers:
            z = torch.relu(layer(z))
        return self.output_layer(z)


def reparameterize(mu: torch.Tensor, logvar: torch.Tensor, eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None, factor: float = 1.0
                   ) -> torch.Tensor:
    """``mu + eps · exp(logvar / 2) · factor``; ``eps`` is standard normal,
    drawn from ``generator`` (on its device) when not given."""
    std = torch.exp(0.5 * logvar) * factor
    if eps is None:
        dev = generator.device if generator is not None else mu.device
        eps = torch.randn(mu.shape, generator=generator, device=dev).to(mu.device)
    return mu + eps * std


class Vae(nn.Module):
    def __init__(self, cfg: VaeConfig = VaeConfig()):
        super().__init__()
        self.cfg = cfg
        self.encoder = VaeEncoder(cfg)
        self.decoder = VaeDecoder(cfg)

    def forward(self, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        """``(y, z, mu, logvar)``; z is sampled when ``eps`` or ``generator``
        is given, else ``mu``."""
        mu, logvar = self.encoder(x)
        sample = eps is not None or generator is not None
        z = reparameterize(mu, logvar, eps, generator) if sample else mu
        return self.decoder(z), z, mu, logvar

    def encode(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.encoder(x)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)


def vae_loss(x: torch.Tensor, y: torch.Tensor, mu: torch.Tensor, logvar: torch.Tensor,
             kl_lambda: float = 0.1) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``(loss, {"recon", "kl"})``: recon is the batch-mean squared error
    summed over features, kl the batch-mean KL to N(0, I) times
    ``kl_lambda``."""
    kl = torch.mean(-0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar), dim=1))
    recon = torch.sum(torch.mean((x - y) ** 2, dim=0))
    return recon + kl_lambda * kl, {"recon": recon, "kl": kl_lambda * kl}


def make_vae(cfg: VaeConfig = VaeConfig(), generator: Optional[torch.Generator] = None,
             device: DeviceLike = None) -> Vae:
    """A Vae on ``device`` with LeCun-normal weights drawn from ``generator``
    and zero biases (the flax ``Dense`` default)."""
    dev = resolve_device(device)
    with torch.device("meta"):  # no draw from the global generator
        model = Vae(cfg)
    model.to_empty(device=dev)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * m.weight.shape[1] ** -0.5)
                m.bias.zero_()
    return model
