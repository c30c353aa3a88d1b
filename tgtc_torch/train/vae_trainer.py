"""Phase D — the VAE over style features; port of tgtc/train/vae_trainer.py.

VGG relu4_1 features of style crops become 1024-d ``[channel mean ‖
channel std]`` vectors (:func:`vgg_style_feature`), on which the VAE trains
with its reconstruction + KL loss (the reference's ``train_vae``). Adam
(0.9, 0.999, eps 1e-8) at ``lr / (1 + lr_decay·n)``, ``n`` the update count
from 0 (optax's count), as the JAX trainer schedules it.

:func:`seed_latents_from_features` is Phase D's product: it encodes Phase
C3's per-style features and seeds the latent table that Phases E and F read
by reparameterised sampling.

Each step's ε is an explicit argument or is drawn from a generator seeded
from (seed, step) by :func:`~tgtc_torch.utils.seeds.step_seed`, so a resumed
run draws what an uninterrupted one would.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

from tgtc_torch.device import DeviceLike
from tgtc_torch.models.style_field import set_latents_from_vae
from tgtc_torch.models.vae import Vae, VaeConfig, make_vae, vae_loss
from tgtc_torch.utils.seeds import step_seed


@dataclasses.dataclass(frozen=True)
class VaeTrainConfig:
    lr: float = 1e-3
    lr_decay: float = 0.0  # the reference's lr / (1 + lr_decay · iter)
    max_iter: int = 160000
    batch_size: int = 8
    kl_lambda: float = 0.1


@dataclasses.dataclass
class VaeTrainState:
    """The step (a host int), the model and its optimizer with the schedule."""

    step: int
    model: Vae
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict()}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["model"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])


def vgg_style_feature(vgg, images: torch.Tensor) -> torch.Tensor:
    """``[B, 1024]``: relu4_1's channel mean ‖ ``sqrt(unbiased var + 1e-5)``
    of ``images [B, H, W, 3]`` in [0, 1] through ``vgg`` (a
    :class:`~tgtc_torch.models.vgg.VggEncoder`), in f32."""
    f4 = vgg(images)[3].float()
    mean = f4.mean(dim=(1, 2))
    std = torch.sqrt(f4.var(dim=(1, 2), correction=1) + 1e-5)
    return torch.cat([mean, std], dim=-1)


def init_vae_train(generator: Optional[torch.Generator], cfg: VaeConfig, tcfg: VaeTrainConfig,
                   device: DeviceLike = None) -> Tuple[Vae, VaeTrainState]:
    """A Vae drawn from ``generator`` on ``device`` and its Adam state (the
    optimizer's base lr is 1, so that the schedule gives the lr itself)."""
    model = make_vae(cfg, generator, device)
    opt = torch.optim.Adam(model.parameters(), lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda n: tcfg.lr / (1.0 + tcfg.lr_decay * n))
    return model, VaeTrainState(0, model, opt, sched)


class VaeTrainStep:
    """``step(state, x, eps=None, seed=0) -> (state, metrics)``: one update
    on the feature batch ``x [B, data_dim]`` in place. ``eps [B,
    latent_dim]`` defaults to a draw from a generator on the model's device
    seeded from ``(seed, state.step)``. Metrics are 0-d device tensors."""

    def __init__(self, model: Vae, tcfg: VaeTrainConfig):
        self.model, self.tcfg = model, tcfg
        self._generator: Optional[torch.Generator] = None

    def eps(self, seed: int, step: int, batch: int) -> torch.Tensor:
        dev = next(self.model.parameters()).device
        if self._generator is None or self._generator.device != dev:
            self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(step_seed(seed, step))
        return torch.randn((batch, self.model.cfg.latent_dim), generator=self._generator,
                           device=dev)

    def loss_and_grad(self, model: Vae, x: torch.Tensor, eps: torch.Tensor
                      ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """The metrics and the gradients of ``model``'s parameters (in
        ``parameters()`` order), before any update."""
        y, _, mu, logvar = model(x, eps=eps)
        loss, parts = vae_loss(x, y, mu, logvar, self.tcfg.kl_lambda)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        return {"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}}, list(grads)

    def __call__(self, state: VaeTrainState, x: torch.Tensor, eps: Optional[torch.Tensor] = None,
                 seed: int = 0) -> Tuple[VaeTrainState, Dict[str, torch.Tensor]]:
        if eps is None:
            eps = self.eps(seed, state.step, x.shape[0])
        metrics, grads = self.loss_and_grad(state.model, x, eps)
        for p, g in zip(state.model.parameters(), grads):
            p.grad = g
        state.optimizer.step()
        state.scheduler.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.step += 1
        return state, metrics


def make_vae_train_step(model: Vae, tcfg: VaeTrainConfig) -> VaeTrainStep:
    return VaeTrainStep(model, tcfg)


@torch.no_grad()
def seed_latents_from_features(vae: Vae, style_features: torch.Tensor, frame_num: int,
                               eps: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> Dict[str, torch.Tensor]:
    """Phase D: encode ``style_features [S, data_dim]`` to per-style ``(mu,
    logvar)`` and seed a ``[S, frame_num, latent_dim]`` latent table with
    ``eps · exp(logvar / 2) + mu``; ``eps`` is drawn from ``generator`` when
    not given."""
    mu, logvar = vae.encode(style_features)
    init = {"latents": torch.zeros((mu.shape[0], frame_num, mu.shape[1]), device=mu.device),
            "mu": mu, "logvar": logvar}
    return set_latents_from_vae(init, mu, logvar, eps, generator)
