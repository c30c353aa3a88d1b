"""AdaIN decoder trainers, the reference's alternate 2D path — port of
tgtc/train/adain_trainer.py (``AdainTrainConfig`` :25-34,
``_decoder_only_tx`` :43-61, ``init_adain_train`` :64-67,
``make_adain_finetune_step`` :70-96, ``make_adain_temporal_step`` :99-144).

The CNN decoder of :class:`~tgtc_torch.models.adain_net.AdainNet` trains
under the AdaIN objective ``content_weight·loss_c + style_weight·loss_s``;
the temporal step adds the point-splat term of Phase C2: view 0's
stylization splatted into every view of the batch
(:func:`~tgtc_torch.ops.rasterize.rasterize_warp`, NDC coor maps turned into
world points first), ``temporal_weight · mean((g − warped)² · hit ·
occl)``, ``occl`` keeping the pixels whose warped world point lies within
``space_dist_threshold`` of the view's own.

* Only ``decode`` trains: ``torch.optim.Adam`` (0.9, 0.999, eps 1e-8, the
  optax defaults) over its parameters alone; the VGG is frozen with
  ``requires_grad_(False)`` and never enters the optimizer, so it stays
  bitwise unchanged (JAX's ``set_to_zero``).
* The learning rate of update ``n`` (counted from 0, optax's count, which
  the schedule reads before it increments) is ``lr / (1 + lr_decay·n)``:
  the first update takes ``lr``, the tenth ``lr / (1 + 9·lr_decay)``.
* The gradients come from one autograd backward; no hand-written kernel
  runs here (the convolutions are the library's, f32).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Tuple

import torch

from tgtc_torch.models.adain_net import AdainNet
from tgtc_torch.ops.rasterize import ndc_to_world, rasterize_warp
from tgtc_torch.utils.img import from_uint8

TRAIN_KEYS = ("decode",)


@dataclasses.dataclass(frozen=True)
class AdainTrainConfig:
    lr: float = 1e-4
    lr_decay: float = 0.0  # the reference's lr / (1 + lr_decay · iter)
    content_weight: float = 1.0
    style_weight: float = 10.0
    temporal_weight: float = 3500.0
    space_dist_threshold: float = 5e-2
    max_iter: int = 160000


def lr_schedule(cfg: AdainTrainConfig) -> Callable[[int], float]:
    """The learning rate of update ``n``, counted from 0."""
    return lambda n: cfg.lr / (1.0 + cfg.lr_decay * n)


@dataclasses.dataclass
class AdainTrainState:
    """The counterpart of the JAX ``AdainTrainState``: the step (a host
    int), the model (the frozen VGG included) and the decoder's optimizer
    with its schedule."""

    step: int
    model: AdainNet
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


def decoder_parameters(model: AdainNet) -> List[torch.nn.Parameter]:
    """The trained parameters, in ``named_parameters`` order."""
    return [p for n, p in model.named_parameters() if n.split(".")[0] in TRAIN_KEYS]


def init_adain_train(model: AdainNet, cfg: AdainTrainConfig) -> AdainTrainState:
    """Freeze the VGG and build Adam over the decoder under
    :func:`lr_schedule` (the base lr is 1, so the lambda gives the lr)."""
    model.vgg.requires_grad_(False)
    model.decode.requires_grad_(True)
    opt = torch.optim.Adam(decoder_parameters(model), lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    return AdainTrainState(0, model, opt, torch.optim.lr_scheduler.LambdaLR(opt, lr_schedule(cfg)))


class AdainStep:
    """The update shared by both steps: :meth:`loss_and_grad` forms the
    metrics and the decoder's gradients, :meth:`apply` takes one Adam step.
    Subclasses give :meth:`losses`."""

    def __init__(self, model: AdainNet, cfg: AdainTrainConfig):
        self.model, self.cfg = model, cfg

    def losses(self, model: AdainNet, *batch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    def loss_and_grad(self, model: AdainNet, *batch
                      ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        loss, metrics = self.losses(model, *batch)
        grads = list(torch.autograd.grad(loss, decoder_parameters(model)))
        return {"loss": loss.detach(), **{k: v.detach() for k, v in metrics.items()}}, grads

    def apply(self, state: AdainTrainState, grads: List[torch.Tensor]) -> None:
        for p, g in zip(decoder_parameters(state.model), grads):
            p.grad = g
        state.optimizer.step()
        state.scheduler.step()
        state.optimizer.zero_grad(set_to_none=True)

    def __call__(self, state: AdainTrainState, *batch
                 ) -> Tuple[AdainTrainState, Dict[str, torch.Tensor]]:
        metrics, grads = self.loss_and_grad(state.model, *batch)
        self.apply(state, grads)
        state.step += 1
        return state, metrics

    def objective(self, out: Dict[str, torch.Tensor]) -> torch.Tensor:
        return self.cfg.content_weight * out["loss_c"] + self.cfg.style_weight * out["loss_s"]


class AdainFinetuneStep(AdainStep):
    """``step(state, content, style) -> (state, {"loss", "loss_c",
    "loss_s"})``: one decoder update on ``[B, P, P, 3]`` batches (uint8 or
    [0, 1] floats) on the model's device."""

    def losses(self, model, content, style):
        out = model.compute_losses(from_uint8(content), from_uint8(style))
        return self.objective(out), {"loss_c": out["loss_c"], "loss_s": out["loss_s"]}


class AdainTemporalStep(AdainStep):
    """``step(state, content, coor, cps, style) -> (state, {"loss",
    "loss_c", "loss_s", "loss_t"})``: one decoder update on full frames
    ``content [B, h, w, 3]`` with their coor maps ``[B, h, w, 3]`` (NDC
    when ``is_ndc``), camera-to-world poses ``cps [B, 4, 4]`` and ``style
    [B, h, w, 3]``, all on the model's device; ``proj`` is the ``[4, 4]``
    projection there. A side that is not a multiple of 8 (fern's 756 rows)
    comes back from the decoder rounded up (the VGG pools in ceil mode), and
    the temporal term takes the stylization cropped to the frame; the JAX
    step has no crop and fails on such a frame for the mismatched shapes.
    At multiples of 8 the two are the same."""

    def __init__(self, model: AdainNet, cfg: AdainTrainConfig, proj: torch.Tensor, h: int,
                 w: int, is_ndc: bool = True, focal: float = 1.0):
        super().__init__(model, cfg)
        self.proj, self.h, self.w, self.is_ndc, self.focal = proj, h, w, is_ndc, focal

    def losses(self, model, content, coor, cps, style):
        out = model.compute_losses(from_uint8(content), from_uint8(style))
        g = out["stylized"][:, : self.h, : self.w]  # 8·ceil(h/8) rows: the ceil pools
        coor_world = ndc_to_world(coor, self.h, self.w, self.focal) if self.is_ndc else coor
        warped_rgb, warped_coor, mask = rasterize_warp(
            coor_world[0].reshape(-1, 3), g[0].reshape(-1, 3), cps, self.proj, self.h, self.w)
        dist2 = torch.sum((warped_coor - coor_world) ** 2, dim=-1, keepdim=True)
        occl = (dist2 < self.cfg.space_dist_threshold ** 2).to(g.dtype)
        loss_t = self.cfg.temporal_weight * torch.mean((g - warped_rgb) ** 2 * mask * occl)
        return self.objective(out) + loss_t, {"loss_c": out["loss_c"], "loss_s": out["loss_s"],
                                              "loss_t": loss_t}


def make_adain_finetune_step(model: AdainNet, cfg: AdainTrainConfig) -> AdainFinetuneStep:
    """The reference's ``finetune_decoder`` step."""
    return AdainFinetuneStep(model, cfg)


def make_adain_temporal_step(model: AdainNet, cfg: AdainTrainConfig, proj: torch.Tensor,
                             h: int, w: int, is_ndc: bool = True,
                             focal: float = 1.0) -> AdainTemporalStep:
    """The reference's ``train_temporal_decoder`` step: the AdaIN losses
    and the view-0 splat term."""
    return AdainTemporalStep(model, cfg, proj, h, w, is_ndc, focal)
