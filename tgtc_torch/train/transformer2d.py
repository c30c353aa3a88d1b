"""Phase C1 — StyTrans (2D stylization transformer) pretraining — port of
tgtc/train/transformer2d.py.

Content = NeRF renders (Phase-B output), style = a style-image folder; loss
= ``content_weight·loss_c + style_weight·loss_s + id1_weight·l_id1 +
id2_weight·l_id2``; Adam(0.9, 0.999, eps 1e-8) over the ``transformer`` and
``embedding`` submodules only, at a warm-up lr ``lr·0.1·(1 + 3e-4·n)`` for
``warmup_iters`` updates, then ``2e-4 / (1 + lr_decay·(n − 1e4))``, ``n``
the update count from 0 (optax's count).

* Every other parameter (the VGG, the decoder) is frozen with
  ``requires_grad_(False)``: no weight gradient is formed for it, as the
  JAX step differentiates only the trained subtrees, while gradients still
  flow through the VGG and the decoder to the transformer.
* uint8 batches are normalized on the device.
* Dropout draws from one ``torch.Generator`` per step, seeded from (seed,
  step) by :func:`step_seed`, so a resumed run draws what an uninterrupted
  one would. It replaces the JAX package's ``dropout_key`` (an rbg/threefry
  choice made for the TPU).
* Metrics are 0-d device tensors, fetched only when logged.
* Phase C2 (:mod:`tgtc_torch.train.temporal`) trains the decoder alone
  with a step of its own on the same loss and optimizer.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tgtc_torch.models.stytrans import StyTrans
from tgtc_torch.utils.img import from_uint8, to_uint8
from tgtc_torch.utils.seeds import step_seed

TRAIN_KEYS = ("transformer", "embedding")


@dataclasses.dataclass(frozen=True)
class TransformerTrainConfig:
    lr: float = 5e-4
    lr_decay: float = 1e-5
    max_iter: int = 5000
    batch_size: int = 8
    style_weight: float = 10.0
    content_weight: float = 7.0
    id1_weight: float = 70.0
    id2_weight: float = 1.0
    warmup_iters: int = 10000
    patch: int = 256


def lr_schedule(cfg: TransformerTrainConfig) -> Callable[[int], float]:
    """The learning rate of update ``n`` (counted from 0): warm-up, then
    decay."""

    def fn(n: int) -> float:
        if n < cfg.warmup_iters:
            return cfg.lr * 0.1 * (1.0 + 3e-4 * n)
        return 2e-4 / (1.0 + cfg.lr_decay * (n - 1e4))

    return fn


@dataclasses.dataclass
class TransformerTrainState:
    """The counterpart of the JAX ``TransformerTrainState``: the step (a
    host int), the model (every parameter, frozen ones included) and the
    optimizer over the trained ones with its schedule."""

    step: int
    model: StyTrans
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


def trained_parameters(model: StyTrans, train_keys: Sequence[str] = TRAIN_KEYS
                       ) -> List[Tuple[str, torch.nn.Parameter]]:
    """``(name, parameter)`` of every parameter of the top-level submodules
    ``train_keys``, in ``named_parameters`` order (the optimizer's order)."""
    return [(n, p) for n, p in model.named_parameters() if n.split(".")[0] in train_keys]


def init_transformer_train(model: StyTrans, cfg: TransformerTrainConfig,
                           train_keys: Sequence[str] = TRAIN_KEYS) -> TransformerTrainState:
    """Freeze every top-level submodule of ``model`` outside ``train_keys``
    and build Adam over the rest, under :func:`lr_schedule` (the optimizer's
    base lr is 1, so that the lambda gives the lr itself)."""
    trained = {n for n, _ in trained_parameters(model, train_keys)}
    for name, p in model.named_parameters():
        p.requires_grad_(name in trained)
    params = [p for _, p in trained_parameters(model, train_keys)]
    opt = torch.optim.Adam(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_schedule(cfg))
    return TransformerTrainState(0, model, opt, sched)


class TransformerTrainStep:
    """``step(state, content, style, seed=0, generator=None) -> (state,
    metrics)``: one C1 update of ``state`` in place. ``content``/``style``
    are ``[B, P, P, 3]`` batches, uint8 or [0, 1] floats, on the model's
    device; dropout draws from ``generator``, by default one seeded from
    ``(seed, state.step)``."""

    def __init__(self, model: StyTrans, cfg: TransformerTrainConfig,
                 train_keys: Sequence[str] = TRAIN_KEYS):
        self.model, self.cfg, self.train_keys = model, cfg, train_keys
        self._generator: Optional[torch.Generator] = None

    def generator(self, seed: int, step: int) -> torch.Generator:
        """The step's generator on the model's device, seeded from (seed, step)."""
        dev = next(self.model.parameters()).device
        if self._generator is None or self._generator.device != dev:
            self._generator = torch.Generator(device=dev)
        return self._generator.manual_seed(step_seed(seed, step))

    def loss_and_grad(self, model: StyTrans, content: torch.Tensor, style: torch.Tensor,
                      generator: Optional[torch.Generator]
                      ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """The metrics and the gradients of ``model``'s trained parameters
        (in :func:`trained_parameters` order), before any update."""
        out = model.compute_losses(from_uint8(content), from_uint8(style), deterministic=False,
                                   generator=generator)
        loss = self.weighted_loss(out)
        metrics = {k: v.detach() for k, v in out.items() if k != "ics"}
        return {"loss": loss.detach(), **metrics}, self.grads(model, loss)

    def weighted_loss(self, out: Dict[str, torch.Tensor]) -> torch.Tensor:
        """The four-term loss of :meth:`StyTrans.compute_losses`' output."""
        c = self.cfg
        return (c.content_weight * out["loss_c"] + c.style_weight * out["loss_s"]
                + c.id1_weight * out["l_id1"] + c.id2_weight * out["l_id2"])

    def grads(self, model: StyTrans, loss: torch.Tensor) -> List[torch.Tensor]:
        """``loss``'s gradients of ``model``'s trained parameters."""
        params = [p for _, p in trained_parameters(model, self.train_keys)]
        return list(torch.autograd.grad(loss, params))

    def apply(self, state: TransformerTrainState, grads: List[torch.Tensor]) -> None:
        for (_, p), g in zip(trained_parameters(state.model, self.train_keys), grads):
            p.grad = g
        state.optimizer.step()
        state.scheduler.step()
        state.optimizer.zero_grad(set_to_none=True)

    def __call__(self, state: TransformerTrainState, content: torch.Tensor,
                 style: torch.Tensor, seed: int = 0,
                 generator: Optional[torch.Generator] = None
                 ) -> Tuple[TransformerTrainState, Dict[str, torch.Tensor]]:
        if generator is None:
            generator = self.generator(seed, state.step)
        metrics, grads = self.loss_and_grad(state.model, content, style, generator)
        self.apply(state, grads)
        state.step += 1
        return state, metrics


def make_transformer_train_step(model: StyTrans, cfg: TransformerTrainConfig,
                                train_keys: Sequence[str] = TRAIN_KEYS) -> TransformerTrainStep:
    """The C1 step for ``model``, on the model's device."""
    return TransformerTrainStep(model, cfg, train_keys)


def make_collage_fn(model: StyTrans) -> Callable[[torch.Tensor, torch.Tensor], torch.Tensor]:
    """The C1 debug collage: ``(content, style)`` uint8 ``[B, P, P, 3]`` →
    uint8 ``[3P, B·P, 3]`` on the model's device, row 0 the content batch,
    row 1 the style batch, row 2 the stylized output."""

    @torch.no_grad()
    def collage(content: torch.Tensor, style: torch.Tensor) -> torch.Tensor:
        content, style = from_uint8(content), from_uint8(style)
        ics, _ = model.stylize(content, style)
        rows = [content, style, ics]
        return to_uint8(torch.cat([torch.cat(list(r), dim=1) for r in rows], dim=0))

    return collage
