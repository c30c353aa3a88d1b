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
* On the card, :meth:`TransformerTrainStep.__call__` replays the step's
  forward and backward from two CUDA graphs
  (:class:`~tgtc_torch.train.graphs.StepGraphs`; a batch key's first call
  runs eagerly, its second captures). The draws are the eager step's: the
  step's generator is registered with both graphs and re-seeded before
  each replay. The update stays eager, outside the graphs. ``captures``
  and ``replays`` count the two events.
* A step opens the sibling profiler spans ``tgtc.step.draw`` (seeding its
  own generator), ``.forward`` (the losses and their weighted sum),
  ``.backward`` (``torch.autograd.grad``) and ``.optimizer`` (the update
  and the counter), as the Phase-A and Phase-E steps do
  (:func:`tgtc_torch.utils.logging.span`).
* ``group=`` (a :class:`~tgtc_torch.parallel.DataGroup`) steps over several
  processes, as the JAX step shards its batches over the mesh: each rank
  keeps its rows of the global content and style batches, draws the whole
  batch's dropout masks for them (``rows=`` of
  :meth:`~tgtc_torch.models.stytrans.StyTrans.compute_losses`: the flash
  kernels' ``bh_offset`` is ``rank · B/W · heads``), and the gradients are
  averaged over the ranks before the update. Every loss is a mean over the
  images, so the W-process step is the 1-process step at the same global
  batch.
* Phase C2 (:mod:`tgtc_torch.train.temporal`) trains the decoder alone
  with a step of its own on the same loss and optimizer.
* :func:`train_transformer` is the C1 loop that both
  ``tools/train2d --task transformer`` and ``Pipeline.ensure_style2d`` run,
  each with its own checkpoint directory, intervals and seeds; it takes
  ``group=`` too, and ``tools/train2d`` passes the launch's group under a
  multi-process launch.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tgtc_torch.models.stytrans import StyTrans
from tgtc_torch.parallel import DataGroup
from tgtc_torch.train.graphs import Forward, Grads, StepGraphs, loss_and_grad
from tgtc_torch.utils.img import from_uint8, to_uint8
from tgtc_torch.utils.logging import span
from tgtc_torch.utils.seeds import step_seed

TRAIN_KEYS = ("transformer", "embedding")
COLLAGE_EVERY = 100  # steps between C1 collages (tgtc/train/pipeline.py:519)


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
    ``(seed, state.step)``. Under ``group`` the batches are the global ones:
    :meth:`loss_and_grad` runs on this rank's rows (its metrics and
    gradients are this rank's) and :meth:`apply` averages the gradients
    over the ranks. On the card the call replays :meth:`loss_and_grad`'s
    work from CUDA graphs (the module's docstring); ``captures`` and
    ``replays`` count how often it captured and replayed them."""

    def __init__(self, model: StyTrans, cfg: TransformerTrainConfig,
                 train_keys: Sequence[str] = TRAIN_KEYS, group: DataGroup = DataGroup()):
        self.model, self.cfg, self.train_keys, self.group = model, cfg, train_keys, group
        self._generator: Optional[torch.Generator] = None
        self.graphs = StepGraphs()

    @property
    def captures(self) -> int:
        return self.graphs.captures

    @property
    def replays(self) -> int:
        return self.graphs.replays

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
        (in :func:`trained_parameters` order), before any update; under a
        group, of this rank's rows of the batches."""
        return loss_and_grad(*self._phases(model, generator), (content, style))

    def _phases(self, model: StyTrans, generator: Optional[torch.Generator]
                ) -> Tuple[Forward, Grads]:
        """The step's forward of ``(content, style)`` and its gradients."""
        return (lambda c, s: self._forward(model, c, s, generator),
                lambda loss: self.grads(model, loss))

    def _rows(self, b: int):
        g = self.group
        return (g.row_offset(b), b) if g.world > 1 or g.active else None

    def _forward(self, model: StyTrans, content: torch.Tensor, style: torch.Tensor,
                 generator: Optional[torch.Generator]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The weighted loss and the detached metrics."""
        g = self.group
        out = model.compute_losses(from_uint8(g.rows(content)), from_uint8(g.rows(style)),
                                   deterministic=False, generator=generator,
                                   rows=self._rows(content.shape[0]))
        loss = self.weighted_loss(out)
        metrics = {k: v.detach() for k, v in out.items() if k != "ics"}
        return loss, {"loss": loss.detach(), **metrics}

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
        self.group.all_reduce_mean_(grads)
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
            with span("tgtc.step.draw"):
                generator = self.generator(seed, state.step)
        if content.is_cuda:
            key = (state.model, self._rows(content.shape[0]))
            metrics, grads = self.graphs(key, (content, style),
                                         *self._phases(state.model, generator), generator)
        else:
            metrics, grads = self.loss_and_grad(state.model, content, style, generator)
        with span("tgtc.step.optimizer"):
            self.apply(state, grads)
            state.step += 1
        return state, metrics


def make_transformer_train_step(model: StyTrans, cfg: TransformerTrainConfig,
                                train_keys: Sequence[str] = TRAIN_KEYS,
                                group: DataGroup = DataGroup()) -> TransformerTrainStep:
    """The C1 step for ``model``, on the model's device, over ``group``'s
    processes."""
    return TransformerTrainStep(model, cfg, train_keys, group)


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


def train_transformer(state: TransformerTrainState, cfg: TransformerTrainConfig,
                      content_paths: Sequence[str], style_paths: Sequence[str], ckpt, *,
                      log_dir: str, collage_dir: str, print_interval: int = 100,
                      save_interval: int = 1000, dropout_seed: int = 3, data_seed: int = 0,
                      workers: int = 4, group: DataGroup = DataGroup()
                      ) -> TransformerTrainState:
    """The C1 loop up to ``cfg.max_iter`` steps from ``state`` (its model on
    the card or the CPU). Content and style crop batches come from two
    prefetchers seeded ``data_seed`` and ``data_seed + 1``; dropout from
    ``dropout_seed``. Every ``print_interval`` steps one line goes to
    ``log_dir/transformer.jsonl`` (with ``steps_per_s`` over the steps since
    the last, the window closed by the log's fetch); every
    :data:`COLLAGE_EVERY` steps and at the end the content/style/stylized
    collage (the reference's C1 verification artifact) is written to
    ``collage_dir/<step>.png``; every ``save_interval`` steps and at the end
    ``state`` is saved through ``ckpt`` (a
    :class:`~tgtc_torch.train.checkpoint.CheckpointManager`, asynchronously;
    the last save is waited for). Returns ``state``.

    Over ``group``'s processes every rank calls this with the same
    arguments: rank 0's parameters are broadcast once, every rank draws the
    same global crop batches and steps on its rows of them
    (:class:`TransformerTrainStep`), the logged metrics are averaged over
    the ranks, rank 0 alone writes the log, the collages and the
    checkpoints, and every rank waits at the end until the last checkpoint
    is on disk."""
    from tgtc_torch.data.prefetch import CropBatchPrefetcher, ResizeCache, upload
    from tgtc_torch.utils import native
    from tgtc_torch.utils.logging import MetricsLogger, fetch_scalars

    if not (content_paths and style_paths):
        raise ValueError("C1 needs content and style images")
    dev = next(state.model.parameters()).device
    main = group.rank == 0
    if main:
        os.makedirs(collage_dir, exist_ok=True)
    logger = MetricsLogger(log_dir, name="transformer")
    collage_fn = make_collage_fn(state.model)
    group.broadcast_([p.detach() for p in state.model.parameters()])
    step_fn = make_transformer_train_step(state.model, cfg, group=group)
    cache = ResizeCache()
    with CropBatchPrefetcher(content_paths, cfg.batch_size, cfg.patch, seed=data_seed,
                             workers=workers, cache=cache) as cpf, \
            CropBatchPrefetcher(style_paths, cfg.batch_size, cfg.patch, seed=data_seed + 1,
                                workers=workers, cache=cache) as spf:
        step = last_log = state.step
        t_log = time.perf_counter()
        try:
            while step < cfg.max_iter:
                content, style = upload(cpf.next(), dev), upload(spf.next(), dev)
                state, metrics = step_fn(state, content, style, seed=dropout_seed)
                step = state.step
                if step % print_interval == 0:
                    # the fetch syncs: it closes the window
                    scalars = fetch_scalars(group.mean_scalars(metrics))
                    now = time.perf_counter()
                    scalars["steps_per_s"] = (step - last_log) / (now - t_log)
                    logger.log(step, scalars, prefix="TRANS TRAIN")
                    last_log, t_log = step, time.perf_counter()
                if main and (step % COLLAGE_EVERY == 0 or step >= cfg.max_iter):
                    native.write_png_async(os.path.join(collage_dir, f"{step}.png"),
                                           collage_fn(content, style).cpu().numpy())
                if step % save_interval == 0 or step >= cfg.max_iter:
                    ckpt.save_device_async(step, state.state_dict(), wait=step >= cfg.max_iter)
        finally:
            logger.close()
    errors = native.wait_writes()
    if errors:
        raise IOError(f"{errors} C1 collage writes failed")
    group.barrier()  # the last checkpoint is on disk for every rank
    return state
