"""Phase A — NeRF pretraining — port of tgtc/train/nerf_trainer.py and of
the Phase-A loop of ``Pipeline.train_nerf`` (tgtc/train/pipeline.py:263-385).

* The full ray set lives on the device; a step gathers its batch with
  indices drawn from a ``torch.Generator``.
* Every random draw of a step (batch indices, coarse-depth jitter, σ noise)
  is a :class:`StepDraws` field, so callers (the tests) can hand in JAX's
  draws; :meth:`TrainStep.loss_and_grad` gives the loss and the gradients
  before the optimizer touches them.
* Two step builders: :func:`make_train_step`, eager autograd through
  ``render.volume`` (any trunk), and :func:`make_fused_train_step`, the
  fused trunk with K1 forward and K3 backward
  (``ops.kernels.nerf_mlp_grad``), taken exactly when
  :func:`fused_train_supported` holds on the card.
* Adam(0.9, 0.999, eps 1e-8) at ``lrate * 0.1 ** (n / lrate_decay)`` for
  update ``n`` counted from 0 (optax's count); ``steps_per_opt > 1``
  averages the micro-steps' gradients (Welford, as ``optax.MultiSteps``)
  and updates once.
* Not ported: the K-step ``lax.scan`` dispatch (a TPU workaround) and
  training-time ``train_fine_budget``, which raises until
  ``select_sample_budget`` is ported (ROADMAP.md queue 1, 'Proposal
  levers and sample budgets').
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from tgtc_torch.data.rays import rays_for_poses
from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.models.nerf import NerfConfig, NerfMLP, make_nerf
from tgtc_torch.ops.composite import alpha_composite
from tgtc_torch.ops.kernels.nerf_mlp import CUDA_FREQS, CUDA_WIDTH
from tgtc_torch.ops.kernels.nerf_mlp_grad import (
    fused_nerf_apply_diff,
    pack_nerf_params_traceable,
)
from tgtc_torch.ops.losses import img2mse, mse2psnr
from tgtc_torch.ops.sampling import merge_and_resample_fine, sample_along_rays_uniform
from tgtc_torch.render.fast import _points_t
from tgtc_torch.render.volume import RenderSettings, render_rays
from tgtc_torch.train.checkpoint import CheckpointManager
from tgtc_torch.utils.logging import MetricsLogger, SegmentTimer
from tgtc_torch.utils.seeds import step_seed

_BUDGET_NOT_PORTED = ("train_fine_budget is not ported yet (ROADMAP.md queue 1, 'Proposal "
                      "levers and sample budgets': select_sample_budget)")
CKPT_EVERY = 500  # steps between Phase-A checkpoints (tgtc/train/pipeline.py:377)


@dataclasses.dataclass(frozen=True)
class NerfTrainConfig:
    batch_size: int = 2048
    lrate: float = 5e-4
    lrate_decay: int = 100000  # steps for a 10x decay
    n_samples: int = 64
    n_samples_fine: int = 64
    sigma_noise_std: float = 1.0
    near: float = 0.0
    far: float = 1.0
    white_bkgd: bool = False
    steps_per_opt: int = 1  # gradient accumulation over this many micro-steps
    train_fine_budget: Optional[int] = None  # not ported yet: raises

    def render_settings(self, perturb: bool) -> RenderSettings:
        return RenderSettings(
            n_samples=self.n_samples,
            n_samples_fine=self.n_samples_fine,
            near=self.near,
            far=self.far,
            sigma_noise_std=self.sigma_noise_std if perturb else 0.0,
            white_bkgd=self.white_bkgd,
            perturb=perturb,
            fine_budget=self.train_fine_budget if perturb else None,
        )


@dataclasses.dataclass
class NerfTrainState:
    """The counterpart of the JAX ``NerfTrainState``: the step (a host int,
    so the loop never syncs to read it), both trunks and the optimizer.
    ``grad_acc``/``mini_step`` hold the ``steps_per_opt`` accumulation."""

    step: int
    coarse: NerfMLP
    fine: NerfMLP
    optimizer: torch.optim.Adam
    scheduler: torch.optim.lr_scheduler.LambdaLR
    grad_acc: Optional[List[torch.Tensor]] = None
    mini_step: int = 0

    def parameters(self) -> List[torch.nn.Parameter]:
        return list(self.coarse.parameters()) + list(self.fine.parameters())

    def state_dict(self) -> Dict[str, Any]:
        return {"step": self.step, "mini_step": self.mini_step,
                "coarse": self.coarse.state_dict(), "fine": self.fine.state_dict(),
                "optimizer": self.optimizer.state_dict(),
                "scheduler": self.scheduler.state_dict(), "grad_acc": self.grad_acc}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.step, self.mini_step = int(sd["step"]), int(sd["mini_step"])
        self.coarse.load_state_dict(sd["coarse"])
        self.fine.load_state_dict(sd["fine"])
        self.optimizer.load_state_dict(sd["optimizer"])
        self.scheduler.load_state_dict(sd["scheduler"])
        dev = self.parameters()[0].device
        self.grad_acc = (None if sd["grad_acc"] is None
                         else [g.to(dev) for g in sd["grad_acc"]])


def make_optimizer(cfg: NerfTrainConfig, params) -> Tuple[torch.optim.Adam,
                                                          torch.optim.lr_scheduler.LambdaLR]:
    """Adam (reference betas) under ``lrate * 0.1 ** (n / lrate_decay)``,
    where ``n`` counts optimizer updates from 0."""
    opt = torch.optim.Adam(params, lr=cfg.lrate, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.LambdaLR(
        opt, lambda n: 0.1 ** (n / cfg.lrate_decay))
    return opt, sched


def init_state(generator: torch.Generator, nerf_cfg: NerfConfig,
               train_cfg: NerfTrainConfig, fine_cfg: Optional[NerfConfig] = None,
               device: DeviceLike = None) -> NerfTrainState:
    """Both trunks drawn from ``generator`` (coarse first), on ``device``
    (default the card). ``fine_cfg`` defaults to ``nerf_cfg``."""
    dev = resolve_device(device)
    coarse = make_nerf(nerf_cfg, generator, device=dev)
    fine = make_nerf(fine_cfg or nerf_cfg, generator, device=dev)
    opt, sched = make_optimizer(train_cfg, list(coarse.parameters()) + list(fine.parameters()))
    return NerfTrainState(0, coarse, fine, opt, sched)


# ---------------------------------------------------------------- the step


@dataclasses.dataclass
class StepDraws:
    """One step's random numbers: batch indices ``[B]``, coarse-depth
    jitter ``[B, Nc]`` in [0, 1), standard-normal σ noise ``[B, Nc]`` and
    ``[B, Nc + Nf]`` (None when ``sigma_noise_std`` is 0)."""

    idx: torch.Tensor
    perturb_u: torch.Tensor
    noise_coarse: Optional[torch.Tensor] = None
    noise_fine: Optional[torch.Tensor] = None


LossFn = Callable[[NerfMLP, NerfMLP, torch.Tensor, torch.Tensor, torch.Tensor, StepDraws],
                  Tuple[torch.Tensor, torch.Tensor]]


class TrainStep:
    """``step(state, rays_o, rays_d, rgb_gt, generator=None, draws=None) ->
    (state, metrics)``: gathers the batch, renders, backpropagates and
    updates ``state`` in place. Metrics are device scalars (no sync). The
    state, the rays and the draws live on ``device``."""

    def __init__(self, loss_fn: LossFn, cfg: NerfTrainConfig, device: DeviceLike = None):
        self.loss_fn, self.cfg = loss_fn, cfg
        self.device = resolve_device(device)

    def draw(self, n_rays: int, generator: Optional[torch.Generator] = None) -> StepDraws:
        c = self.cfg
        b, nc, nf = c.batch_size, c.n_samples, c.n_samples + c.n_samples_fine
        kw = dict(generator=generator, device=self.device)
        idx = torch.randint(0, n_rays, (b,), **kw)
        u = torch.rand((b, nc), **kw)
        if c.sigma_noise_std <= 0.0:
            return StepDraws(idx, u)
        return StepDraws(idx, u, torch.randn((b, nc), **kw), torch.randn((b, nf), **kw))

    def loss_and_grad(self, coarse: NerfMLP, fine: NerfMLP, rays_o: torch.Tensor,
                      rays_d: torch.Tensor, rgb_gt: torch.Tensor, draws: StepDraws
                      ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor]]:
        """Loss, metrics and the gradients of both trunks' parameters
        (coarse then fine, in ``parameters()`` order), before any update."""
        idx = draws.idx
        loss_c, loss_f = self.loss_fn(coarse, fine, rays_o[idx], rays_d[idx], rgb_gt[idx],
                                      draws)
        loss = loss_c + loss_f
        grads = torch.autograd.grad(loss, list(coarse.parameters()) + list(fine.parameters()))
        loss_c, loss_f = loss_c.detach(), loss_f.detach()
        metrics = {"loss": loss.detach(), "loss_coarse": loss_c, "loss_fine": loss_f,
                   "psnr": mse2psnr(loss_c), "psnr_fine": mse2psnr(loss_f)}
        return metrics, list(grads)

    def apply(self, state: NerfTrainState, grads: List[torch.Tensor]) -> None:
        """One optimizer update, or one micro-step of ``steps_per_opt``."""
        k = self.cfg.steps_per_opt
        if k > 1:
            if state.grad_acc is None:
                state.grad_acc = [torch.zeros_like(g) for g in grads]
            n = state.mini_step
            for acc, g in zip(state.grad_acc, grads):  # running mean
                acc.add_((g - acc) / (n + 1))
            state.mini_step = (n + 1) % k
            if state.mini_step:
                return
            grads, state.grad_acc = state.grad_acc, None
        for p, g in zip(state.parameters(), grads):
            p.grad = g
        state.optimizer.step()
        state.scheduler.step()
        state.optimizer.zero_grad(set_to_none=True)

    def __call__(self, state: NerfTrainState, rays_o: torch.Tensor, rays_d: torch.Tensor,
                 rgb_gt: torch.Tensor, generator: Optional[torch.Generator] = None,
                 draws: Optional[StepDraws] = None
                 ) -> Tuple[NerfTrainState, Dict[str, torch.Tensor]]:
        if draws is None:
            draws = self.draw(rays_o.shape[0], generator)
        metrics, grads = self.loss_and_grad(state.coarse, state.fine, rays_o, rays_d,
                                            rgb_gt, draws)
        self.apply(state, grads)
        state.step += 1
        return state, metrics


def make_train_step(train_cfg: NerfTrainConfig, device: DeviceLike = None) -> TrainStep:
    """The eager Phase-A step on ``device`` (default the card): autograd
    through ``render_rays`` in each trunk's ``compute_dtype``."""
    if train_cfg.train_fine_budget is not None:
        raise NotImplementedError(_BUDGET_NOT_PORTED)
    settings = train_cfg.render_settings(perturb=True)

    def loss_fn(coarse, fine, b_o, b_d, b_rgb, dr: StepDraws):
        out = render_rays(coarse, fine, b_o, b_d, settings, perturb_u=dr.perturb_u,
                          noise_coarse=dr.noise_coarse, noise_fine=dr.noise_fine)
        return img2mse(out["coarse"].rgb, b_rgb), img2mse(out["fine"].rgb, b_rgb)

    return TrainStep(loss_fn, train_cfg, device)


def fused_train_supported(nerf_cfg: NerfConfig, fine_cfg: Optional[NerfConfig] = None
                          ) -> bool:
    """Eligibility for :func:`make_fused_train_step`: the relu viewdir trunk
    with its skip at 4, fine dims equal to the coarse dims (one packed
    layout serves both passes), and the shape the CUDA kernels take
    (width 256, 10/4 frequencies). The kernels mask a ragged point count,
    so the JAX version's tile divisibility has no counterpart."""
    f = fine_cfg or nerf_cfg
    return (
        nerf_cfg.act_type == "relu"
        and nerf_cfg.use_viewdir
        and tuple(nerf_cfg.skips) == (4,)
        and f.depth == nerf_cfg.depth and f.width == nerf_cfg.width
        and (nerf_cfg.width, (nerf_cfg.embed_freq_coor, nerf_cfg.embed_freq_dir))
        == (CUDA_WIDTH, CUDA_FREQS)
    )


def make_fused_train_step(nerf_cfg: NerfConfig, train_cfg: NerfTrainConfig,
                          fine_cfg: Optional[NerfConfig] = None,
                          device: DeviceLike = None) -> TrainStep:
    """The Phase-A step on the fused trunk, on ``device`` (default the
    card): both passes run K1 forward under autograd and K3 backward (their
    plain twins for CPU tensors)."""
    if not fused_train_supported(nerf_cfg, fine_cfg):
        raise ValueError(
            "make_fused_train_step preconditions not met (relu trunk, use_viewdir, "
            "skips=(4,), fine dims == coarse dims, width 256 with 10/4 frequencies) "
            "— check fused_train_supported() before calling, or use make_train_step()")
    if train_cfg.train_fine_budget is not None:
        raise NotImplementedError(_BUDGET_NOT_PORTED)
    s = train_cfg
    kw = dict(depth=nerf_cfg.depth, num_freq_coor=nerf_cfg.embed_freq_coor,
              num_freq_dir=nerf_cfg.embed_freq_dir, skip=nerf_cfg.skips[0],
              width=nerf_cfg.width)

    def run_pass(model, b_o, b_d, ts, noise):
        r, n = ts.shape
        packed = pack_nerf_params_traceable(dict(model.named_parameters()), **kw)
        pt, dt = _points_t(b_o, b_d, ts)
        rgb_t, sigma_t = fused_nerf_apply_diff(packed, pt, dt)
        return alpha_composite(rgb_t.reshape(3, r, n).permute(1, 2, 0), sigma_t.reshape(r, n),
                               ts, noise_std=s.sigma_noise_std, noise=noise,
                               white_bkgd=s.white_bkgd)

    def loss_fn(coarse, fine, b_o, b_d, b_rgb, dr: StepDraws):
        _, ts = sample_along_rays_uniform(b_o, b_d, s.n_samples, near=s.near, far=s.far,
                                          u=dr.perturb_u)
        comp_c = run_pass(coarse, b_o, b_d, ts, dr.noise_coarse)
        # the fine depths are not differentiated (stop_gradient in JAX)
        _, ts_f = merge_and_resample_fine(b_o, b_d, ts, comp_c.weights.detach(),
                                          s.n_samples_fine)
        comp_f = run_pass(fine, b_o, b_d, ts_f, dr.noise_fine)
        return img2mse(comp_c.rgb, b_rgb), img2mse(comp_f.rgb, b_rgb)

    return TrainStep(loss_fn, train_cfg, device)


# ---------------------------------------------------------------- rendering


def make_render_fn(train_cfg: NerfTrainConfig):
    """Eager full-precision render of a flat ray block (no noise, no jitter):
    ``(coarse, fine, rays_o, rays_d) -> {rgb, rgb_coarse, t_exp, acc}``."""
    settings = train_cfg.render_settings(perturb=False)

    @torch.no_grad()
    def render_fn(coarse: NerfMLP, fine: NerfMLP, rays_o: torch.Tensor,
                  rays_d: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = render_rays(coarse, fine, rays_o, rays_d, settings)
        return {"rgb": out["fine"].rgb, "rgb_coarse": out["coarse"].rgb,
                "t_exp": out["fine"].t_exp, "acc": out["fine"].acc}

    return render_fn


def render_image(render_fn, coarse: NerfMLP, fine: NerfMLP, rays_o: torch.Tensor,
                 rays_d: torch.Tensor, block: int = 65536) -> Dict[str, torch.Tensor]:
    """Any ray count by fixed-size blocks; the tail block is padded with zero
    origins and unit directions."""
    n = rays_o.shape[0]
    outs = []
    for start in range(0, n, block):
        end = min(start + block, n)
        bo, bd = rays_o[start:end], rays_d[start:end]
        if end - start < block:
            pad = block - (end - start)
            bo = torch.cat([bo, bo.new_zeros((pad, 3))], 0)
            bd = torch.cat([bd, bd.new_ones((pad, 3))], 0)
        out = render_fn(coarse, fine, bo, bd)
        outs.append({k: v[: end - start] for k, v in out.items()})
    return {k: torch.cat([o[k] for o in outs], 0) for k in outs[0]}


# ---------------------------------------------------------------- budgets


def parse_budget_schedule(spec: str) -> "list[Tuple[int, Optional[int]]]":
    """Parse a ``--train_fine_budget`` schedule spec into
    ``[(start_step, budget_or_None), ...]`` sorted by start step.

    Grammar: comma-separated ``BUDGET@START`` segments; a bare ``BUDGET``
    means "from step 0". Budget 0 means exact (no culling). Steps before
    the first segment run exact. Examples::

        ""                  -> [(0, None)]
        "80"                -> [(0, 80)]
        "96@60000,80@90000" -> [(0, None), (60000, 96), (90000, 80)]

    The budget must tighten over the schedule (exact early, smaller
    later); a loosening schedule is rejected.
    """
    segments: "list[Tuple[int, Optional[int]]]" = [(0, None)]
    s = (spec or "").strip()
    if not s:
        return segments
    for part in s.split(","):
        part = part.strip().lower()
        if not part:
            continue
        budget_s, _, start_s = part.partition("@")
        try:
            budget = int(budget_s)
            start = int(start_s) if start_s else 0
        except ValueError:
            raise ValueError(
                f"bad --train_fine_budget segment {part!r}: expected "
                "BUDGET or BUDGET@START with integer fields, e.g. "
                "'80' or '96@60000,80@90000'"
            ) from None
        if budget < 0 or start < 0:
            raise ValueError(
                f"bad --train_fine_budget segment {part!r}: negative values")
        segments.append((start, budget or None))
    segments.sort(key=lambda p: p[0])
    if segments[1][0] == 0:
        segments = segments[1:]  # explicit step-0 segment replaces the default
    budgets = [b for _, b in segments]
    for earlier, later in zip(budgets, budgets[1:]):
        if earlier is not None and (later is None or later > earlier):
            raise ValueError(
                f"--train_fine_budget schedule must tighten (exact early, "
                f"smaller budgets later); got {spec!r}")
    starts = [st for st, _ in segments]
    if len(set(starts)) != len(starts):
        raise ValueError(
            f"--train_fine_budget schedule has duplicate start steps: {spec!r}")
    return segments


def budget_at_step(segments: "list[Tuple[int, Optional[int]]]", step: int
                   ) -> Tuple[Optional[int], Optional[int]]:
    """``(budget, next_boundary)`` for ``step`` under a parsed schedule;
    ``next_boundary`` is the first segment start after ``step`` (None in
    the last segment)."""
    budget = segments[0][1]
    next_boundary = None
    for start, b in segments:
        if start <= step:
            budget = b
        else:
            next_boundary = start
            break
    return budget, next_boundary


# ---------------------------------------------------------------- the loop


def train_nerf(
    scene,
    nerf_cfg: NerfConfig,
    train_cfg: NerfTrainConfig,
    steps: int,
    out_dir: str,
    fine_cfg: Optional[NerfConfig] = None,
    seed: int = 0,
    i_print: int = 100,
    use_ndc: bool = True,
    pixel_alignment: bool = False,
    device: DeviceLike = None,
    print_fn=print,
) -> Tuple[NerfTrainState, Dict[str, list]]:
    """Phase A on ``scene`` (an ``LlffScene``) up to ``steps`` steps,
    resuming from the latest checkpoint under ``out_dir/nerf_ckpt``. A
    ``train_cfg.train_fine_budget`` raises (not ported yet).

    The step is fused (K1 + K3) exactly when the device is a card and
    :func:`fused_train_supported` holds, else eager. The host syncs with the
    device only at log steps (every ``i_print`` steps and the last; one
    fetch of the window's losses and the metrics) and checkpoint steps
    (every :data:`CKPT_EVERY` steps and the last, saved asynchronously; the last
    save is waited for). Logs go to ``out_dir/logs/nerf.jsonl``. Returns the
    state and ``{"loss": [every step's loss], "records": [logged lines]}``;
    a record is its JSONL line, step included, and its ``steps_per_s`` covers
    the steps since the previous record.
    """
    dev = resolve_device(device)
    state = init_state(torch.Generator().manual_seed(seed), nerf_cfg, train_cfg, fine_cfg,
                       device=dev)
    ckpt = CheckpointManager(os.path.join(out_dir, "nerf_ckpt"))
    if ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore(map_location=dev))
    history: Dict[str, list] = {"loss": [], "records": []}
    if state.step >= steps:
        ckpt.close()
        return state, history

    h, w, _ = scene.hwf
    ro, rd = rays_for_poses(h, w, scene.intrinsics, scene.poses, use_ndc=use_ndc,
                            pixel_alignment=pixel_alignment, device=dev)
    rays_o, rays_d = ro.reshape(-1, 3), rd.reshape(-1, 3)
    rgb_gt = torch.as_tensor(scene.images, dtype=torch.float32).reshape(-1, 3).to(dev)

    use_fused = dev.type == "cuda" and fused_train_supported(nerf_cfg, fine_cfg)
    if print_fn is not None:
        print_fn(f"[train] {'fused trunk (K1 + K3)' if use_fused else 'eager'} step, "
                 f"{rays_o.shape[0]} rays on {dev}")
    step_fn = (make_fused_train_step(nerf_cfg, train_cfg, fine_cfg, dev) if use_fused
               else make_train_step(train_cfg, dev))

    logger = MetricsLogger(os.path.join(out_dir, "logs"), name="nerf", print_fn=print_fn)
    timer = SegmentTimer()
    gen = torch.Generator(device=dev)
    step = last_log = last_ckpt = state.step
    window: List[torch.Tensor] = []
    t_log = time.perf_counter()
    timer.start("model")
    try:
        while step < steps:
            gen.manual_seed(step_seed(seed, step))
            state, metrics = step_fn(state, rays_o, rays_d, rgb_gt, generator=gen)
            step = state.step
            window.append(metrics["loss"])
            if step // i_print > last_log // i_print or step >= steps:
                timer.start("log")
                keys = list(metrics)
                vals = torch.stack(window + [metrics[k].float().reshape(()) for k in keys]
                                   ).cpu().tolist()
                history["loss"] += vals[:len(window)]
                m = dict(zip(keys, vals[len(window):]))
                now = time.perf_counter()
                m["steps_per_s"] = (step - last_log) / (now - t_log)
                m.update(timer.report_and_reset())
                history["records"].append(
                    {"step": step, **logger.log(step, m, prefix="ORIGIN TRAIN")})
                window, last_log, t_log = [], step, time.perf_counter()
                timer.start("model")
            if step // CKPT_EVERY > last_ckpt // CKPT_EVERY or step >= steps:
                ckpt.save_device_async(step, state.state_dict(), wait=step >= steps)
                last_ckpt = step
    finally:
        timer.stop()
        logger.close()
        ckpt.close()
    return state, history
