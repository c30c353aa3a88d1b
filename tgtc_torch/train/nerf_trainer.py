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
* On the card the fused step's ``__call__`` replays
  :meth:`TrainStep.loss_and_grad`'s work (gathers, both passes, the loss,
  K3's backward) from two CUDA graphs
  (:class:`~tgtc_torch.train.graphs.StepGraphs`; a batch key's first call
  runs eagerly, its second captures). The key holds the trunks and the
  rays' identity and layout: the forward graph gathers from them where
  they lie. The draws stay outside: they are made (or taken from the
  caller) as before and copied into the forward graph's static buffers;
  the loss draws nothing else, so no generator is registered with the
  graphs. The update (:meth:`TrainStep.apply`) stays eager. ``captures``
  and ``replays`` count the two events. The eager builder's step, CPU
  tensors and :meth:`TrainStep.loss_and_grad` called directly run eagerly.
* Adam(0.9, 0.999, eps 1e-8) at ``lrate * 0.1 ** (n / lrate_decay)`` for
  update ``n`` counted from 0 (optax's count); ``steps_per_opt > 1``
  averages the micro-steps' gradients (Welford, as ``optax.MultiSteps``)
  and updates once.
* ``train_fine_budget``: the fine pass evaluates only each ray's budget of
  merged samples (``ops.sampling.select_sample_budget``, scored from the
  raw coarse σ without a gradient) and composites them with their
  full-set intervals; :func:`train_nerf` switches budgets at the segment
  boundaries of a schedule (:func:`parse_budget_schedule`).
* ``group=`` (a :class:`~tgtc_torch.parallel.DataGroup`) steps over
  several processes, as the JAX step shards its batch over the mesh: every
  rank draws the global :class:`StepDraws`, keeps its rows, and the
  gradients are all-reduced (averaged) once per optimizer update, so the
  W-process step is the 1-process step at the same global batch. Rank 0
  alone writes the checkpoints and the log.
* Not ported: the K-step ``lax.scan`` dispatch (a TPU workaround).
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
from tgtc_torch.ops.sampling import (
    merge_and_resample_fine,
    sample_along_rays_uniform,
    select_sample_budget,
)
from tgtc_torch.parallel import DataGroup, is_main_process
from tgtc_torch.render.fast import _points_t, render_in_blocks
from tgtc_torch.render.volume import RenderSettings, render_rays
from tgtc_torch.train.checkpoint import CheckpointManager
from tgtc_torch.train.graphs import Forward, Grads, StepGraphs, loss_and_grad
from tgtc_torch.utils.logging import MetricsLogger, SegmentTimer, span
from tgtc_torch.utils.seeds import step_seed

CKPT_EVERY = 500  # steps between Phase-A checkpoints (tgtc/train/pipeline.py:377)
PROFILE_STEPS = 20  # steps traced under profile_dir (tgtc/train/pipeline.py:366)


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
    train_fine_budget: Optional[int] = None  # fine samples a ray kept (None: all)

    @property
    def n_fine_eval(self) -> int:
        """Samples a ray of the fine pass evaluates when training."""
        m = self.n_samples + self.n_samples_fine
        if self.train_fine_budget is None:
            return m
        if not 0 < self.train_fine_budget <= m:
            raise ValueError(f"train_fine_budget {self.train_fine_budget} not in (0, {m}]")
        return self.train_fine_budget

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
    ``[B, n_fine_eval]`` (``Nc + Nf``, or the budget; None when
    ``sigma_noise_std`` is 0)."""

    idx: torch.Tensor
    perturb_u: torch.Tensor
    noise_coarse: Optional[torch.Tensor] = None
    noise_fine: Optional[torch.Tensor] = None


LossFn = Callable[[NerfMLP, NerfMLP, torch.Tensor, torch.Tensor, torch.Tensor, StepDraws],
                  Tuple[torch.Tensor, torch.Tensor]]


def _draw_tensors(draws: StepDraws) -> List[Optional[torch.Tensor]]:
    return [getattr(draws, f.name) for f in dataclasses.fields(draws)]


class TrainStep:
    """``step(state, rays_o, rays_d, rgb_gt, generator=None, draws=None) ->
    (state, metrics)``: gathers the batch, renders, backpropagates and
    updates ``state`` in place. Metrics are device scalars (no sync). The
    state, the rays and the draws live on ``device``.

    Under ``group`` the draws are the global batch's (``batch_size`` rays);
    :meth:`loss_and_grad` runs on this rank's rows of them and its metrics
    and gradients are this rank's, and :meth:`apply` averages the gradients
    over the ranks before the update.

    ``graphs``, which :func:`make_fused_train_step` gives its step, replays
    a call's :meth:`loss_and_grad` work on the card from CUDA graphs (the
    module's docstring); ``captures`` and ``replays`` count how often it
    captured and replayed them."""

    def __init__(self, loss_fn: LossFn, cfg: NerfTrainConfig, device: DeviceLike = None,
                 group: DataGroup = DataGroup()):
        self.loss_fn, self.cfg, self.group = loss_fn, cfg, group
        self.device = resolve_device(device)
        group.local_size(cfg.batch_size)  # refuses a batch the group does not split
        self.graphs: Optional[StepGraphs] = None

    @property
    def captures(self) -> int:
        return 0 if self.graphs is None else self.graphs.captures

    @property
    def replays(self) -> int:
        return 0 if self.graphs is None else self.graphs.replays

    def draw(self, n_rays: int, generator: Optional[torch.Generator] = None) -> StepDraws:
        c = self.cfg
        b, nc, nf = c.batch_size, c.n_samples, c.n_fine_eval
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
        (coarse then fine, in ``parameters()`` order), before any update;
        under a group, of this rank's rows of ``draws``."""
        return loss_and_grad(*self._phases(coarse, fine, rays_o, rays_d, rgb_gt),
                             _draw_tensors(draws))

    def _phases(self, coarse: NerfMLP, fine: NerfMLP, rays_o: torch.Tensor,
                rays_d: torch.Tensor, rgb_gt: torch.Tensor) -> Tuple[Forward, Grads]:
        """The step's forward of the draws' fields and its gradients."""
        return (lambda *d: self._forward(coarse, fine, rays_o, rays_d, rgb_gt, StepDraws(*d)),
                lambda loss: self._grads(coarse, fine, loss))

    def _forward(self, coarse: NerfMLP, fine: NerfMLP, rays_o: torch.Tensor,
                 rays_d: torch.Tensor, rgb_gt: torch.Tensor, draws: StepDraws
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The loss and the detached metrics of this rank's rows."""
        draws = StepDraws(*(self.group.rows(t) for t in _draw_tensors(draws)))
        idx = draws.idx
        loss_c, loss_f = self.loss_fn(coarse, fine, rays_o[idx], rays_d[idx], rgb_gt[idx],
                                      draws)
        loss = loss_c + loss_f
        loss_c, loss_f = loss_c.detach(), loss_f.detach()
        return loss, {"loss": loss.detach(), "loss_coarse": loss_c, "loss_fine": loss_f,
                      "psnr": mse2psnr(loss_c), "psnr_fine": mse2psnr(loss_f)}

    @staticmethod
    def _grads(coarse: NerfMLP, fine: NerfMLP, loss: torch.Tensor) -> List[torch.Tensor]:
        return list(torch.autograd.grad(loss, list(coarse.parameters())
                                        + list(fine.parameters())))

    def apply(self, state: NerfTrainState, grads: List[torch.Tensor]) -> None:
        """One optimizer update, or one micro-step of ``steps_per_opt``; the
        gradients (the micro-steps' mean) are averaged over the group's
        ranks once per update."""
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
        self.group.all_reduce_mean_(grads)
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
            with span("tgtc.step.draw"):
                draws = self.draw(rays_o.shape[0], generator)
        if self.graphs is not None and rays_o.is_cuda:
            key = (state.coarse, state.fine,
                   *((id(t), t.data_ptr(), t.shape, t.stride(), t.dtype, t.device)
                     for t in (rays_o, rays_d, rgb_gt)),
                   (self.group.rank, self.group.world))
            metrics, grads = self.graphs(key, _draw_tensors(draws),
                                         *self._phases(state.coarse, state.fine, rays_o,
                                                       rays_d, rgb_gt))
        else:
            metrics, grads = self.loss_and_grad(state.coarse, state.fine, rays_o, rays_d,
                                                rgb_gt, draws)
        with span("tgtc.step.optimizer"):
            self.apply(state, grads)
            state.step += 1
        return state, metrics


def make_train_step(train_cfg: NerfTrainConfig, device: DeviceLike = None,
                    group: DataGroup = DataGroup()) -> TrainStep:
    """The eager Phase-A step on ``device`` (default the card): autograd
    through ``render_rays`` in each trunk's ``compute_dtype``; over
    ``group``'s processes (see :class:`TrainStep`). It stays eager on the
    card too, without :class:`~tgtc_torch.train.graphs.StepGraphs`: it
    serves every trunk and render setting, whose capture no test holds to
    the eager step, and it is the eager step the fused one is checked
    against on the card."""
    train_cfg.n_fine_eval  # checks the budget
    settings = train_cfg.render_settings(perturb=True)

    def loss_fn(coarse, fine, b_o, b_d, b_rgb, dr: StepDraws):
        out = render_rays(coarse, fine, b_o, b_d, settings, perturb_u=dr.perturb_u,
                          noise_coarse=dr.noise_coarse, noise_fine=dr.noise_fine)
        return img2mse(out["coarse"].rgb, b_rgb), img2mse(out["fine"].rgb, b_rgb)

    return TrainStep(loss_fn, train_cfg, device, group)


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
                          device: DeviceLike = None,
                          group: DataGroup = DataGroup()) -> TrainStep:
    """The Phase-A step on the fused trunk, on ``device`` (default the
    card): both passes run K1 forward under autograd and K3 backward (their
    plain twins for CPU tensors), replayed from CUDA graphs on the card;
    over ``group``'s processes (see :class:`TrainStep`)."""
    if not fused_train_supported(nerf_cfg, fine_cfg):
        raise ValueError(
            "make_fused_train_step preconditions not met (relu trunk, use_viewdir, "
            "skips=(4,), fine dims == coarse dims, width 256 with 10/4 frequencies) "
            "— check fused_train_supported() before calling, or use make_train_step()")
    s = train_cfg
    s.n_fine_eval  # checks the budget
    budget = s.train_fine_budget
    kw = dict(depth=nerf_cfg.depth, num_freq_coor=nerf_cfg.embed_freq_coor,
              num_freq_dir=nerf_cfg.embed_freq_dir, skip=nerf_cfg.skips[0],
              width=nerf_cfg.width)

    def run_pass(model, b_o, b_d, ts, noise, deltas=None):
        r, n = ts.shape
        packed = pack_nerf_params_traceable(dict(model.named_parameters()), **kw)
        pt, dt = _points_t(b_o, b_d, ts)
        rgb_t, sigma_t = fused_nerf_apply_diff(packed, pt, dt)
        sigma = sigma_t.reshape(r, n)
        return alpha_composite(rgb_t.reshape(3, r, n).permute(1, 2, 0), sigma, ts,
                               noise_std=s.sigma_noise_std, noise=noise,
                               white_bkgd=s.white_bkgd, deltas=deltas), sigma

    def loss_fn(coarse, fine, b_o, b_d, b_rgb, dr: StepDraws):
        _, ts = sample_along_rays_uniform(b_o, b_d, s.n_samples, near=s.near, far=s.far,
                                          u=dr.perturb_u)
        comp_c, sigma_c = run_pass(coarse, b_o, b_d, ts, dr.noise_coarse)
        # the fine depths are not differentiated (stop_gradient in JAX)
        _, ts_f = merge_and_resample_fine(b_o, b_d, ts, comp_c.weights.detach(),
                                          s.n_samples_fine)
        deltas_f = None
        if budget is not None:
            # scored from the raw (pre-noise) coarse σ; no grid=: perturbed depths
            ts_f, deltas_f = select_sample_budget(ts_f, ts, sigma_c.detach(), budget)
        comp_f, _ = run_pass(fine, b_o, b_d, ts_f, dr.noise_fine, deltas_f)
        return img2mse(comp_c.rgb, b_rgb), img2mse(comp_f.rgb, b_rgb)

    step = TrainStep(loss_fn, train_cfg, device, group)
    step.graphs = StepGraphs()
    return step


# ---------------------------------------------------------------- rendering


def make_render_fn(train_cfg: NerfTrainConfig, group: Optional[DataGroup] = None,
                   block: int = 65536):
    """Eager full-precision render of a flat ray block (no noise, no jitter):
    ``(coarse, fine, rays_o, rays_d) -> {rgb, rgb_coarse, t_exp, acc}``.

    With ``group`` (the JAX package's ``mesh=``, tgtc/train/nerf_trainer.py:209)
    the call's rays are rendered in ``block``-ray blocks over the group's
    processes by :func:`~tgtc_torch.render.fast.render_in_blocks`: whole
    blocks of the 1-process block grid on each rank, so the rows equal
    :func:`render_image`'s at the same ``block`` bit for bit, on every
    rank."""
    settings = train_cfg.render_settings(perturb=False)

    @torch.no_grad()
    def render_fn(coarse: NerfMLP, fine: NerfMLP, rays_o: torch.Tensor,
                  rays_d: torch.Tensor) -> Dict[str, torch.Tensor]:
        out = render_rays(coarse, fine, rays_o, rays_d, settings)
        return {"rgb": out["fine"].rgb, "rgb_coarse": out["coarse"].rgb,
                "t_exp": out["fine"].t_exp, "acc": out["fine"].acc}

    if group is None:
        return render_fn
    return lambda coarse, fine, rays_o, rays_d: render_in_blocks(
        lambda bo, bd, start: render_fn(coarse, fine, bo, bd), rays_o, rays_d, block, group)


def render_image(render_fn, coarse: NerfMLP, fine: NerfMLP, rays_o: torch.Tensor,
                 rays_d: torch.Tensor, block: int = 65536) -> Dict[str, torch.Tensor]:
    """Any ray count by fixed-size blocks; the tail block is padded with zero
    origins and unit directions (:func:`~tgtc_torch.render.fast.render_in_blocks`)."""
    return render_in_blocks(lambda bo, bd, start: render_fn(coarse, fine, bo, bd), rays_o,
                            rays_d, block)


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
    ckpt_dir: str = "nerf_ckpt",
    max_to_keep: int = 3,
    fused: bool = True,
    reload: bool = True,
    profile_dir: str = "",
    budget_schedule: str = "",
    group: DataGroup = DataGroup(),
) -> Tuple[NerfTrainState, Dict[str, list]]:
    """Phase A on ``scene`` (an ``LlffScene``) up to ``steps`` steps,
    resuming from the latest checkpoint under ``out_dir/ckpt_dir`` (unless
    ``reload`` is False), which keeps the newest ``max_to_keep``. The fine
    budget follows ``budget_schedule`` alone (the ``--train_fine_budget``
    grammar of :func:`parse_budget_schedule`, a fixed budget being ``"N"``:
    one step function a budget, switched at the segment boundaries);
    ``train_cfg.train_fine_budget`` must be None.

    The step is fused (K1 + K3) exactly when ``fused`` is set, the device is
    a card and :func:`fused_train_supported` holds, else eager; the fused
    step replays from CUDA graphs that each budget segment captures anew
    (:class:`TrainStep`). The host
    syncs with the device only at log steps (every ``i_print`` steps and the
    last; one fetch of the window's losses and the metrics) and checkpoint
    steps (every :data:`CKPT_EVERY` steps and the last, saved asynchronously;
    the last save is waited for). Logs go to ``out_dir/logs/nerf.jsonl``.
    With ``profile_dir`` the first 20 steps of this run are traced by
    ``torch.profiler`` into ``profile_dir/phase_a.json`` (a Chrome trace),
    each step's phases named by the spans ``tgtc.step.draw``, ``.forward``,
    ``.backward`` and ``.optimizer`` (:data:`~tgtc_torch.utils.logging.SPANS`).
    Returns the state and ``{"loss": [every step's loss], "records":
    [logged lines]}``; a record is its JSONL line, step included, and its
    ``steps_per_s`` covers the steps since the previous record.

    Over ``group``'s processes every rank calls this with the same
    arguments: rank 0's parameters are broadcast once, each step runs on
    the rank's rows of the global batch (:class:`TrainStep`), the logged
    losses are averaged over the ranks at log steps (the PSNRs taken from
    the averaged losses), rank 0 alone writes the checkpoints, the log and
    the trace, and every rank waits at the end until the last checkpoint is
    on disk.
    """
    if train_cfg.train_fine_budget is not None:
        raise ValueError("train_nerf takes its fine budget from budget_schedule "
                         f"(e.g. '{train_cfg.train_fine_budget}'), not from train_cfg")
    segments = parse_budget_schedule(budget_schedule)
    dev = resolve_device(device)
    if not is_main_process():
        print_fn = None
    state = init_state(torch.Generator().manual_seed(seed), nerf_cfg, train_cfg, fine_cfg,
                       device=dev)
    ckpt = CheckpointManager(os.path.join(out_dir, ckpt_dir), max_to_keep=max_to_keep)
    if reload and ckpt.latest_step() is not None:
        state.load_state_dict(ckpt.restore(map_location=dev))
    group.broadcast_([p.detach() for p in state.parameters()])
    history: Dict[str, list] = {"loss": [], "records": []}
    if state.step >= steps:
        ckpt.close()
        return state, history

    h, w, _ = scene.hwf
    ro, rd = rays_for_poses(h, w, scene.intrinsics, scene.poses, use_ndc=use_ndc,
                            pixel_alignment=pixel_alignment, device=dev)
    rays_o, rays_d = ro.reshape(-1, 3), rd.reshape(-1, 3)
    rgb_gt = torch.as_tensor(scene.images, dtype=torch.float32).reshape(-1, 3).to(dev)

    use_fused = fused and dev.type == "cuda" and fused_train_supported(nerf_cfg, fine_cfg)
    if print_fn is not None:
        print_fn(f"[train] {'fused trunk (K1 + K3)' if use_fused else 'eager'} step, "
                 f"{rays_o.shape[0]} rays on {dev}"
                 + (f"; fine-budget schedule {segments}" if budget_schedule else ""))
    step_fns: Dict[Optional[int], TrainStep] = {}

    def step_for(budget: Optional[int]) -> TrainStep:
        if budget not in step_fns:
            # a schedule only tightens, so a segment left is not met again: drop its
            # step, whose graphs hold device memory
            step_fns.clear()
            tc = dataclasses.replace(train_cfg, train_fine_budget=budget)
            step_fns[budget] = (make_fused_train_step(nerf_cfg, tc, fine_cfg, dev, group)
                                if use_fused else make_train_step(tc, dev, group))
        return step_fns[budget]

    logger = MetricsLogger(os.path.join(out_dir, "logs"), name="nerf", print_fn=print_fn)
    timer = SegmentTimer()
    gen = torch.Generator(device=dev)
    step = last_log = last_ckpt = state.step
    window: List[torch.Tensor] = []
    t_log = time.perf_counter()
    prof = _start_profile(dev) if profile_dir and is_main_process() else None
    first = step
    timer.start("model")
    try:
        while step < steps:
            gen.manual_seed(step_seed(seed, step))
            step_fn = step_for(budget_at_step(segments, step)[0])
            state, metrics = step_fn(state, rays_o, rays_d, rgb_gt, generator=gen)
            step = state.step
            window.append(metrics["loss"])
            if prof is not None and (step - first >= PROFILE_STEPS or step >= steps):
                _stop_profile(prof, profile_dir)
                prof = None
            if step // i_print > last_log // i_print or step >= steps:
                timer.start("log")
                keys = list(metrics)
                vals = torch.stack(window + [metrics[k].float().reshape(()) for k in keys])
                vals = group.all_reduce_mean_([vals])[0].cpu().tolist()
                history["loss"] += vals[:len(window)]
                m = dict(zip(keys, vals[len(window):]))
                if group.world > 1:  # the PSNRs of the averaged losses
                    m["psnr"], m["psnr_fine"] = (float(mse2psnr(torch.tensor(m[k])))
                                                 for k in ("loss_coarse", "loss_fine"))
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
        if prof is not None:
            prof.__exit__(None, None, None)
        timer.stop()
        logger.close()
        ckpt.close()
    group.barrier()  # the last checkpoint is on disk for every rank
    return state, history


def _start_profile(dev: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    return prof


def _stop_profile(prof, profile_dir: str) -> None:
    """End the trace (after a device sync) and write it as a Chrome trace."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "phase_a.json"))
