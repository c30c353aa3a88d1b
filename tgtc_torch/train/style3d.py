"""Phase E — 3D style-field distillation — port of tgtc/train/style3d.py and
of the Phase-E loop of ``Pipeline.train_style3d``
(tgtc/train/pipeline.py:719-863).

One step, one backward of one scalar:

* two streams, main and coherent (:mod:`tgtc_torch.data.style_dataset`),
  each through the coarse and the fine stylized pass of
  :func:`~tgtc_torch.render.style.style_forward` (the frozen trunk runs
  under ``no_grad``; fine depths from ``merge_and_resample_fine`` with no
  jitter);
* ``loss_rgb`` (coarse + fine MSE against the stylized frames),
  ``loss_logp`` (the latent prior, decayed every 1,000 steps past
  ``origin_step``) and the coherence loss
  ``‖cos(styled_t, styled_{t-1}) − cos(orig_t, orig_{t-1})‖`` on the
  coherent stream against the previous step's buffers, zero at the cycle's
  first and reset steps and dropped past ``coh_until_step``;
* the coherent stream looks its latents up in a detached table, so the
  coherence gradient reaches the style MLPs only and the latent table
  learns from the main stream alone, as the reference's two backward
  passes have it;
* Adam(0.9, 0.999, eps 1e-8) in two parameter groups: ``lrate`` on the
  concat and style MLPs, ``latent_lrate`` on the latent table (optax's
  ``multi_transform`` of two ``adam``; the same update, bias correction
  included).

Every random site takes an explicit tensor (:class:`StyleStepDraws`: the
main ids, the coherent pixel ids, each stream's coarse jitter and σ
noise), so the tests can feed JAX's draws; otherwise the step draws them
from a generator seeded from (seed, step) by
:func:`~tgtc_torch.utils.seeds.step_seed`, and the coherent pixels from
(seed, style_start, block). The stream counters and the step are host ints,
so a step never waits for the device. The step itself runs no hand-written
kernel: the JAX step reaches no Pallas call either (it uses the XLA
``style_forward``); Phase F renders the trained field on K4/K5.

``fine_budget``: the fine pass evaluates only each ray's budget of merged
samples (``ops.sampling.select_sample_budget`` on the raw coarse σ of the
frozen trunk; no ``grid=``, the coarse depths are perturbed), so the fine
noise is ``[B, fine_budget]``.

Over several processes (``group=``, a :class:`~tgtc_torch.parallel.DataGroup`,
the counterpart of the JAX step's ``mesh=``, which shards both streams):
every rank draws the global :class:`StyleStepDraws` and keeps its rows of
both streams, the coherence buffers hold the rank's rows, and the gradients
are averaged over the ranks before the update. ``loss_rgb`` and
``loss_logp`` are means over the rays, so the mean of the ranks' gradients
is the global one. The coherence loss is not: ``l2_norm`` is the root of a
sum over the **whole** batch, which XLA computes globally under the mesh.
Each rank reduces its partial sums of squares ``S_r`` before the root and
takes the detached global ``√S`` as the term's value, with the local
gradient ``W · ∂S_r / (2√S)``: the mean all-reduce then sums the ranks'
parts into ``∂√S``. The W-process step is the 1-process step at the same
global batch; rank 0 alone writes the checkpoints (with the buffers gathered
to the global batch) and the log.

Not ported: ``k_steps > 1`` (a ``lax.scan`` that amortizes the TPU's
dispatch: the port runs plain steps).
"""

from __future__ import annotations

import copy
import dataclasses
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch

from tgtc_torch.config import Config
from tgtc_torch.data.style_dataset import (
    StyleSceneData,
    advance_coh_counters,
    coh_pixel_ids,
    gather_coh_batch,
    gather_main_batch,
    load_style_scene,
)
from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.models.nerf import NerfMLP
from tgtc_torch.models.style_field import (
    StyleFieldConfig,
    StyleMLPBeforeConcat,
    StyleMLPWildMultilayers,
    init_latents,
    latent_minus_logp,
    make_style_mlps,
)
from tgtc_torch.ops.losses import cosine_similarity, img2mse, l2_norm
from tgtc_torch.ops.sampling import (
    merge_and_resample_fine,
    sample_along_rays_uniform,
    select_sample_budget,
)
from tgtc_torch.parallel import DataGroup, is_main_process
from tgtc_torch.render.style import style_forward
from tgtc_torch.train.checkpoint import CheckpointManager
from tgtc_torch.utils.logging import MetricsLogger, span
from tgtc_torch.utils.seeds import step_seed

CKPT_EVERY = 500  # steps between Phase-E checkpoints (tgtc/train/pipeline.py:857)
# ||grad(λ·coh)|| / ||grad(rgb)|| above this is the saturation regime: the
# coherence term owns the update and the field's rgb quality dies
COH_RATIO_WARN = 10.0
LOSSES = ("loss", "loss_rgb", "loss_logp", "loss_coh")


@dataclasses.dataclass(frozen=True)
class StyleTrainConfig:
    batch_size: int = 256           # reference --batch_size_style
    n_samples: int = 64
    n_samples_fine: int = 64
    near: float = 0.0
    far: float = 1.0
    sigma_noise_std: float = 1.0
    lrate: float = 5e-4
    latent_lrate: float = 1e-3
    rgb_loss_lambda: float = 1.0
    logp_loss_lambda: float = 0.1
    logp_loss_decay: float = 1.0
    loss_coh_lambda: float = 1e2    # fern config value
    sigma_scale: float = 1.0
    llff_tile: bool = True
    origin_step: int = 120001
    coh_until_step: int = 122000    # the reference's hardcoded gate
    dataset_type: str = "llff"
    fine_budget: Optional[int] = None  # fine samples a ray kept (None: all)

    @property
    def tile(self) -> bool:
        return self.llff_tile and self.dataset_type == "llff"


@dataclasses.dataclass
class StyleTrainState:
    """The counterpart of the JAX ``StyleTrainState``: the step and the
    stream counters (host ints), both style MLPs, the latent table (a leaf
    tensor) with the frozen per-style ``mu``/``logvar``, the optimizer and
    the coherence buffers (the previous step's coherent coarse and fine
    styled rgb and its origin rgb, ``[B, 3]``, or a process's rows of them
    under a group; the state dict holds the whole batch's)."""

    step: int
    concat: StyleMLPBeforeConcat
    style: StyleMLPWildMultilayers
    latents: torch.Tensor
    mu: torch.Tensor
    logvar: torch.Tensor
    optimizer: torch.optim.Adam
    coh_x: torch.Tensor
    coh_y: torch.Tensor
    coh_x_origin: torch.Tensor
    cnt: int = 0
    style_start: int = 0
    frame_start: int = 0
    block: int = 0
    start: int = 0

    def style_parameters(self) -> List[torch.nn.Parameter]:
        return list(self.concat.parameters()) + list(self.style.parameters())

    def parameters(self) -> List[torch.Tensor]:
        return self.style_parameters() + [self.latents]

    def latent_state(self, detach: bool = False) -> Dict[str, torch.Tensor]:
        lat = self.latents.detach() if detach else self.latents
        return {"latents": lat, "mu": self.mu, "logvar": self.logvar}

    def state_dict(self, group: DataGroup = DataGroup()) -> Dict[str, Any]:
        """The state, with the coherence buffers gathered from ``group``'s
        ranks (a collective: every rank calls it)."""
        g = group.gather_rows
        return {"step": self.step, "concat": self.concat.state_dict(),
                "style": self.style.state_dict(), "latents": self.latents.detach(),
                "mu": self.mu, "logvar": self.logvar, "optimizer": self.optimizer.state_dict(),
                "coh_x": g(self.coh_x), "coh_y": g(self.coh_y),
                "coh_x_origin": g(self.coh_x_origin), "cnt": self.cnt,
                "style_start": self.style_start, "frame_start": self.frame_start,
                "block": self.block, "start": self.start}

    def load_state_dict(self, sd: Dict[str, Any], group: DataGroup = DataGroup()) -> None:
        """Load ``sd``, keeping ``group``'s rank's rows of the buffers."""
        dev = self.latents.device
        self.concat.load_state_dict(sd["concat"])
        self.style.load_state_dict(sd["style"])
        with torch.no_grad():
            self.latents.copy_(sd["latents"])
        self.optimizer.load_state_dict(sd["optimizer"])
        for k in ("mu", "logvar"):
            setattr(self, k, sd[k].to(dev))
        for k in ("coh_x", "coh_y", "coh_x_origin"):
            setattr(self, k, group.rows(sd[k].to(dev)))
        for k in ("step", "cnt", "style_start", "frame_start", "block", "start"):
            setattr(self, k, int(sd[k]))


def make_style_optimizer(cfg: StyleTrainConfig, style_params, latents: torch.Tensor
                         ) -> torch.optim.Adam:
    """Adam with two groups: ``lrate`` on the style MLPs (group 0) and
    ``latent_lrate`` on the latent table (group 1)."""
    return torch.optim.Adam([{"params": list(style_params), "lr": cfg.lrate},
                             {"params": [latents], "lr": cfg.latent_lrate}],
                            betas=(0.9, 0.999), eps=1e-8)


def init_style_state(generator: Optional[torch.Generator], field_cfg: StyleFieldConfig,
                     train_cfg: StyleTrainConfig, style_num: int, frame_num: int,
                     latents_init: Optional[Dict[str, torch.Tensor]] = None,
                     device: DeviceLike = None, group: DataGroup = DataGroup()
                     ) -> StyleTrainState:
    """Both style MLPs drawn from ``generator`` on ``device`` (the card
    unless told otherwise), the latent table from ``latents_init`` (Phase
    D's seeding) or drawn after them, the step at ``origin_step``; the
    coherence buffers are ``group``'s rank's rows."""
    dev = resolve_device(device)
    concat, style = make_style_mlps(field_cfg, generator, device=dev)
    lat = latents_init or init_latents(generator, style_num, frame_num, field_cfg.latent_dim,
                                       device=dev)
    latents = lat["latents"].detach().to(dev).clone().requires_grad_(True)
    b = group.local_size(train_cfg.batch_size)
    zeros = lambda: torch.zeros((b, 3), device=dev)
    return StyleTrainState(
        step=train_cfg.origin_step, concat=concat, style=style, latents=latents,
        mu=lat["mu"].detach().to(dev), logvar=lat["logvar"].detach().to(dev),
        optimizer=make_style_optimizer(train_cfg, list(concat.parameters())
                                       + list(style.parameters()), latents),
        coh_x=zeros(), coh_y=zeros(), coh_x_origin=zeros())


# ---------------------------------------------------------------- the step


@dataclasses.dataclass
class StyleStepDraws:
    """One step's random numbers: the main stream's flat ids ``[B]``, the
    coherent stream's pixel ids ``[B]``, and per stream the coarse jitter
    ``[B, Nc]`` in [0, 1) and the standard-normal σ noise ``[B, Nc]`` and
    ``[B, Nc + Nf]`` or ``[B, fine_budget]`` (None when ``sigma_noise_std``
    is 0)."""

    main_ids: torch.Tensor
    coh_pix: torch.Tensor
    u_main: torch.Tensor
    u_coh: torch.Tensor
    noise_main: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None)
    noise_coh: Tuple[Optional[torch.Tensor], Optional[torch.Tensor]] = (None, None)


class StyleTrainStep:
    """``step(state, data, draws=None, seed=0) -> (state, metrics)``: one
    Phase-E update of ``state`` in place on the scene ``data``. Metrics are
    0-d device tensors (no sync).

    Under ``group`` the draws are the global batch's; :meth:`losses` and
    :meth:`loss_and_grad` run on this rank's rows of them (their metrics and
    gradients are this rank's; the coherence loss is the global one) and
    :meth:`apply` averages the gradients over the ranks."""

    def __init__(self, nerf_coarse: NerfMLP, nerf_fine: NerfMLP, cfg: StyleTrainConfig,
                 group: DataGroup = DataGroup()):
        m = cfg.n_samples + cfg.n_samples_fine
        if cfg.fine_budget is not None and not 0 < cfg.fine_budget <= m:
            raise ValueError(f"fine_budget {cfg.fine_budget} not in (0, {m}]")
        group.local_size(cfg.batch_size)  # refuses a batch the group does not split
        self.nerf_coarse, self.nerf_fine, self.cfg = nerf_coarse, nerf_fine, cfg
        self.group = group
        self._generator: Optional[torch.Generator] = None

    def draw(self, data: StyleSceneData, state: StyleTrainState, seed: int = 0
             ) -> StyleStepDraws:
        """The step's draws from a generator seeded from ``(seed,
        state.step)``; the coherent pixels from ``(seed, style_start,
        block)``."""
        c, dev = self.cfg, data.images.device
        if self._generator is None or self._generator.device != dev:
            self._generator = torch.Generator(device=dev)
        gen = self._generator.manual_seed(step_seed(seed, state.step))
        b, nc = c.batch_size, c.n_samples
        nf = c.fine_budget or c.n_samples + c.n_samples_fine
        h, w = data.hw
        kw = dict(generator=gen, device=dev)
        main_ids = torch.randint(0, data.style_num * data.frame_num * h * w, (b,), **kw)
        u_main, u_coh = torch.rand((b, nc), **kw), torch.rand((b, nc), **kw)
        noise = lambda: ((torch.randn((b, nc), **kw), torch.randn((b, nf), **kw))
                         if c.sigma_noise_std > 0 else (None, None))
        noise_main, noise_coh = noise(), noise()
        coh_pix = coh_pixel_ids(data, state.style_start, state.block, b, seed)
        return StyleStepDraws(main_ids, coh_pix, u_main, u_coh, noise_main, noise_coh)

    def two_pass(self, state: StyleTrainState, batch: Dict[str, torch.Tensor], u: torch.Tensor,
                 noise, detach_latents: bool) -> Tuple[torch.Tensor, torch.Tensor]:
        """One stream's coarse and fine stylized rgb ``[B, 3]``."""
        c = self.cfg
        lat = state.latent_state(detach=detach_latents)
        ro, rd, sid, fid = batch["rays_o"], batch["rays_d"], batch["style_id"], batch["frame_id"]
        kw = dict(sigma_scale=c.sigma_scale, llff_tile=c.tile, noise_std=c.sigma_noise_std)
        _, ts = sample_along_rays_uniform(ro, rd, c.n_samples, near=c.near, far=c.far, u=u)
        comp_c, weights, sigma_c = style_forward(self.nerf_coarse, state.concat, state.style,
                                                 lat, ro, rd, ts, sid, fid, noise=noise[0],
                                                 with_sigma=True, **kw)
        _, ts_f = merge_and_resample_fine(ro, rd, ts, weights, c.n_samples_fine)
        deltas_f = None
        if c.fine_budget is not None:
            ts_f, deltas_f = select_sample_budget(ts_f, ts, sigma_c, c.fine_budget)
        comp_f, _ = style_forward(self.nerf_fine, state.concat, state.style, lat, ro, rd, ts_f,
                                  sid, fid, noise=noise[1], deltas=deltas_f, **kw)
        return comp_c.rgb, comp_f.rgb

    def local_draws(self, draws: StyleStepDraws) -> StyleStepDraws:
        """This rank's rows of the global ``draws``."""
        r = self.group.rows
        return StyleStepDraws(r(draws.main_ids), r(draws.coh_pix), r(draws.u_main),
                              r(draws.u_coh), tuple(map(r, draws.noise_main)),
                              tuple(map(r, draws.noise_coh)))

    def coherence_norms(self, diffs: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """``l2_norm`` of each of the two ``diffs`` over the global batch,
        summed (a rank's rows of them under a group: see the module's
        docstring)."""
        g = self.group
        if not g.active:
            return l2_norm(diffs[0]) + l2_norm(diffs[1])
        part = torch.stack([torch.sum(d ** 2) for d in diffs])
        root = torch.sqrt(g.all_reduce_sum(part.detach()) + 1e-8)
        return (root + g.world * (part - part.detach()) / (2.0 * root)).sum()

    def losses(self, state: StyleTrainState, data: StyleSceneData, draws: StyleStepDraws
               ) -> Dict[str, torch.Tensor]:
        """The step's loss terms (differentiable), the coherence scale it
        applies (``coh_scale``: λ_coh before ``coh_until_step``, else 0),
        the coherent stream's rgb and its origin rgb; under a group, on this
        rank's rows of ``draws``."""
        c = self.cfg
        draws = self.local_draws(draws)
        main = gather_main_batch(data, len(draws.main_ids), idx=draws.main_ids)
        coh = gather_coh_batch(data, state.style_start, state.frame_start, state.block,
                               len(draws.coh_pix), pix=draws.coh_pix)
        rgb_c, rgb_f = self.two_pass(state, main, draws.u_main, draws.noise_main, False)
        gt = main["rgb_gt"]
        loss_rgb = c.rgb_loss_lambda * (img2mse(rgb_c, gt) + img2mse(rgb_f, gt))
        logp_lambda = c.logp_loss_lambda * c.logp_loss_decay ** (
            (state.step - c.origin_step) // 1000)
        loss_logp = logp_lambda * latent_minus_logp(state.latent_state(), main["style_id"],
                                                    main["frame_id"], c.sigma_scale, c.tile)
        # latents detached: the coherence gradient reaches the style MLPs only
        rgb_c2, rgb_f2 = self.two_pass(state, coh, draws.u_coh, draws.noise_coh, True)
        if state.cnt != 0 and state.cnt != data.frame_num:
            origin = cosine_similarity(coh["rgb_origin"], state.coh_x_origin)
            loss_coh = self.coherence_norms((cosine_similarity(rgb_c2, state.coh_x) - origin,
                                             cosine_similarity(rgb_f2, state.coh_y) - origin))
        else:
            loss_coh = rgb_c2.new_zeros(())
        coh_scale = c.loss_coh_lambda if state.step <= c.coh_until_step else 0.0
        return {"loss_rgb": loss_rgb, "loss_logp": loss_logp, "loss_coh": loss_coh,
                "coh_scale": coh_scale, "rgb_c2": rgb_c2, "rgb_f2": rgb_f2,
                "rgb_origin": coh["rgb_origin"]}

    def loss_and_grad(self, state: StyleTrainState, data: StyleSceneData, draws: StyleStepDraws
                      ) -> Tuple[Dict[str, torch.Tensor], List[torch.Tensor],
                                 Dict[str, torch.Tensor]]:
        """Metrics, the gradients of ``state.parameters()`` (the style MLPs,
        then the latent table) before any update, and the terms of
        :meth:`losses`."""
        with span("tgtc.step.forward"):
            t = self.losses(state, data, draws)
            total = t["loss_rgb"] + t["loss_logp"]
            if t["coh_scale"]:
                total = total + t["coh_scale"] * t["loss_coh"]
            metrics = {"loss": total.detach(), **{k: t[k].detach() for k in LOSSES[1:]}}
        with span("tgtc.step.backward"):
            grads = torch.autograd.grad(total, state.parameters())
        return metrics, list(grads), t

    def grad_norms(self, state: StyleTrainState, data: StyleSceneData, draws: StyleStepDraws
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``(‖∇ loss_rgb‖, coh_scale · ‖∇ loss_coh‖)`` over every trained
        parameter, each from its own ``torch.autograd.grad`` (the coherence
        diagnostic), the gradients averaged over the group's ranks first."""
        t = self.losses(state, data, draws)
        params = state.parameters()
        norm = lambda gs: torch.sqrt(sum((g.double() ** 2).sum() for g in gs if g is not None))
        g_rgb = torch.autograd.grad(t["loss_rgb"], params, retain_graph=True, allow_unused=True)
        g_rgb = self.group.all_reduce_mean_(g_rgb)
        if not t["loss_coh"].requires_grad:  # inactive at this step: zero gradient
            return norm(g_rgb), torch.zeros((), dtype=torch.float64, device=t["loss_coh"].device)
        g_coh = self.group.all_reduce_mean_(
            torch.autograd.grad(t["loss_coh"], params, allow_unused=True))
        return norm(g_rgb), t["coh_scale"] * norm(g_coh)

    def apply(self, state: StyleTrainState, data: StyleSceneData, grads: List[torch.Tensor],
              terms: Dict[str, torch.Tensor]) -> None:
        """The update (the gradients averaged over the group's ranks), the
        coherence buffers and the counters."""
        self.group.all_reduce_mean_(grads)
        for p, g in zip(state.parameters(), grads):
            p.grad = g
        state.optimizer.step()
        state.optimizer.zero_grad(set_to_none=True)
        state.coh_x = terms["rgb_c2"].detach()
        state.coh_y = terms["rgb_f2"].detach()
        state.coh_x_origin = terms["rgb_origin"]
        state.cnt = 1 if state.cnt == data.frame_num else state.cnt + 1
        h, w = data.hw
        (state.style_start, state.frame_start, state.block, state.start) = advance_coh_counters(
            state.style_start, state.frame_start, state.block, state.start, data.style_num,
            data.frame_num, self.cfg.batch_size, h * w)
        state.step += 1

    def __call__(self, state: StyleTrainState, data: StyleSceneData,
                 draws: Optional[StyleStepDraws] = None, seed: int = 0
                 ) -> Tuple[StyleTrainState, Dict[str, torch.Tensor]]:
        if draws is None:
            with span("tgtc.step.draw"):
                draws = self.draw(data, state, seed)
        metrics, grads, terms = self.loss_and_grad(state, data, draws)
        with span("tgtc.step.optimizer"):
            self.apply(state, data, grads, terms)
        return state, metrics


def make_style_train_step(nerf_coarse: NerfMLP, nerf_fine: NerfMLP, cfg: StyleTrainConfig,
                          group: DataGroup = DataGroup()) -> StyleTrainStep:
    """The Phase-E step on the trunks' device, over ``group``'s processes."""
    return StyleTrainStep(nerf_coarse, nerf_fine, cfg, group)


def coherence_grad_ratio(step_fn: StyleTrainStep, state: StyleTrainState,
                         data: StyleSceneData, seed: int = 0,
                         draws: Optional[Tuple[StyleStepDraws, StyleStepDraws]] = None
                         ) -> Tuple[float, float, float]:
    """The rgb-vs-coherence gradient-norm ratio at Phase-E start: one
    scratch step on a deep copy of ``state`` and its optimizer (the
    coherence stream needs one step of buffers), then the two terms'
    gradient norms at the next step, with the draws the real steps take
    (or ``draws``, one per step). ``state`` and its trajectory do not
    change. Under a grouped ``step_fn`` every rank calls it and reads the
    same norms (of the averaged gradients). Returns ``(ratio,
    grad_norm_coh, grad_norm_rgb)``."""
    scratch = copy.deepcopy(state)
    first, second = draws or (None, None)
    step_fn(scratch, data, first, seed=seed)
    g_rgb, g_coh = step_fn.grad_norms(scratch, data,
                                      second or step_fn.draw(data, scratch, seed))
    g_rgb, g_coh = float(g_rgb), float(g_coh)
    return g_coh / max(g_rgb, 1e-12), g_coh, g_rgb


# ---------------------------------------------------------------- the loop


def style_train_config(cfg: Config, near: float, far: float) -> StyleTrainConfig:
    """Phase E's settings from the run configuration, as the pipeline reads
    them (``coh_until_step`` -1 is ``origin_step + 1999``; the last segment
    of ``train_fine_budget`` is the fine budget)."""
    from tgtc_torch.train.nerf_trainer import parse_budget_schedule

    return StyleTrainConfig(
        batch_size=cfg.batch_size_style, n_samples=cfg.N_samples,
        n_samples_fine=cfg.N_samples_fine, near=near, far=far,
        sigma_noise_std=cfg.sigma_noise_std, lrate=cfg.lrate,
        rgb_loss_lambda=cfg.rgb_loss_lambda, logp_loss_lambda=cfg.logp_loss_lambda,
        logp_loss_decay=cfg.logp_loss_decay, loss_coh_lambda=cfg.loss_coh_lambda,
        sigma_scale=cfg.sigma_scale, origin_step=cfg.origin_step,
        dataset_type=cfg.dataset_type,
        coh_until_step=(cfg.coh_until_step if cfg.coh_until_step >= 0
                        else cfg.origin_step + 1999),
        fine_budget=parse_budget_schedule(cfg.train_fine_budget)[-1][1])


def style_field_config(cfg: Config, nerf: NerfMLP) -> StyleFieldConfig:
    return StyleFieldConfig(style_d=cfg.style_D, width=cfg.netwidth, latent_dim=cfg.vae_latent,
                            embed_dim=nerf.cfg.input_ch)


def scene_near_far(cfg: Config, scene) -> Tuple[float, float]:
    """NDC spans [0, 1]; without NDC the scene's bounds (0.9 of the nearest)."""
    if cfg.no_ndc:
        return float(scene.bds.min()) * 0.9, float(scene.bds.max())
    return 0.0, 1.0


def run_style3d(cfg: Config, scene, gen_dir: str, stylized_dir: str, nerf_coarse: NerfMLP,
                nerf_fine: NerfMLP, vae, out_dir: str, device: DeviceLike = None,
                print_fn=print, group: DataGroup = DataGroup()
                ) -> Tuple[StyleTrainState, Dict[str, list]]:
    """Phase E as the pipeline runs it, up to ``cfg.total_step``, on
    ``device`` (the card unless told otherwise; the trunks and ``vae``, Phase
    D's trained VAE, must live there): the scene from Phase B's renders in
    ``gen_dir`` and Phase C3's output in ``stylized_dir``; the latent table
    seeded from the VAE (generator ``seed + 7``); the state drawn from ``seed
    + 8`` or restored from the newest checkpoint in ``out_dir/ckpt_style``
    (unless ``cfg.no_reload``); at ``origin_step`` the coherence diagnostic
    (printed and logged; with ``cfg.coh_lambda_auto`` it rescales λ_coh
    above :data:`COH_RATIO_WARN`); then the steps, drawn from ``seed + 9``.

    The host syncs with the device only at log steps (every ``cfg.i_print``
    steps and the last: one fetch of the window's losses) and checkpoint
    steps (every :data:`CKPT_EVERY` steps and the last, saved
    asynchronously; the last save is waited for). Logs go to
    ``out_dir/logs/style.jsonl``. Returns the state and ``{name: [every
    step's value]}`` for the four losses plus ``"records"``, the logged
    lines (``steps_per_s`` covers the steps since the previous record).

    Over ``group``'s processes every rank calls this with the same
    arguments: rank 0's style MLPs and latent table are broadcast once, each
    step runs on the rank's rows of both streams (:class:`StyleTrainStep`),
    the logged losses are averaged over the ranks at log steps, rank 0
    alone writes the checkpoints and the log, and every rank waits at the
    end until the last checkpoint is on disk."""
    dev = resolve_device(device)
    if not is_main_process():
        print_fn = None
    for model in (nerf_coarse, nerf_fine, vae):
        if next(model.parameters()).device.type != dev.type:
            raise ValueError(f"a model lives on {next(model.parameters()).device}, Phase E was "
                             f"asked for {dev}")
    from tgtc_torch.train.vae_trainer import seed_latents_from_features

    near, far = scene_near_far(cfg, scene)
    scene.near, scene.far = near, far
    data = load_style_scene(scene, gen_dir, stylized_dir, use_ndc=not cfg.no_ndc,
                            pixel_alignment=cfg.pixel_alignment, device=dev)
    lat_init = seed_latents_from_features(
        vae, data.style_features, data.frame_num,
        generator=torch.Generator().manual_seed(cfg.seed + 7))
    scfg = style_train_config(cfg, near, far)
    state = init_style_state(torch.Generator().manual_seed(cfg.seed + 8),
                             style_field_config(cfg, nerf_coarse), scfg, data.style_num,
                             data.frame_num, latents_init=lat_init, device=dev, group=group)
    ckpt = CheckpointManager(os.path.join(out_dir, "ckpt_style"), max_to_keep=cfg.ckp_num)
    if ckpt.latest_step() is not None and not cfg.no_reload:
        state.load_state_dict(ckpt.restore(map_location=dev), group)
    group.broadcast_([p.detach() for p in state.parameters()])
    history: Dict[str, list] = {**{k: [] for k in LOSSES}, "records": []}
    if state.step >= cfg.total_step:
        ckpt.close()
        return state, history

    seed = cfg.seed + 9
    logger = MetricsLogger(os.path.join(out_dir, "logs"), name="style", print_fn=print_fn)
    step_fn = make_style_train_step(nerf_coarse, nerf_fine, scfg, group)
    if scfg.loss_coh_lambda > 0 and state.step == cfg.origin_step:
        ratio, g_coh, g_rgb = coherence_grad_ratio(step_fn, state, data, seed)
        logger.log(state.step, {"coh_grad_ratio": ratio, "grad_norm_coh": g_coh,
                                "grad_norm_rgb": g_rgb}, prefix="COH DIAG")
        if ratio > COH_RATIO_WARN:
            suggested = scfg.loss_coh_lambda * COH_RATIO_WARN / ratio
            if cfg.coh_lambda_auto:
                scfg = dataclasses.replace(scfg, loss_coh_lambda=suggested)
                step_fn = make_style_train_step(nerf_coarse, nerf_fine, scfg, group)
                msg = (f"[coh-diag] coherence gradient dominates rgb {ratio:.0f}x; "
                       f"coh_lambda_auto rescaled loss_coh_lambda {cfg.loss_coh_lambda:g} -> "
                       f"{suggested:.3g}")
            else:
                msg = (f"[coh-diag] WARNING: the coherence loss gradient is {ratio:.0f}x the "
                       f"rgb gradient at Phase-E start (threshold {COH_RATIO_WARN:.0f}x); this "
                       f"regime trains a visually dead run on high-chroma scenes. Suggested: "
                       f"--loss_coh_lambda {suggested:.3g} (or set --coh_lambda_auto)")
            if print_fn is not None:
                print_fn(msg)

    step = last_log = last_ckpt = state.step
    window: List[Dict[str, torch.Tensor]] = []
    t_log = time.perf_counter()
    try:
        while step < cfg.total_step:
            state, metrics = step_fn(state, data, seed=seed)
            step = state.step
            window.append(metrics)
            if step // cfg.i_print > last_log // cfg.i_print or step >= cfg.total_step:
                vals = torch.stack([m[k].float() for m in window for k in LOSSES])
                vals = group.all_reduce_mean_([vals])[0].cpu()
                vals = vals.reshape(len(window), len(LOSSES)).T.tolist()
                for k, v in zip(LOSSES, vals):
                    history[k] += v
                m = {k: v[-1] for k, v in zip(LOSSES, vals)}
                m["steps_per_s"] = (step - last_log) / (time.perf_counter() - t_log)
                history["records"].append(
                    {"step": step, **logger.log(step, m, prefix="STYLE TRAIN")})
                window, last_log, t_log = [], step, time.perf_counter()
            if step // CKPT_EVERY > last_ckpt // CKPT_EVERY or step >= cfg.total_step:
                ckpt.save_device_async(step, state.state_dict(group),
                                       wait=step >= cfg.total_step)
                last_ckpt = step
    finally:
        logger.close()
        ckpt.close()
    group.barrier()  # the last checkpoint is on disk for every rank
    return state, history


def load_style_field(ckpt_dir: str, field_cfg: StyleFieldConfig, step: Optional[int] = None,
                     device: DeviceLike = None
                     ) -> Tuple[StyleMLPBeforeConcat, StyleMLPWildMultilayers,
                                Dict[str, torch.Tensor]]:
    """Phase F's view of a Phase-E checkpoint (the newest in ``ckpt_dir``,
    or ``step``): both style MLPs on ``device`` and the latent state
    ``{"latents", "mu", "logvar"}``, as ``Pipeline.render_stylized``
    restores them (tgtc/train/pipeline.py:870-899)."""
    dev = resolve_device(device)
    mgr = CheckpointManager(ckpt_dir)
    try:
        sd = mgr.restore(step, map_location=dev)
    finally:
        mgr.close()
    concat, style = make_style_mlps(field_cfg, torch.Generator().manual_seed(0), device=dev)
    concat.load_state_dict(sd["concat"])
    style.load_state_dict(sd["style"])
    return concat, style, {k: sd[k].to(dev) for k in ("latents", "mu", "logvar")}
