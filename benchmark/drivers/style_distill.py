"""Phase E's distillation step, driven as a closed loop
(``stylefield-fern.distill``).

The program: ``train.style3d.make_style_train_step`` (two streams, each
through the coarse and the fine stylized pass on the frozen trunks, one
backward, Adam in two groups) on a ``StyleTrainState`` at step
``resume_step`` (past the coherence gate: the coherence loss is computed,
not trained) and a ``StyleSceneData`` of the configuration's size that the
benchmark makes on the device: the training views' rays, synthetic renders
and stylized frames. Each step's draws come from a generator seeded by
(seed, step); the coherent stream's pixels from (seed, the frame cycle), so
they recur over the frames of a cycle as the program's counters walk them.
Set-up takes the first three steps through that same call and feed; the
check follows them with the plain reference.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.drivers import common as C
from benchmark.harness import traffic as T
from benchmark.harness import work as W
from benchmark.reference import stylefield as ref_style

CHECK_STEPS = 3


class Cell:
    kind = "train"

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from tgtc_torch.data.style_dataset import StyleSceneData
        from tgtc_torch.models.style_field import (
            StyleFieldConfig,
            StyleMLPBeforeConcat,
            StyleMLPWildMultilayers,
        )
        from tgtc_torch.train.style3d import (
            StyleStepDraws,
            StyleTrainConfig,
            StyleTrainState,
            make_style_optimizer,
            make_style_train_step,
        )

        self.StyleStepDraws = StyleStepDraws
        self.config, self.seed, self.device = config, seed, torch.device(device)
        self.fetch_every = int(traffic["fetch_every"])
        self.batch = int(config["batch_size_style"])
        self.nc, self.nf = int(config["N_samples"]), int(config["N_samples_fine"])
        h, w, focal = T.camera(config)
        ro, rd = T.rays(h, w, focal, T.train_poses(config), device)
        f, s = ro.shape[0], int(config["style_num"])
        gen = T.generator(device, seed, C.WEIGHTS_KEY)
        self.trunks = C.draw_trunks(config, gen, device)
        self.style0 = C.draw_style(config, gen, device)
        self.table = C.draw_table(config, gen, device)
        self.data = StyleSceneData(
            rays_o=ro.view(f, h, w, 3), rays_d=rd.view(f, h, w, 3),
            images=T.smooth_images(gen, f, h, w, device),
            stylized=T.smooth_images(gen, s * f, h, w, device).view(s, f, h, w, 3),
            style_features=torch.randn((s, 1024), generator=gen, device=device))
        self.gen = torch.Generator(device=device)

        tcfg = StyleTrainConfig(
            batch_size=self.batch, n_samples=self.nc, n_samples_fine=self.nf,
            sigma_noise_std=float(config["sigma_noise_std"]), lrate=float(config["lrate"]),
            latent_lrate=float(config["latent_lrate"]),
            rgb_loss_lambda=float(config["rgb_loss_lambda"]),
            logp_loss_lambda=float(config["logp_loss_lambda"]),
            loss_coh_lambda=float(config["loss_coh_lambda"]),
            origin_step=int(config["origin_step"]),
            coh_until_step=int(config["coh_until_step"]))
        fcfg = StyleFieldConfig(style_d=int(config["style_D"]), width=int(config["netwidth"]),
                                latent_dim=int(config["vae_latent"]),
                                embed_dim=3 + 6 * int(config["multires"]))
        concat = StyleMLPBeforeConcat(fcfg).to(device)
        concat.load_state_dict(C.sub(self.style0, "concat."))
        style = StyleMLPWildMultilayers(fcfg).to(device)
        style.load_state_dict(C.sub(self.style0, "style."))
        latents = self.table["latents"].clone().requires_grad_(True)
        zeros = lambda: torch.zeros((self.batch, 3), device=device)
        self.state = StyleTrainState(
            step=int(traffic["resume_step"]), concat=concat, style=style, latents=latents,
            mu=self.table["mu"].clone(), logvar=self.table["logvar"].clone(),
            optimizer=make_style_optimizer(
                tcfg, list(concat.parameters()) + list(style.parameters()), latents),
            coh_x=zeros(), coh_y=zeros(), coh_x_origin=zeros())
        self.step_fn = make_style_train_step(
            C.nerf_module(config, self.trunks["coarse"], device),
            C.nerf_module(config, self.trunks["fine"], device), tcfg)
        self.k = 0

        names = ([f"concat.{n}" for n, _ in concat.named_parameters()]
                 + [f"style.{n}" for n, _ in style.named_parameters()] + ["latents"])
        params = self.state.parameters()
        losses, coh = [], []
        for i in range(CHECK_STEPS):
            losses.append(self.step())
            coh.append(self.metrics["loss_coh"])
            if i == 0:
                grad0 = C.exp_avg_grads(self.state.optimizer, names, params)
        self.first = {"losses": torch.stack(losses).float().cpu().tolist(),
                      "coh_losses": torch.stack(coh).float().cpu().tolist(), "grad0": grad0,
                      "params": {n: p.detach().clone() for n, p in zip(names, params)}}

    def feed(self, k: int):
        b, nc, n_fine, dev = self.batch, self.nc, self.nc + self.nf, self.device
        d = self.data
        h, w = d.hw
        g = self.gen.manual_seed(T.sub_seed(self.seed, C.FEED_KEY, k))
        main = torch.randint(0, d.style_num * d.frame_num * h * w, (b,), generator=g, device=dev)
        u_main = torch.rand((b, nc), generator=g, device=dev)
        u_coh = torch.rand((b, nc), generator=g, device=dev)
        noise = lambda: (torch.randn((b, nc), generator=g, device=dev),
                         torch.randn((b, n_fine), generator=g, device=dev))
        noise_main, noise_coh = noise(), noise()
        g = self.gen.manual_seed(T.sub_seed(self.seed, C.COH_KEY, k // d.frame_num))
        coh = torch.randint(0, h * w, (b,), generator=g, device=dev)
        return self.StyleStepDraws(main, coh, u_main, u_coh, noise_main, noise_coh)

    def step(self) -> torch.Tensor:
        draws = self.feed(self.k)
        self.k += 1
        _, self.metrics = self.step_fn(self.state, self.data, draws=draws)
        return self.metrics["loss"]

    def work(self) -> Dict:
        pts = self.batch * (self.nc + self.nc + self.nf)  # a stream's points
        remap, style = W.trunk_flop(self.config)["remap"], W.style_flop(self.config)
        return {"model_flop": pts * (remap + 3 * style) + pts * (remap + style), "kernels": {}}

    def _steps(self):
        """The first steps' inputs, as the program's counters walk them from
        a fresh state: the main stream's gathers and the coherent stream of
        style 0, frame k."""
        d = self.data
        s, f = d.style_num, d.frame_num
        h, w = d.hw
        flat = lambda x: x.reshape(-1, *x.shape[-1:])
        out = []
        for k in range(CHECK_STEPS):
            dr = self.feed(k)
            sty, rem = dr.main_ids // (f * h * w), dr.main_ids % (f * h * w)
            frm, pix = rem // (h * w), rem % (h * w)
            view = frm * h * w + pix
            cv = k * h * w + dr.coh_pix
            out.append({
                "main": {"ro": flat(d.rays_o)[view], "rd": flat(d.rays_d)[view],
                         "rgb": flat(d.stylized)[sty * f * h * w + view], "style": sty,
                         "frame": frm},
                "coh": {"ro": flat(d.rays_o)[cv], "rd": flat(d.rays_d)[cv],
                        "origin": flat(d.images)[cv], "style": torch.zeros_like(cv),
                        "frame": torch.full_like(cv, k)},
                "u_main": dr.u_main, "u_coh": dr.u_coh, "noise_main": dr.noise_main,
                "noise_coh": dr.noise_coh})
        return out

    def check(self, losses, extra: bool = False) -> Dict[str, Dict[str, float]]:
        """The numbers of ``correct`` for the program (``"program"``) and,
        with ``extra``, for the control and the half-batch fault put in its
        place. Frees the program's state first."""
        del self.state, self.step_fn
        C.free(self.device)
        params0 = {**self.style0, "latents": self.table["latents"]}
        steps = self._steps()
        run = lambda **kw: ref_style.train(self.trunks, self.style0, self.table, self.config,
                                           steps, **kw)
        with C.exact_f32():
            ref = run()
            out = {"program": C.train_checks(self.first, ref, params0, losses)}
            if extra:
                for name, kw in (("control", {"precision": "tf32"}),
                                 ("half_batch", {"half_batch": True})):
                    out[name] = C.train_checks(run(**kw), ref, params0, [])
        return out


def build(config: Dict, traffic: Dict, seed: int, device) -> Cell:
    return Cell(config, traffic, seed, device)
