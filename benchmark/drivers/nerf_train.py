"""Phase A's fused training step, driven as a closed loop (``nerf-fern.train``).

The program: ``train.nerf_trainer.make_fused_train_step`` (K1 forward on
both passes, ``sample_pdf`` and the sort, K3 backward, Adam) on a
``NerfTrainState`` holding the benchmark's seeded trunks. The feed: the
training views' rays and synthetic images on the device; each step's rows
are the next ``batch_size`` of a seeded permutation of all rays (so all rows
of the first steps differ), its jitter and σ noise from a generator seeded
by (seed, step). Set-up takes the first three steps through that same call
and feed; the check follows them with the plain reference.
"""

from __future__ import annotations

from typing import Dict

import torch

from benchmark.drivers import common as C
from benchmark.harness import traffic as T
from benchmark.harness import work as W
from benchmark.reference import nerf as ref_nerf

CHECK_STEPS = 3


class Cell:
    kind = "train"

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from tgtc_torch.train.nerf_trainer import (
            NerfTrainConfig,
            NerfTrainState,
            StepDraws,
            make_fused_train_step,
            make_optimizer,
        )

        self.StepDraws = StepDraws
        self.config, self.seed, self.device = config, seed, torch.device(device)
        self.fetch_every = int(traffic["fetch_every"])
        self.batch = int(config["batch_size"])
        self.nc, self.nf = int(config["N_samples"]), int(config["N_samples_fine"])
        h, w, focal = T.camera(config)
        ro, rd = T.rays(h, w, focal, T.train_poses(config), device)
        self.ro, self.rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
        gen = T.generator(device, seed, C.WEIGHTS_KEY)
        self.params0 = C.draw_trunks(config, gen, device)
        self.rgb = T.smooth_images(gen, ro.shape[0], h, w, device).reshape(-1, 3)
        self.order = torch.randperm(self.ro.shape[0], generator=gen, device=device)
        self.gen = torch.Generator(device=device)

        coarse = C.nerf_module(config, self.params0["coarse"], device)
        fine = C.nerf_module(config, self.params0["fine"], device)
        tcfg = NerfTrainConfig(
            batch_size=self.batch, lrate=float(config["lrate"]),
            lrate_decay=int(config["lrate_decay"]), n_samples=self.nc,
            n_samples_fine=self.nf, sigma_noise_std=float(config["sigma_noise_std"]),
            near=0.0, far=1.0)
        params = list(coarse.parameters()) + list(fine.parameters())
        opt, sched = make_optimizer(tcfg, params)
        self.state = NerfTrainState(0, coarse, fine, opt, sched)
        self.step_fn = make_fused_train_step(C.nerf_config(config), tcfg, device=device)
        self.k = 0

        names = ([f"coarse.{n}" for n, _ in coarse.named_parameters()]
                 + [f"fine.{n}" for n, _ in fine.named_parameters()])
        losses = []
        for i in range(CHECK_STEPS):
            losses.append(self.step())
            if i == 0:
                grad0 = C.exp_avg_grads(opt, names, params)
        self.first = {"losses": torch.stack(losses).float().cpu().tolist(), "grad0": grad0,
                      "params": {n: p.detach().clone() for n, p in zip(names, params)}}

    def feed(self, k: int):
        b, n, dev = self.batch, self.ro.shape[0], self.device
        s = (k * b) % n
        idx = (self.order[s: s + b] if s + b <= n
               else torch.cat([self.order[s:], self.order[: s + b - n]]))
        g = self.gen.manual_seed(T.sub_seed(self.seed, C.FEED_KEY, k))
        u = torch.rand((b, self.nc), generator=g, device=dev)
        noise_c = torch.randn((b, self.nc), generator=g, device=dev)
        noise_f = torch.randn((b, self.nc + self.nf), generator=g, device=dev)
        return self.StepDraws(idx, u, noise_c, noise_f)

    def step(self) -> torch.Tensor:
        draws = self.feed(self.k)
        self.k += 1
        _, metrics = self.step_fn(self.state, self.ro, self.rd, self.rgb, draws=draws)
        return metrics["loss"]

    def work(self) -> Dict:
        b, cfg = self.batch, self.config
        pts = b * (self.nc + self.nc + self.nf)
        full = W.trunk_flop(cfg)["full"]
        return {"model_flop": 3 * full * pts,
                "kernels": {"K1": W.kernel_work("K1", cfg, pts, 2 * b, 2),
                            "K3": W.kernel_work("K3", cfg, pts, 2 * b, 2)}}

    def _batches(self):
        out = []
        for k in range(CHECK_STEPS):
            d = self.feed(k)
            out.append({"ro": self.ro[d.idx], "rd": self.rd[d.idx], "rgb": self.rgb[d.idx],
                        "u": d.perturb_u, "noise_c": d.noise_coarse, "noise_f": d.noise_fine})
        return out

    def check(self, losses, extra: bool = False) -> Dict[str, Dict[str, float]]:
        """The numbers of ``correct`` for the program (``"program"``) and,
        with ``extra``, for the control and the half-batch fault put in its
        place. Frees the program's state first."""
        del self.state, self.step_fn
        C.free(self.device)
        params0 = {f"{net}.{k}": v for net in ("coarse", "fine")
                   for k, v in self.params0[net].items()}
        batches = self._batches()
        with C.exact_f32():
            ref = ref_nerf.train(self.params0, self.config, batches)
            out = {"program": C.train_checks(self.first, ref, params0, losses)}
            if extra:
                for name, kw in (("control", {"precision": "fp8"}),
                                 ("half_batch", {"half_batch": True})):
                    cand = ref_nerf.train(self.params0, self.config, batches, **kw)
                    out[name] = C.train_checks(cand, ref, params0, [])
        return out


def build(config: Dict, traffic: Dict, seed: int, device) -> Cell:
    return Cell(config, traffic, seed, device)
