"""Stylized views as a closed loop from one viewer (``stylefield-fern.view``).

The program: ``render.fast_style.FusedStyleRenderer`` with Phase F's
settings (K5 σ-only coarse pass at jittered depths, ``sample_pdf`` and the
sort, K4 fine pass: trunk, concat MLP and style MLP; no σ noise), its blocks
through ``render.fast.render_in_blocks``, on the benchmark's seeded trunks,
style MLPs and latent table. Frame ``i`` is style 0 at latent frame ``i mod
F`` over spiral pose ``i mod V``; its coarse jitter is drawn by the
benchmark from (seed, i), one draw a frame, and handed to the program block
by block and to the reference. A frame is done when its rgb and depth are on
the host.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.drivers import common as C
from benchmark.harness import traffic as T
from benchmark.harness import work as W
from benchmark.reference import compare
from benchmark.reference import stylefield as ref_style

COLUMNS = ["rgb", "rgb", "rgb", "depth"]


class Cell:
    kind = "view"

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from tgtc_torch.render.fast import render_in_blocks
        from tgtc_torch.render.fast_style import FusedStyleRenderer
        from tgtc_torch.render.volume import RenderSettings

        self.render_in_blocks = render_in_blocks
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.block = int(traffic["block"])
        h, w, focal = T.camera(config)
        self.ro, self.rd = T.rays(h, w, focal, T.render_poses(config), device)
        gen = T.generator(device, seed, C.WEIGHTS_KEY)
        self.trunks = C.draw_trunks(config, gen, device)
        self.style = C.draw_style(config, gen, device)
        self.table = C.draw_table(config, gen, device)
        self.nc, self.nf = int(config["N_samples"]), int(config["N_samples_fine"])
        self.frames_in_table = self.table["latents"].shape[1]
        settings = RenderSettings(n_samples=self.nc, n_samples_fine=self.nf, near=0.0, far=1.0,
                                  sigma_noise_std=0.0, perturb=True)
        self.renderer = FusedStyleRenderer.from_params(
            self.trunks["coarse"], self.trunks["fine"], C.sub(self.style, "concat."),
            C.sub(self.style, "style."), self.table, settings,
            depth=int(config["netdepth"]), num_freq_coor=int(config["multires"]),
            style_d=int(config["style_D"]), style_width=int(config["netwidth"]),
            latent_dim=int(config["vae_latent"]), trunk_width=int(config["netwidth"]),
            skip=int(config["skips"][0]), coarse_rgb=False, device=device)
        self.sid = torch.zeros(self.block, dtype=torch.long, device=device)
        self.fid = [torch.full((self.block,), f, dtype=torch.long, device=device)
                    for f in range(self.frames_in_table)]
        self.gen = torch.Generator(device=device)
        self.i = 0
        self.to_host(self.frame())  # warm-up: the cell's one shape
        self.i = 0

    def jitter(self, i: int) -> torch.Tensor:
        """Frame ``i``'s coarse jitter, every block's rows (tail padding
        included)."""
        n = -(-self.ro.shape[1] // self.block) * self.block
        g = self.gen.manual_seed(T.sub_seed(self.seed, C.JITTER_KEY, i))
        return torch.rand((n, self.nc), generator=g, device=self.device)

    def frame(self) -> Dict[str, torch.Tensor]:
        i, self.i = self.i, self.i + 1
        v, fid, u = i % self.ro.shape[0], self.fid[i % self.frames_in_table], self.jitter(i)
        b = self.block
        return self.render_in_blocks(
            lambda bo, bd, start: self.renderer.render(bo, bd, self.sid, fid,
                                                       u=u[start: start + b]),
            self.ro[v], self.rd[v], b)

    @staticmethod
    def to_host(out: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([out["rgb"], out["t_exp"][:, None]], 1).cpu()

    def work(self) -> Dict:
        rays = self.ro.shape[1]
        blocks = -(-rays // self.block)
        t, k4 = W.trunk_flop(self.config), W.k4_flop(self.config)
        return {"model_flop": rays * (self.nc * t["sigma"] + (self.nc + self.nf) * k4),
                "kernels": {"K5": W.kernel_work("K5", self.config, rays * self.nc, rays, blocks),
                            "K4": W.kernel_work("K4", self.config, rays * (self.nc + self.nf),
                                                rays, blocks)}}

    def check(self, frames: List[torch.Tensor], extra: bool = False
              ) -> Dict[str, Dict[str, float]]:
        """RMSE of the sampled rays of the window's frames against the plain
        reference (``"program"``) and, with ``extra``, of the control."""
        del self.renderer
        C.free(self.device)
        idx, pix = C.sample(len(frames), self.ro.shape[1], self.traffic, self.seed)
        cand = torch.cat([frames[i][p] for i, p in zip(idx, pix)], 0)
        ro, rd, lat, u = [], [], [], []
        for i, p in zip(idx, pix):
            p = p.to(self.device)
            v = i % self.ro.shape[0]
            ro.append(self.ro[v][p])
            rd.append(self.rd[v][p])
            u.append(self.jitter(i)[p])
            lat.append(self.table["latents"][0, i % self.frames_in_table].expand(len(p), -1))
        ro, rd, lat, u = (torch.cat(x, 0) for x in (ro, rd, lat, u))
        args = (self.trunks["coarse"], self.trunks["fine"], self.style, self.config, ro, rd, lat, u)
        with C.exact_f32():
            ref = ref_style.render(*args).cpu()
            out = {"program": compare.view_readings(cand, ref, COLUMNS)}
            if extra:
                ctl = ref_style.render(*args, precision="fp8").cpu()
                out["control"] = compare.view_readings(ctl, ref, COLUMNS)
        return out


def build(config: Dict, traffic: Dict, seed: int, device) -> Cell:
    return Cell(config, traffic, seed, device)
