"""Exact novel views as a closed loop from one viewer (``nerf-fern.view``).

The program: ``render.fast.FusedNerfRenderer.render_image`` (K2 σ-only
coarse pass, ``sample_pdf`` and the sort, K1 fine pass, compositing) on the
benchmark's seeded trunks, over the NDC rays of the spiral's poses in turn,
made at set-up; a frame is done when its rgb, depth and opacity are on the
host. The check renders rays sampled from the seed out of frames the window
produced with the plain reference, at the same rays.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from benchmark.drivers import common as C
from benchmark.harness import traffic as T
from benchmark.harness import work as W
from benchmark.reference import compare
from benchmark.reference import nerf as ref_nerf

COLUMNS = ["rgb", "rgb", "rgb", "depth", "acc"]


class Cell:
    kind = "view"

    def __init__(self, config: Dict, traffic: Dict, seed: int, device):
        from tgtc_torch.render.fast import FusedNerfRenderer
        from tgtc_torch.render.volume import RenderSettings

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.block = int(traffic["block"])
        h, w, focal = T.camera(config)
        self.ro, self.rd = T.rays(h, w, focal, T.render_poses(config), device)
        self.params = C.draw_trunks(config, T.generator(device, seed, C.WEIGHTS_KEY), device)
        self.nc, self.nf = int(config["N_samples"]), int(config["N_samples_fine"])
        settings = RenderSettings(n_samples=self.nc, n_samples_fine=self.nf, near=0.0, far=1.0,
                                  sigma_noise_std=0.0, perturb=False)
        self.renderer = FusedNerfRenderer.from_params(
            self.params["coarse"], self.params["fine"], settings,
            depth=int(config["netdepth"]), num_freq_coor=int(config["multires"]),
            num_freq_dir=int(config["multires_views"]), width=int(config["netwidth"]),
            skip=int(config["skips"][0]), coarse_rgb=False, device=device)
        self.i = 0
        self.to_host(self.frame())  # warm-up: the cell's one shape
        self.i = 0

    def frame(self) -> Dict[str, torch.Tensor]:
        v = self.i % self.ro.shape[0]
        self.i += 1
        return self.renderer.render_image(self.ro[v], self.rd[v], block=self.block)

    @staticmethod
    def to_host(out: Dict[str, torch.Tensor]) -> torch.Tensor:
        return torch.cat([out["rgb"], out["t_exp"][:, None], out["acc"][:, None]], 1).cpu()

    def work(self) -> Dict:
        rays = self.ro.shape[1]
        blocks = -(-rays // self.block)
        t = W.trunk_flop(self.config)
        return {"model_flop": rays * (self.nc * t["sigma"] + (self.nc + self.nf) * t["full"]),
                "kernels": {"K2": W.kernel_work("K2", self.config, rays * self.nc, rays, blocks),
                            "K1": W.kernel_work("K1", self.config, rays * (self.nc + self.nf),
                                                rays, blocks)}}

    def check(self, frames: List[torch.Tensor], extra: bool = False
              ) -> Dict[str, Dict[str, float]]:
        """RMSE of the sampled rays of the window's frames against the plain
        reference (``"program"``) and, with ``extra``, of the control."""
        del self.renderer
        C.free(self.device)
        idx, pix = C.sample(len(frames), self.ro.shape[1], self.traffic, self.seed)
        cand = torch.cat([frames[i][p.cpu()] for i, p in zip(idx, pix)], 0)
        views = [i % self.ro.shape[0] for i in idx]
        ro = torch.cat([self.ro[v][p.to(self.device)] for v, p in zip(views, pix)], 0)
        rd = torch.cat([self.rd[v][p.to(self.device)] for v, p in zip(views, pix)], 0)
        pc, pf = self.params["coarse"], self.params["fine"]
        with C.exact_f32():
            ref = ref_nerf.render(pc, pf, self.config, ro, rd).cpu()
            out = {"program": compare.view_readings(cand, ref, COLUMNS)}
            if extra:
                ctl = ref_nerf.render(pc, pf, self.config, ro, rd, precision="fp8").cpu()
                out["control"] = compare.view_readings(ctl, ref, COLUMNS)
        return out


def build(config: Dict, traffic: Dict, seed: int, device) -> Cell:
    return Cell(config, traffic, seed, device)
