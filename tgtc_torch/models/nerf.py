"""The NeRF trunk — port of tgtc/models/nerf.py.

8x256 MLP with a skip at layer 4, σ head (f32), 256-d ``base_remap``
feature head and a viewdir-conditioned 2-layer RGB head. Layer names are
the reference's torch names (``base_layers.{i}``, ``sigma_layer``,
``base_remap_layer``, ``rgb_layers.{0,1}``), so reference checkpoints and
the flax params (via :mod:`tgtc_torch.convert`) load 1:1.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from tgtc_torch.device import DeviceLike, resolve_device
from tgtc_torch.ops.encoding import encoding_dim, positional_encoding

ACTIVATIONS: Dict[str, Callable] = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "elu": F.elu,
    "tanh": torch.tanh,
}


def make_sine(w0: float = 30.0) -> Callable:
    """SIREN activation (reference ``Sine``)."""
    return lambda x: torch.sin(w0 * x)


@dataclasses.dataclass(frozen=True)
class NerfConfig:
    """Static architecture config (mirrors the reference CLI flags)."""

    depth: int = 8
    width: int = 256
    embed_freq_coor: int = 10
    embed_freq_dir: int = 4
    use_viewdir: bool = True
    act_type: str = "relu"
    siren_sigma_mul: float = 20.0
    skips: Tuple[int, ...] = (4,)
    compute_dtype: torch.dtype = torch.bfloat16

    @property
    def is_siren(self) -> bool:
        return self.act_type == "sine"

    @property
    def input_ch(self) -> int:
        return 3 if self.is_siren else encoding_dim(3, self.embed_freq_coor)

    @property
    def input_ch_viewdir(self) -> int:
        return 3 if self.is_siren else encoding_dim(3, self.embed_freq_dir)

    @property
    def activation(self) -> Callable:
        return make_sine() if self.is_siren else ACTIVATIONS[self.act_type]


class NerfMLP(nn.Module):
    """Trunk MLP operating on *pre-encoded* points/dirs ``[..., C]``."""

    def __init__(self, cfg: NerfConfig):
        super().__init__()
        self.cfg = cfg
        w, in_c = cfg.width, cfg.input_ch
        layers = [nn.Linear(in_c, w)]
        for i in range(cfg.depth - 1):
            layers.append(nn.Linear(w + in_c if i in cfg.skips else w, w))
        self.base_layers = nn.ModuleList(layers)
        self.sigma_layer = nn.Linear(w, 1)
        self.base_remap_layer = nn.Linear(w, 256)  # always 256 wide
        rgb_in = 256 + cfg.input_ch_viewdir if cfg.use_viewdir else 256
        self.rgb_layers = nn.ModuleList([nn.Linear(rgb_in, w // 2),
                                         nn.Linear(w // 2, 3)])

    def forward(self, pts_embed: torch.Tensor, dirs_embed: torch.Tensor
                ) -> Dict[str, torch.Tensor]:
        """Point-major forward in ``compute_dtype`` (bf16 rounds after
        every layer, as flax ``Dense(dtype=bf16)`` does)."""
        return _trunk(self, pts_embed, dirs_embed, accum_f32=False)


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype,
           accum_f32: bool) -> torch.Tensor:
    """``x @ W.T + b`` with operands in ``dtype``. ``accum_f32``: keep the
    product in f32 (exact products of ``dtype`` values, f32 sums — the
    ``preferred_element_type=f32`` contract); else the result is
    ``dtype`` like a flax Dense."""
    if accum_f32:
        return F.linear(x.to(dtype).float(), layer.weight.to(dtype).float(),
                        layer.bias.float())
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


def _trunk(model: NerfMLP, e_c: torch.Tensor, e_d: torch.Tensor,
           accum_f32: bool) -> Dict[str, torch.Tensor]:
    cfg = model.cfg
    act, cdt = cfg.activation, cfg.compute_dtype
    f32 = torch.float32

    x = e_c.to(cdt)
    h = act(_dense(model.base_layers[0], x, cdt, accum_f32)).to(cdt)
    for i in range(cfg.depth - 1):
        if i in cfg.skips:
            h = torch.cat([x, h], dim=-1)
        h = act(_dense(model.base_layers[i + 1], h, cdt, accum_f32)).to(cdt)

    sigma = _dense(model.sigma_layer, h.float(), f32, True)
    if cfg.is_siren:
        sigma = sigma + torch.relu(sigma) * cfg.siren_sigma_mul

    base_remap = act(_dense(model.base_remap_layer, h, cdt, accum_f32)).to(cdt)
    rgb_in = (torch.cat([base_remap, e_d.to(cdt)], dim=-1)
              if cfg.use_viewdir else base_remap)
    rgb_fea = act(_dense(model.rgb_layers[0], rgb_in, cdt, accum_f32)).to(cdt)
    rgb = torch.sigmoid(_dense(model.rgb_layers[1], rgb_fea.float(), f32, True))
    return {"rgb": rgb, "sigma": sigma[..., 0],
            "base_remap": base_remap.float()}


def make_nerf(cfg: NerfConfig, generator: Optional[torch.Generator] = None,
              device: DeviceLike = None) -> NerfMLP:
    """Build a trunk with LeCun-normal kernels and zero biases (the flax
    ``Dense`` default), drawn from ``generator``, on ``device``."""
    dev = resolve_device(device)
    model = NerfMLP(cfg)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Linear):
                fan_in = m.weight.shape[1]
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * fan_in ** -0.5)
                m.bias.zero_()
    return model.to(dev)


def _encode(cfg: NerfConfig, pts: torch.Tensor, dirs: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    if cfg.is_siren:
        return pts, dirs
    return (positional_encoding(pts, cfg.embed_freq_coor),
            positional_encoding(dirs, cfg.embed_freq_dir))


def nerf_apply(model: NerfMLP, pts: torch.Tensor, dirs: torch.Tensor
               ) -> Dict[str, torch.Tensor]:
    """Encode raw ``pts/dirs [..., 3]`` and run the trunk. Returns ``rgb
    [..., 3]``, ``sigma [...]``, ``base_remap [..., 256]``, ``pts_embed``."""
    e_c, e_d = _encode(model.cfg, pts, dirs)
    out = model(e_c, e_d)
    out["pts_embed"] = e_c
    return out


def nerf_apply_t(model: NerfMLP, pts_t: torch.Tensor, dirs_t: torch.Tensor
                 ) -> Dict[str, torch.Tensor]:
    """Feature-major forward: ``pts_t/dirs_t [3, P]`` → ``rgb [3, P]``,
    ``sigma [P]``, ``base_remap [256, P]``, ``pts_embed [in_c, P]``.
    Every matmul takes ``compute_dtype`` operands and accumulates in f32,
    like the JAX ``nerf_apply_t``."""
    cfg = model.cfg
    e_c, e_d = _encode(cfg, pts_t.T, dirs_t.T)
    e_c = e_c.to(cfg.compute_dtype)
    out = _trunk(model, e_c, e_d.to(cfg.compute_dtype), accum_f32=True)
    return {"rgb": out["rgb"].T, "sigma": out["sigma"],
            "base_remap": out["base_remap"].T, "pts_embed": e_c.float().T}
