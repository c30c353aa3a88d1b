"""Weight bridge between flax ``NerfMLP`` params and the torch ``NerfMLP``.

The flax modules use the reference's layer order under flax names
(``base_{i}``, ``sigma``, ``base_remap``, ``rgb_{0,1}``); the torch module
uses the reference's torch names. A Dense ``kernel [in, out]`` is a Linear
``weight [out, in]`` transposed; biases carry over as they are.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

_TORCH_NAME = {"sigma": "sigma_layer", "base_remap": "base_remap_layer",
               "rgb_0": "rgb_layers.0", "rgb_1": "rgb_layers.1"}


def _torch_name(flax_name: str) -> str:
    if flax_name.startswith("base_") and flax_name[5:].isdigit():
        return f"base_layers.{flax_name[5:]}"
    return _TORCH_NAME[flax_name]


def nerf_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params": {name: {"kernel", "bias"}}}`` (numpy or any array
    that ``np.asarray`` takes) → ``NerfMLP`` state dict of f32 tensors."""
    sd: Dict[str, torch.Tensor] = {}
    for name, leaf in params["params"].items():
        t = _torch_name(name)
        kernel = np.asarray(leaf["kernel"], np.float32)
        sd[f"{t}.weight"] = torch.from_numpy(np.array(kernel.T, order="C"))
        sd[f"{t}.bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))
    return sd


def nerf_flax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`nerf_state_dict_from_flax`: numpy flax params."""
    flax_name = {v: k for k, v in _TORCH_NAME.items()}
    p: Dict[str, Any] = {}
    for key, value in sd.items():
        layer, kind = key.rsplit(".", 1)
        if layer.startswith("base_layers."):
            name = f"base_{layer.split('.')[1]}"
        else:
            name = flax_name[layer]
        arr = value.detach().cpu().float().numpy()
        entry = p.setdefault(name, {})
        if kind == "weight":
            entry["kernel"] = np.ascontiguousarray(arr.T)
        else:
            entry["bias"] = arr.copy()
    return {"params": p}
