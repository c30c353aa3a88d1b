"""Weight bridge between the flax modules and their torch ports.

The flax modules use the reference's layer order under flax names
(``base_{i}``, ``sigma``, ``base_remap``, ``rgb_{0,1}``; the style MLPs'
``layer_{i}`` and ``rgb_out``); the torch modules use the reference's torch
names (the style MLPs' ``layers.{i}``). A Dense ``kernel [in, out]`` is a
Linear ``weight [out, in]`` transposed; biases carry over as they are. A
JAX latent table and a JAX Phase-A train state convert to tensors too.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

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


def _style_flax_names(which: str, n_layers: int):
    """Flax names of a style MLP's torch ``layers.{i}``: ``layer_{i}``, and
    ``rgb_out`` for the style MLP's last layer."""
    if which == "concat":
        return [f"layer_{i}" for i in range(n_layers)]
    return [f"layer_{i}" for i in range(n_layers - 1)] + ["rgb_out"]


def style_state_dicts_from_flax(params: Dict[str, Any]
                                ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
    """flax ``{"concat": {"params": ...}, "style": {"params": ...}}`` →
    ``(StyleMLPBeforeConcat, StyleMLPWildMultilayers)`` state dicts of f32
    tensors."""
    sds = []
    for which in ("concat", "style"):
        p = params[which]["params"]
        sd: Dict[str, torch.Tensor] = {}
        for i, name in enumerate(_style_flax_names(which, len(p))):
            kernel = np.asarray(p[name]["kernel"], np.float32)
            sd[f"layers.{i}.weight"] = torch.from_numpy(np.array(kernel.T, order="C"))
            sd[f"layers.{i}.bias"] = torch.from_numpy(np.array(p[name]["bias"], np.float32))
        sds.append(sd)
    return sds[0], sds[1]


def style_flax_from_state_dicts(concat_sd: Dict[str, torch.Tensor],
                                style_sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`style_state_dicts_from_flax`: numpy flax params."""
    out: Dict[str, Any] = {}
    for which, sd in (("concat", concat_sd), ("style", style_sd)):
        n = len([k for k in sd if k.endswith(".weight")])
        arr = lambda key: sd[key].detach().cpu().float().numpy()
        out[which] = {"params": {
            name: {"kernel": np.ascontiguousarray(arr(f"layers.{i}.weight").T),
                   "bias": arr(f"layers.{i}.bias").copy()}
            for i, name in enumerate(_style_flax_names(which, n))}}
    return out


def latent_state_from_jax(state: Dict[str, Any], device=None) -> Dict[str, torch.Tensor]:
    """A JAX latent state (``latents``, ``mu``, ``logvar``, as numpy or any
    array ``np.asarray`` takes) → f32 tensors on ``device``."""
    from tgtc_torch.device import resolve_device

    dev = resolve_device(device)
    return {k: torch.from_numpy(np.array(state[k], np.float32)).to(dev)
            for k in ("latents", "mu", "logvar")}


def nerf_train_state_from_jax(step: int, params_coarse: Dict[str, Any],
                              params_fine: Dict[str, Any], adam_count: int,
                              mu: Dict[str, Any], nu: Dict[str, Any], nerf_cfg,
                              train_cfg, fine_cfg=None, device=None):
    """A JAX ``NerfTrainState`` (as numpy: the step, both flax param trees,
    and the optax Adam state's ``count``, ``mu`` and ``nu``, each a
    ``{"coarse": params, "fine": params}`` tree) → the port's
    ``NerfTrainState`` on ``device``, so that a JAX-trained state resumes in
    the port. Only the plain Adam state (``steps_per_opt == 1``)."""
    from tgtc_torch.train.nerf_trainer import init_state

    state = init_state(torch.Generator().manual_seed(0), nerf_cfg, train_cfg, fine_cfg,
                       device=device)
    trees = {"coarse": (params_coarse, state.coarse), "fine": (params_fine, state.fine)}
    opt_state = state.optimizer.state_dict()
    index = {}  # parameter name -> its index in the optimizer's single group
    for which, (params, model) in trees.items():
        model.load_state_dict(nerf_state_dict_from_flax(params))
        for name, _ in model.named_parameters():
            index[(which, name)] = len(index)
    for which in trees:
        m1 = nerf_state_dict_from_flax(mu[which])
        m2 = nerf_state_dict_from_flax(nu[which])
        dev = trees[which][1].base_layers[0].weight.device
        for name in m1:
            opt_state["state"][index[(which, name)]] = {
                "step": torch.tensor(float(adam_count)),
                "exp_avg": m1[name].to(dev), "exp_avg_sq": m2[name].to(dev)}
    state.optimizer.load_state_dict(opt_state)
    state.scheduler.last_epoch = int(adam_count)  # the schedule's update count
    for group, base in zip(state.optimizer.param_groups, state.scheduler.base_lrs):
        group["lr"] = base * state.scheduler.lr_lambdas[0](int(adam_count))
    state.step = int(step)
    return state
