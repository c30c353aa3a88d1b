"""Weight bridge between the flax modules and their torch ports.

The flax modules use the reference's layer order under flax names
(``base_{i}``, ``sigma``, ``base_remap``, ``rgb_{0,1}``; the style MLPs'
``layer_{i}`` and ``rgb_out``); the torch modules use the reference's torch
names (the style MLPs' ``layers.{i}``). A Dense ``kernel [in, out]`` is a
Linear ``weight [out, in]`` transposed; biases carry over as they are. A
JAX latent table and JAX Phase-A and C1 train states convert to tensors too,
and so do the VAE's parameters.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from tgtc_torch.models.decoder import TORCH_INDEX
from tgtc_torch.models.vgg import _TORCH_IDX_TO_NAME as VGG_INDEX

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


# flax VAE names (encoder / decoder submodules) → the reference's torch names
_VAE_TORCH = {("encoder", "mu"): "encoder.fc_layer_mu",
              ("encoder", "logvar"): "encoder.fc_layer_log_var",
              ("decoder", "out"): "decoder.output_layer"}


def _vae_torch_name(part: str, name: str) -> str:
    if name.startswith("fc_"):
        return f"{part}.fc_layers.{name[3:]}"
    return _VAE_TORCH[(part, name)]


def vae_state_dict_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """flax ``{"params": {"encoder": {...}, "decoder": {...}}}`` (numpy or
    any array ``np.asarray`` takes) → a ``Vae`` state dict of f32 tensors
    under the reference's names; each Dense kernel transposed."""
    sd: Dict[str, torch.Tensor] = {}
    for part in ("encoder", "decoder"):
        for name, leaf in params["params"][part].items():
            t = _vae_torch_name(part, name)
            sd[f"{t}.weight"] = _t(leaf["kernel"])
            sd[f"{t}.bias"] = _t(leaf["bias"])
    return sd


def vae_flax_from_state_dict(sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`vae_state_dict_from_flax`: numpy flax params."""
    flax_name = {v: k for k, v in _VAE_TORCH.items()}
    p: Dict[str, Any] = {"encoder": {}, "decoder": {}}
    for key in sd:
        layer, kind = key.rsplit(".", 1)
        if kind != "weight":
            continue
        if ".fc_layers." in layer:
            part, _, i = layer.split(".")
            name = f"fc_{i}"
        else:
            part, name = flax_name[layer]
        p[part][name] = {"kernel": _f(sd[key]), "bias": _f(sd[f"{layer}.bias"])}
    return {"params": p}


def _t(x, perm=None) -> torch.Tensor:
    """A numpy-convertible array as a contiguous f32 tensor, transposed by
    ``perm`` (reversed axes if None)."""
    a = np.asarray(x, np.float32)
    return torch.from_numpy(np.array(np.transpose(a, perm), order="C"))


def _f(t: torch.Tensor, perm=None) -> np.ndarray:
    """The inverse of :func:`_t`: a contiguous f32 numpy array."""
    return np.ascontiguousarray(np.transpose(t.detach().cpu().float().numpy(), perm))


_HWIO_TO_OIHW, _OIHW_TO_HWIO = (3, 2, 0, 1), (2, 3, 1, 0)
_ENC_PARTS = ("qkv", "qk", "self_attn", "linear1", "linear2", "norm1", "norm2")
_DEC_PARTS = (("self_attn", "self_attn"), ("cross_attn", "multihead_attn"),
              ("linear1", "linear1"), ("linear2", "linear2"), ("norm1", "norm1"),
              ("norm2", "norm2"), ("norm3", "norm3"))


def _flax_leaf_to_torch(name: str, leaf: Dict[str, Any], prefix: str,
                        sd: Dict[str, torch.Tensor]) -> None:
    """One flax submodule (Dense, LayerNorm or MultiHeadAttention) → torch
    keys under ``prefix``."""
    if name.startswith("norm"):
        sd[f"{prefix}.weight"] = _t(leaf["scale"])
        sd[f"{prefix}.bias"] = _t(leaf["bias"])
    elif "q_proj" in leaf:  # MultiHeadAttention: packed in_proj, out_proj
        parts = [leaf[p] for p in ("q_proj", "k_proj", "v_proj")]
        sd[f"{prefix}.in_proj_weight"] = torch.cat([_t(p["kernel"]) for p in parts])
        sd[f"{prefix}.in_proj_bias"] = torch.cat([_t(p["bias"]) for p in parts])
        sd[f"{prefix}.out_proj.weight"] = _t(leaf["out_proj"]["kernel"])
        sd[f"{prefix}.out_proj.bias"] = _t(leaf["out_proj"]["bias"])
    else:
        sd[f"{prefix}.weight"] = _t(leaf["kernel"])
        if "bias" in leaf:
            sd[f"{prefix}.bias"] = _t(leaf["bias"])


def _torch_leaf_to_flax(name: str, prefix: str, sd: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The inverse of :func:`_flax_leaf_to_torch`."""
    if name.startswith("norm"):
        return {"scale": _f(sd[f"{prefix}.weight"]), "bias": _f(sd[f"{prefix}.bias"])}
    if name.endswith("attn"):
        w, b = _f(sd[f"{prefix}.in_proj_weight"]), _f(sd[f"{prefix}.in_proj_bias"])
        d = w.shape[0]
        out = {p: {"kernel": np.ascontiguousarray(w[:, i * d: (i + 1) * d]),
                   "bias": b[i * d: (i + 1) * d].copy()}
               for i, p in enumerate(("q_proj", "k_proj", "v_proj"))}
        out["out_proj"] = {"kernel": _f(sd[f"{prefix}.out_proj.weight"]),
                           "bias": _f(sd[f"{prefix}.out_proj.bias"])}
        return out
    leaf = {"kernel": _f(sd[f"{prefix}.weight"])}
    if f"{prefix}.bias" in sd:
        leaf["bias"] = _f(sd[f"{prefix}.bias"])
    return leaf


def _count(names, prefix: str) -> int:
    return len([n for n in names if n.startswith(prefix) and n[len(prefix):].isdigit()])


def _conv_sd(tree: Dict[str, Any], index: Dict[int, str]) -> Dict[str, torch.Tensor]:
    """flax convs ``{name: {"kernel" HWIO, "bias"}}`` → a sequential's
    ``{"<idx>.weight" OIHW, "<idx>.bias"}`` for the names present."""
    sd: Dict[str, torch.Tensor] = {}
    for idx, name in index.items():
        if name in tree:
            sd[f"{idx}.weight"] = _t(tree[name]["kernel"], _HWIO_TO_OIHW)
            sd[f"{idx}.bias"] = _t(tree[name]["bias"])
    return sd


def _conv_flax(sd: Dict[str, torch.Tensor], index: Dict[int, str]) -> Dict[str, Any]:
    """The inverse of :func:`_conv_sd`."""
    return {name: {"kernel": _f(sd[f"{idx}.weight"], _OIHW_TO_HWIO), "bias": _f(sd[f"{idx}.bias"])}
            for idx, name in index.items() if f"{idx}.weight" in sd}


_DECODER_INDEX = {idx: f"dconv{j}" for j, idx in enumerate(TORCH_INDEX)}


def stytrans_state_dicts_from_flax(params: Dict[str, Any]) -> Dict[str, Dict[str, torch.Tensor]]:
    """A flax StyTrans param tree (``{"params": {"embedding", "transformer",
    "decode", "vgg"}}``, numpy or any array ``np.asarray`` takes) → state
    dicts of f32 tensors under the reference's torch names, one for each
    subtree present: ``{"embedding", "transformer", "decoder", "vgg"}``, the
    inverse of JAX's ``convert_torch_patch_embed``,
    ``convert_torch_transformer``, ``convert_torch_decoder`` and
    ``convert_torch_vgg``. Dense kernels are transposed, conv kernels go
    HWIO → OIHW, LayerNorm ``scale`` becomes ``weight`` and the three
    attention projections are packed into ``in_proj_*``. A partial tree
    (the Adam moments of the trained subtrees) converts too."""
    p = params["params"]
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    if "embedding" in p:
        emb = p["embedding"]["proj"]
        out["embedding"] = {"proj.weight": _t(emb["kernel"], _HWIO_TO_OIHW),
                            "proj.bias": _t(emb["bias"])}
    if "transformer" in p:
        out["transformer"] = _transformer_sd(p["transformer"])
    if "decode" in p:
        out["decoder"] = _conv_sd(p["decode"], _DECODER_INDEX)
    if "vgg" in p:
        out["vgg"] = _conv_sd(p["vgg"], VGG_INDEX)
    return out


def _transformer_sd(tp: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    transformer: Dict[str, torch.Tensor] = {}
    for i in range(_count(tp, "enc_s_")):
        for ours, theirs in ((f"enc_s_{i}", f"encoder_s.layers.{i}"),
                             (f"enc_c_{i}", f"encoder_c.layers.{i}")):
            for part in _ENC_PARTS:
                _flax_leaf_to_torch(part, tp[ours][part], f"{theirs}.{part}", transformer)
    for i in range(_count(tp, "dec_")):
        for ours, theirs in _DEC_PARTS:
            _flax_leaf_to_torch(ours, tp[f"dec_{i}"][ours], f"decoder.layers.{i}.{theirs}",
                                transformer)
    _flax_leaf_to_torch("norm", tp["dec_norm"], "decoder.norm", transformer)
    return transformer


def stytrans_flax_from_state_dicts(sds: Dict[str, Dict[str, torch.Tensor]]) -> Dict[str, Any]:
    """The inverse of :func:`stytrans_state_dicts_from_flax`: numpy flax
    params ``{"params": {...}}`` with a subtree for each state dict given."""
    p: Dict[str, Any] = {}
    if "embedding" in sds:
        e = sds["embedding"]
        p["embedding"] = {"proj": {"kernel": _f(e["proj.weight"], _OIHW_TO_HWIO),
                                   "bias": _f(e["proj.bias"])}}
    if "transformer" in sds:
        p["transformer"] = _transformer_flax(sds["transformer"])
    if "decoder" in sds:
        p["decode"] = _conv_flax(sds["decoder"], _DECODER_INDEX)
    if "vgg" in sds:
        p["vgg"] = _conv_flax(sds["vgg"], VGG_INDEX)
    return {"params": p}


def _transformer_flax(t: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    layers = {k.split(".")[2] for k in t if k.startswith("encoder_s.layers.")}
    dec_layers = {k.split(".")[2] for k in t if k.startswith("decoder.layers.")}
    tp: Dict[str, Any] = {}
    for i in range(len(layers)):
        for ours, theirs in ((f"enc_s_{i}", f"encoder_s.layers.{i}"),
                             (f"enc_c_{i}", f"encoder_c.layers.{i}")):
            tp[ours] = {part: _torch_leaf_to_flax(part, f"{theirs}.{part}", t)
                        for part in _ENC_PARTS}
    for i in range(len(dec_layers)):
        tp[f"dec_{i}"] = {ours: _torch_leaf_to_flax(ours, f"decoder.layers.{i}.{theirs}", t)
                          for ours, theirs in _DEC_PARTS}
    tp["dec_norm"] = _torch_leaf_to_flax("norm", "decoder.norm", t)
    return tp


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


_MODULE_OF = {"embedding": "embedding", "transformer": "transformer", "decoder": "decode",
              "vgg": "vgg"}


def stytrans_model_state_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax StyTrans tree → one ``StyTrans.state_dict()``-keyed dict
    (``embedding.*``, ``transformer.*``, ``decode.*``, ``vgg.*``) of the
    subtrees present."""
    return {f"{_MODULE_OF[part]}.{k}": v
            for part, sd in stytrans_state_dicts_from_flax(params).items() for k, v in sd.items()}


def transformer_train_state_from_jax(step: int, params: Dict[str, Any], adam_count: int,
                                     mu: Dict[str, Any], nu: Dict[str, Any], model_cfg,
                                     train_cfg, train_keys=("transformer", "embedding"),
                                     device=None):
    """A JAX ``TransformerTrainState`` (as numpy: the step, the full flax
    StyTrans tree, and the Adam state of the ``optax.multi_transform``
    ``train`` partition: its ``count`` and the moments ``mu`` and ``nu``,
    each a ``{"params": {...}}`` tree of the ``train_keys`` subtrees) → the
    port's ``TransformerTrainState`` on ``device``, so that a JAX-trained
    C1 state resumes in the port."""
    from tgtc_torch.models.stytrans import make_stytrans
    from tgtc_torch.train.transformer2d import init_transformer_train, trained_parameters

    model = make_stytrans(model_cfg, torch.Generator().manual_seed(0), device=device)
    model.load_state_dict(stytrans_model_state_from_flax(params))
    state = init_transformer_train(model, train_cfg, train_keys)
    m1, m2 = stytrans_model_state_from_flax(mu), stytrans_model_state_from_flax(nu)
    names = [n for n, _ in trained_parameters(model, train_keys)]
    opt_state = state.optimizer.state_dict()
    dev = next(model.parameters()).device
    for i, name in enumerate(names):
        opt_state["state"][i] = {"step": torch.tensor(float(adam_count)),
                                 "exp_avg": m1[name].to(dev), "exp_avg_sq": m2[name].to(dev)}
    state.optimizer.load_state_dict(opt_state)
    state.scheduler.last_epoch = int(adam_count)  # the schedule's update count
    for group, base in zip(state.optimizer.param_groups, state.scheduler.base_lrs):
        group["lr"] = base * state.scheduler.lr_lambdas[0](int(adam_count))
    state.step = int(step)
    return state
