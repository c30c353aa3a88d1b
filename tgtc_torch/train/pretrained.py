"""Load the reference's pretrained 2D assets into a StyTrans or an AdainNet —
port of the VGG, decoder, transformer and embedding overlays of
tgtc/train/pretrained.py (``load_decoder_overlay`` :52).

The reference's assets are torch state dicts under its own names
(``vgg_normalised.pth``, ``decoder.pth``, and ``transformer_iter_*.pth`` /
``embedding_iter_*.pth`` scanned from a ``pretrained`` directory, newest
``sorted(os.listdir)`` entry first), and the port's modules use the same
names, so each overlay is a ``load_state_dict``. The full
``vgg_normalised.pth`` holds layers past the truncated VGG's 31, whose keys
are dropped first. An asset whose shapes do not fit the configured model
(e.g. the 512-channel decoder into a narrow test model) is refused loudly
and the model keeps its random weights, as a missing asset does — a
transformer trained against a random VGG minimizes a meaningless objective,
so that case says so. The transformer's dead ``new_ps.*`` keys are dropped.
``vae.pth`` loads into a :class:`~tgtc_torch.models.vae.Vae` as it is
(:func:`load_vae_params`), or is absent and the VAE trains.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import torch
import torch.nn as nn


def _say(msg: str) -> None:
    print(f"[pretrained] {msg}", flush=True)


def load_state_dict_file(path: str) -> Dict[str, torch.Tensor]:
    """``torch.load`` a ``.pth`` state dict (or a whole saved module) on the
    CPU."""
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    return dict(sd)


def latest_with(substr: str, d: str) -> Optional[str]:
    """The newest ``sorted(os.listdir(d))`` ``.pth`` whose name contains
    ``substr``, or None."""
    if not d or not os.path.isdir(d):
        return None
    hits = [f for f in sorted(os.listdir(d)) if substr in f and f.endswith(".pth")]
    return os.path.join(d, hits[-1]) if hits else None


def _fits(module: nn.Module, sd: Dict[str, torch.Tensor], what: str) -> bool:
    """The shape gate: the asset must hold exactly the module's keys, each
    of the module's shape."""
    own = module.state_dict()
    problem = None
    if set(sd) != set(own):
        problem = (f"keys differ: missing {sorted(set(own) - set(sd))[:4]}, unexpected "
                   f"{sorted(set(sd) - set(own))[:4]}")
    else:
        bad = [k for k in own if tuple(sd[k].shape) != tuple(own[k].shape)]
        if bad:
            problem = (f"{bad[0]} is {tuple(sd[bad[0]].shape)}, the model's "
                       f"{tuple(own[bad[0]].shape)}")
    if problem:
        _say(f"{what} weights do NOT fit the configured model ({problem}) — keeping random init")
        return False
    return True


def _overlay(module: nn.Module, path: Optional[str], what: str, drop_prefix: str = "",
             only_own: bool = False, missing_note: str = "") -> bool:
    if not path or not os.path.exists(path):
        _say(f"{what} weights NOT found at {path!r} — falling back to RANDOM {what}"
             + missing_note)
        return False
    sd = load_state_dict_file(path)
    if drop_prefix:
        sd = {k: v for k, v in sd.items() if not k.startswith(drop_prefix)}
    if only_own:  # layers the module does not build
        own = module.state_dict()
        sd = {k: v for k, v in sd.items() if k in own}
    if not _fits(module, sd, what):
        return False
    _say(f"loading pretrained {what} from {path}")
    module.load_state_dict(sd)
    return True


def load_vgg_overlay(vgg, vgg_pth_path: str) -> bool:
    """Overlay ``vgg_normalised.pth`` onto ``vgg`` (a
    :class:`~tgtc_torch.models.vgg.VggEncoder`) in place, dropping the keys
    of layers it does not build; False (and a loud message) if the file is
    missing or does not fit."""
    return _overlay(vgg, vgg_pth_path, "VGG", only_own=True,
                    missing_note=" (style losses will be meaningless)")


def load_decoder_overlay(decoder, decoder_pth_path: str) -> bool:
    """Overlay ``decoder.pth`` onto ``decoder`` (a
    :class:`~tgtc_torch.models.decoder.Decoder`) in place; False (and a loud
    message) if the file is missing or does not fit."""
    return _overlay(decoder, decoder_pth_path, "decoder")


def overlay_stytrans(model, decoder_pth_path: str = "", pretrained_dir: str = "",
                     vgg_pth_path: str = "") -> Dict[str, bool]:
    """Overlay ``vgg_normalised.pth``, ``decoder.pth`` and, if
    ``pretrained_dir`` holds them, the newest reference ``transformer*`` /
    ``embedding*`` pths onto ``model`` (a
    :class:`~tgtc_torch.models.stytrans.StyTrans`) in place, in the
    reference's order. Returns ``{asset: loaded?}``."""
    loaded = {"vgg": load_vgg_overlay(model.vgg, vgg_pth_path),
              "decoder": load_decoder_overlay(model.decode, decoder_pth_path)}
    tpth = latest_with("transformer", pretrained_dir)
    loaded["transformer"] = bool(tpth) and _overlay(model.transformer, tpth, "transformer",
                                                   drop_prefix="new_ps.")
    epth = latest_with("embedding", pretrained_dir)
    loaded["embedding"] = bool(epth) and _overlay(model.embedding, epth, "embedding")
    return loaded


def vae_keys(depth: int = 4) -> List[str]:
    """The reference ``VAE``'s state-dict keys at ``depth``."""
    layers = ([f"encoder.fc_layers.{i}" for i in range(depth - 1)]
              + ["encoder.fc_layer_mu", "encoder.fc_layer_log_var"]
              + [f"decoder.fc_layers.{i}" for i in range(depth - 1)] + ["decoder.output_layer"])
    return [f"{layer}.{kind}" for layer in layers for kind in ("weight", "bias")]


def load_vae_params(vae_pth_path: str, depth: int = 4) -> Optional[Dict[str, torch.Tensor]]:
    """``vae.pth`` → the state dict of a depth-``depth``
    :class:`~tgtc_torch.models.vae.Vae` (its keys only), or None when the
    path is empty or absent (the reference loads it when present). A file
    without one of those keys raises ``KeyError``."""
    if not vae_pth_path or not os.path.exists(vae_pth_path):
        return None
    _say(f"loading pretrained VAE from {vae_pth_path}")
    sd = load_state_dict_file(vae_pth_path)
    return {k: sd[k] for k in vae_keys(depth)}
