"""PyTorch/CUDA port of tgtc (texture-consistent 3D scene style transfer).

Mirrors the layout of the JAX package ``tgtc`` so each module has a
counterpart here: ``ops`` (encoding, compositing, sampling, losses and the
hand-written CUDA kernels), ``models`` (the NeRF trunk, the style field
and the 2D StyTr² network), ``render`` (eager and fused coarse→fine
rendering, plain and stylized), ``data`` (LLFF scenes, rays and the 2D
trainers' crop prefetcher), ``train`` (Phase-A training, the Phase-B
geometry dump, the Phase-C1 transformer pretraining, the Phase-C3 bulk
stylization with its pretrained-asset loader, and the Phase-F stylized
frames), ``utils`` (native PNG/resize shim, logging, uint8 images) and
``tools`` (the 2D trainer CLI and measurement scripts run on the card).

Submodules load lazily: ``import tgtc_torch`` imports nothing heavy, and
no kernel is built until the first call that launches it. Entry points
default to ``device="cuda"`` and raise when no card is present unless the
caller passes ``device="cpu"`` (see :mod:`tgtc_torch.device`).
"""

from __future__ import annotations

import importlib

_SUBMODULES = ("convert", "data", "device", "models", "ops", "render",
               "tools", "train", "utils")


def __getattr__(name):
    if name in _SUBMODULES:
        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
