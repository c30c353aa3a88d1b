"""The default-device rule of the port, in one place.

Entry points take ``device=None`` and resolve it here: ``None`` means the
card. There is no silent CPU fallback — without CUDA, ``None`` or
``"cuda"`` raises, and only an explicit ``device="cpu"`` runs on the host
(the CPU tests pass it).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tgtc_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' explicitly to run on the host")
    return dev
