"""The port's command — port of tgtc/cli.py:

    python -m tgtc_torch.cli --config configs/fern.txt
    python -m tgtc_torch.cli --config configs/fern.txt --render_valid_style
    python -m tgtc_torch.cli --config configs/fern.txt --render_train_style
    python -m tgtc_torch.cli --config configs/fern.txt --render_valid
    python -m tgtc_torch.cli --config configs/fern.txt --render_train

Over several GPUs, one process each (Phases A and E; see
``Pipeline._run_multihost``)::

    torchrun --nproc_per_node=N -m tgtc_torch.cli --config configs/fern.txt

Every reference flag (:class:`tgtc_torch.config.Config`) is accepted, and
config files in the reference's ``key = value`` format load unchanged. With
no render flag the command runs the phase machine A → E
(:class:`tgtc_torch.train.pipeline.Pipeline`), resuming from whatever the
run directory holds.

``--debug_nans`` turns on ``torch.autograd.set_detect_anomaly(True)``: a
backward pass that produces a NaN raises at the operation that made it,
with the forward's stack trace. It does not see NaNs of forward-only work
(renders, stylization under ``no_grad``) or of the optimizer's update, and
it slows every backward. The JAX command's XLA compilation cache has no
counterpart: the port's CUDA kernels are built once into
``tgtc_torch/_build/`` and reused by later processes.
"""

from __future__ import annotations

import sys
from typing import List, Optional

from tgtc_torch.config import load_config
from tgtc_torch.device import DeviceLike


def main(argv: Optional[List[str]] = None, device: DeviceLike = None) -> int:
    """Parse ``argv`` and run the pipeline on ``device`` (the card unless
    the caller passes ``device="cpu"``, a Python argument, not a flag). A
    multi-process launch joins its process group first (binding the
    process's card) and leaves it on exit."""
    import torch
    import torch.distributed as dist

    from tgtc_torch.parallel import maybe_initialize_distributed
    from tgtc_torch.train.pipeline import Pipeline

    joined = maybe_initialize_distributed(device=device)
    try:
        cfg = load_config(argv)
        if cfg.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        pipe = Pipeline(cfg, device)
        try:
            pipe.run()
        finally:
            pipe.close()
    finally:
        if joined:
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
