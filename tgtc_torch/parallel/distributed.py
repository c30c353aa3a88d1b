"""The multi-process runtime — port of tgtc/parallel/distributed.py.

One process per GPU, the ``torch.distributed`` idiom: every process holds the
parameters, steps on its own rows of each global batch and all-reduces the
gradients (:class:`tgtc_torch.parallel.mesh.DataGroup`). The backend is NCCL
when the process's device is a card and gloo on the CPU.

Environment discovery, first match wins, as the JAX package reads it:

1. ``TGTC_COORDINATOR`` + ``TGTC_NUM_PROCESSES`` + ``TGTC_PROCESS_ID``;
2. torchrun's ``MASTER_ADDR``/``MASTER_PORT`` + ``WORLD_SIZE`` + ``RANK``;
3. SLURM's ``SLURM_PROCID``/``SLURM_NTASKS`` + ``TGTC_COORDINATOR`` (the
   coordinator's address has to come from somewhere);
4. ``TGTC_DISTRIBUTED=1`` with none of the above: ``init_method="env://"``,
   torch's own reading of the environment.

A partial spec (``RANK`` alone, say) matches nothing.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

import torch
import torch.distributed as dist

from tgtc_torch.device import DeviceLike, resolve_device


def discover_cluster_env(env: Optional[Mapping[str, str]] = None) -> Optional[dict]:
    """``{"coordinator_address", "num_processes", "process_id"}`` from the
    environment (the JAX package's keys), or None when no complete cluster
    spec is present."""
    e = os.environ if env is None else env
    if all(k in e for k in ("TGTC_COORDINATOR", "TGTC_NUM_PROCESSES", "TGTC_PROCESS_ID")):
        return dict(coordinator_address=e["TGTC_COORDINATOR"],
                    num_processes=int(e["TGTC_NUM_PROCESSES"]),
                    process_id=int(e["TGTC_PROCESS_ID"]))
    if all(k in e for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")):
        return dict(coordinator_address=f"{e['MASTER_ADDR']}:{e['MASTER_PORT']}",
                    num_processes=int(e["WORLD_SIZE"]), process_id=int(e["RANK"]))
    if all(k in e for k in ("SLURM_PROCID", "SLURM_NTASKS", "TGTC_COORDINATOR")):
        return dict(coordinator_address=e["TGTC_COORDINATOR"],
                    num_processes=int(e["SLURM_NTASKS"]), process_id=int(e["SLURM_PROCID"]))
    return None


def multi_process_launch(env: Optional[Mapping[str, str]] = None) -> bool:
    """Whether the launch environment names more than one process
    (:func:`discover_cluster_env`), or asks for the runtime's own discovery
    with ``TGTC_DISTRIBUTED=1``."""
    e = os.environ if env is None else env
    spec = discover_cluster_env(e)
    if spec is not None:
        return spec["num_processes"] > 1
    return e.get("TGTC_DISTRIBUTED") == "1"


def maybe_initialize_distributed(env: Optional[Mapping[str, str]] = None,
                                 device: DeviceLike = None,
                                 backend: Optional[str] = None) -> bool:
    """Join the process group when the environment asks for one; a plain
    launch is a no-op. Returns True when this call initialized the group
    (False when there is nothing to join or it is already joined).

    On a card the process is bound to ``cuda:LOCAL_RANK`` (else ``rank %
    device_count()``) before anything is allocated there. ``backend``
    defaults to NCCL on a card and gloo on the CPU; ``device`` follows the
    port's rule (the card unless the caller passes ``"cpu"``)."""
    e = os.environ if env is None else env
    spec = discover_cluster_env(e)
    if spec is None and e.get("TGTC_DISTRIBUTED") != "1":
        return False
    if dist.is_initialized():
        return False
    dev = resolve_device(device)
    if spec is not None:
        kw = dict(init_method=f"tcp://{spec['coordinator_address']}",
                  world_size=spec["num_processes"], rank=spec["process_id"])
        proc = spec["process_id"]
    else:
        kw = dict(init_method="env://")
        proc = int(e.get("RANK", "0"))
    if dev.type == "cuda":
        local = int(e["LOCAL_RANK"]) if "LOCAL_RANK" in e else proc % torch.cuda.device_count()
        torch.cuda.set_device(local)
    dist.init_process_group(backend or ("nccl" if dev.type == "cuda" else "gloo"), **kw)
    return True


def rank() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main_process() -> bool:
    """True on the process that owns host-side IO (logs, checkpoints, PNGs):
    rank 0, and every process without a process group."""
    return rank() == 0


def barrier() -> None:
    """Wait for every process (a no-op without a process group)."""
    if dist.is_initialized():
        dist.barrier()
