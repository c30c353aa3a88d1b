"""Multi-GPU data parallelism over ``torch.distributed`` — port of
tgtc/parallel: one process per GPU, parameters replicated, every batch
split by rows over the processes, gradients all-reduced once a step.
Phases A and E (and the C1 step) take a :class:`DataGroup`; the pipeline's
multi-process schedule is ``Pipeline._run_multihost``."""

from tgtc_torch.parallel.distributed import (
    barrier,
    discover_cluster_env,
    is_main_process,
    maybe_initialize_distributed,
    multi_process_launch,
    rank,
    world_size,
)
from tgtc_torch.parallel.mesh import DataGroup

__all__ = ["DataGroup", "barrier", "discover_cluster_env", "is_main_process",
           "maybe_initialize_distributed", "multi_process_launch", "rank", "world_size"]
