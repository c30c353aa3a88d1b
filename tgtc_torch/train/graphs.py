"""A training step's forward and backward replayed from two CUDA graphs on
one memory pool: the step layer's mechanism, shared by Phase A's fused step
(:class:`~tgtc_torch.train.nerf_trainer.TrainStep`) and C1's
(:class:`~tgtc_torch.train.transformer2d.TransformerTrainStep`).

* A step hands :class:`StepGraphs` its batch key, its inputs, a
  ``forward(*inputs) -> (loss, metrics)`` and a ``grads(loss) -> [grad]``.
  A key's first call runs them eagerly (the warm-up: library handles, lazy
  kernel loads), its second captures them into the two graphs and replays
  them, every later call replays. A new key drops the graphs held.
* The key is the caller's (what the graphs read in place: modules, rays)
  plus the generator, the inputs' shapes, dtypes and devices (and which are
  None), and the determinism flags.
* The inputs are copied into the forward graph's static buffers before each
  replay. A generator, where given, is registered with both graphs: a
  replay reads its seed and offset then, and moves the offset as the eager
  step would.
* The metrics are stacked inside the forward graph and copied out after
  each replay; the gradients are the backward graph's outputs, overwritten
  by the next replay. The update stays with the caller, eager.
* ``captures`` and ``replays`` count the two events.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from tgtc_torch.utils.logging import span

Metrics = Dict[str, torch.Tensor]
Forward = Callable[..., Tuple[torch.Tensor, Metrics]]
Grads = Callable[[torch.Tensor], List[torch.Tensor]]


def loss_and_grad(forward: Forward, grads: Grads, inputs: Sequence[Optional[torch.Tensor]]
                  ) -> Tuple[Metrics, List[torch.Tensor]]:
    """The eager step: ``forward(*inputs)`` under the ``tgtc.step.forward``
    span, ``grads`` of its loss under ``tgtc.step.backward``."""
    with span("tgtc.step.forward"):
        loss, metrics = forward(*inputs)
    with span("tgtc.step.backward"):
        g = grads(loss)
    return metrics, g


@dataclasses.dataclass
class _Captured:
    """One key's graphs: ``forward`` reads the static ``inputs`` and writes
    the metrics ``names``, stacked in ``metrics``; ``backward`` writes
    ``grads``. Replayed in that order, which is the order of capture."""

    forward: torch.cuda.CUDAGraph
    backward: torch.cuda.CUDAGraph
    inputs: List[Optional[torch.Tensor]]
    names: Tuple[str, ...]
    metrics: torch.Tensor
    grads: List[torch.Tensor]


class StepGraphs:
    """``graphs(key, inputs, forward, grads, generator=None) -> (metrics,
    grads)``: :func:`loss_and_grad`, from CUDA graphs after a key's first
    call (the module's docstring). For tensors on the card."""

    def __init__(self):
        self.captures = self.replays = 0
        self._key: Optional[tuple] = None  # the last call's key
        self._captured: Optional[_Captured] = None

    def __call__(self, key: tuple, inputs: Sequence[Optional[torch.Tensor]], forward: Forward,
                 grads: Grads, generator: Optional[torch.Generator] = None
                 ) -> Tuple[Metrics, List[torch.Tensor]]:
        key = (*key, generator,
               *(None if t is None else (t.shape, t.dtype, t.device) for t in inputs),
               torch.are_deterministic_algorithms_enabled(), torch.backends.cudnn.deterministic)
        if key != self._key:
            self._key, self._captured = key, None
            return loss_and_grad(forward, grads, inputs)
        if self._captured is None:
            self._captured = _capture(inputs, forward, grads, generator)
            self.captures += 1
        c = self._captured
        with span("tgtc.step.forward"):
            for static, t in zip(c.inputs, inputs):
                if t is not None:
                    static.copy_(t)
            c.forward.replay()
            metrics = c.metrics.clone()
        with span("tgtc.step.backward"):
            c.backward.replay()
        self.replays += 1
        return dict(zip(c.names, metrics.unbind())), c.grads


def _capture(inputs: Sequence[Optional[torch.Tensor]], forward: Forward, grads: Grads,
             generator: Optional[torch.Generator]) -> _Captured:
    """Capture ``forward`` on static copies of ``inputs``' shapes and
    ``grads`` of its loss. Nothing runs: the parameters and the generator's
    seed and offset are as they were. ``thread_local``: the loops'
    prefetchers and asynchronous checkpoint copies run in other threads
    meanwhile."""
    fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    if generator is not None:
        for graph in (fwd, bwd):
            graph.register_generator_state(generator)
    static = [None if t is None else torch.empty_like(t) for t in inputs]
    pool = torch.cuda.graph_pool_handle()
    with torch.cuda.graph(fwd, pool=pool, capture_error_mode="thread_local"):
        loss, metrics = forward(*static)
        stacked = torch.stack(list(metrics.values()))
    with torch.cuda.graph(bwd, pool=pool, capture_error_mode="thread_local"):
        out = grads(loss)
    return _Captured(fwd, bwd, static, tuple(metrics), stacked, out)
