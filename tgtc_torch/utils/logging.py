"""JSONL metrics, wall-clock segment timers and profiler spans — port of
tgtc/utils/logging.py (the spans are the port's own).

One line ``{"step": step, **scalars}`` per log step in ``<log_dir>/<name>.jsonl``
(the schema ``tgtc/tools/jsonl2tb.py`` reads) and a console line. Scalars
that are device tensors are fetched in one ``torch.stack(...).cpu()``: one
device→host copy (and one sync) per log line, not one per metric. Under a
process group only rank 0 creates the file, writes and prints.

:func:`span` marks a phase of a training step or a stage of a rendered ray
block on ``torch.profiler``'s clock, so that a trace puts each device idle
gap down to the phase the host was in. The profiler keeps the spans and
writes them out (``export_chrome_trace``); with it off a span costs one
flag read.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Any, ContextManager, Dict, Mapping, Optional

import torch

from tgtc_torch.parallel.distributed import is_main_process


def fetch_scalars(metrics: Mapping[str, Any]) -> Dict[str, float]:
    """``metrics`` with every one-element tensor fetched as a float (all in
    one stack, so one device→host copy) and plain numbers kept; other
    values are dropped."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor) and v.numel() == 1]
    fetched: Dict[str, float] = {}
    if keys:
        vals = torch.stack([metrics[k].detach().float().reshape(()) for k in keys]).cpu()
        fetched = dict(zip(keys, vals.tolist()))
    return {k: fetched[k] if k in fetched else float(v) for k, v in metrics.items()
            if k in fetched or isinstance(v, (int, float))}


class MetricsLogger:
    def __init__(self, log_dir: Optional[str] = None, name: str = "train", print_fn=print):
        self._fh = None
        self._print = print_fn
        if log_dir and is_main_process():
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"{name}.jsonl"), "a")

    def log(self, step: int, metrics: Mapping[str, Any], prefix: str = "") -> Dict[str, float]:
        """Write one line (on rank 0); returns the scalars, on every rank."""
        scalars = fetch_scalars(metrics)
        if not is_main_process():
            return scalars
        if self._fh:
            self._fh.write(json.dumps({"step": step, **scalars}) + "\n")
            self._fh.flush()
        if self._print is not None:
            parts = " ".join(f"{k}: {v:.5g}" for k, v in scalars.items())
            self._print(f"[{prefix}] step {step} {parts}")
        return scalars

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None


class SegmentTimer:
    """Accumulate wall-clock per named segment; report + reset on demand."""

    def __init__(self):
        self._acc = defaultdict(float)
        self._t0 = None
        self._current = None

    def start(self, name: str) -> None:
        now = time.perf_counter()
        if self._current is not None:
            self._acc[self._current] += now - self._t0
        self._current, self._t0 = name, now

    def stop(self) -> None:
        if self._current is not None:
            self._acc[self._current] += time.perf_counter() - self._t0
            self._current = None

    def report_and_reset(self) -> Dict[str, float]:
        self.stop()
        out = dict(self._acc)
        self._acc.clear()
        return out


# Spans of one step or one ray block are siblings: none encloses the others,
# so each stays a direct child of whatever range encloses the call (a trace
# that keeps only one level under its own ranges keeps them all).
SPANS = (
    "tgtc.step.draw",         # a step drawing its own randoms (seeding its generator in C1)
    "tgtc.step.forward",      # the batch's gathers, the passes and the loss
    "tgtc.step.backward",     # torch.autograd.grad, the wait on autograd's device thread
    "tgtc.step.optimizer",    # the update: all-reduce, Adam, the schedule and counters
    "tgtc.render.coarse",     # a block's latents, depths, coarse σ and weights
    "tgtc.render.resample",   # sample_pdf, the sort, the budget, shared depths
    "tgtc.render.fine",       # the fine pass and its composite
)

_OFF = contextlib.nullcontext()


def span(name: str) -> ContextManager:
    """``torch.profiler.record_function(name)`` while the profiler records,
    else a shared no-op context (one flag read; where this torch has no
    flag, every span records)."""
    if getattr(torch.autograd.profiler, "_is_profiler_enabled", True):
        return torch.profiler.record_function(name)
    return _OFF
