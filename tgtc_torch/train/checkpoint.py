"""Checkpoints — port of tgtc/train/checkpoint.py.

A checkpoint is one ``torch.save`` file per step, ``ckpt_<step>.pt``, of a
nested dict of tensors and plain values. Saves are atomic (a temporary file,
then ``os.replace``), the newest ``max_to_keep`` are kept, and
:meth:`CheckpointManager.save_device_async` saves a device-resident state
without stalling the caller: it takes an on-device ``clone`` snapshot and
leaves the device→host copy and the write to one background thread, with at
most 2 saves pending. Under a process group only rank 0 writes (the states
are replicated, so its copy is the whole truth); every rank restores from the
shared directory.
"""

from __future__ import annotations

import os
import re
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, List, Optional

import torch

from tgtc_torch.parallel.distributed import is_main_process

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _tree_map(fn: Callable[[torch.Tensor], Any], tree: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._keep = max_to_keep
        self._writer: Optional[ThreadPoolExecutor] = None
        self._pending: List[Future] = []

    def path(self, step: int) -> str:
        return os.path.join(self._dir, f"ckpt_{step:08d}.pt")

    def steps(self) -> List[int]:
        """Steps on disk, oldest first (finished writes only)."""
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self._dir)) if m)

    def _write(self, step: int, state: Any, ready=None) -> None:
        if ready is not None:  # the snapshot's clone, on the caller's stream
            ready.synchronize()
        host = _tree_map(lambda t: t.detach().cpu(), state)
        tmp = self.path(step) + f".{os.getpid()}.tmp"
        torch.save(host, tmp)
        os.replace(tmp, self.path(step))
        for old in self.steps()[:-self._keep] if self._keep else []:
            os.remove(self.path(old))

    def save(self, step: int, state: Any) -> None:
        """Write ``state`` at ``step`` now (after any pending async saves);
        a no-op off rank 0."""
        if not is_main_process():
            return
        self.wait()
        self._write(step, state)

    def save_device_async(self, step: int, state: Any, wait: bool = False) -> None:
        """Save ``state`` (device tensors) without blocking: snapshot it on the
        device now (``clone``, ordered on the current stream before any later
        in-place update), fetch and write it on the background thread.
        Saves stay in step order; a third pending save waits for the oldest.
        A no-op off rank 0."""
        if not is_main_process():
            return
        self._drain_done()
        if self._writer is None:
            self._writer = ThreadPoolExecutor(max_workers=1,
                                              thread_name_prefix="tgtc-torch-ckpt")
        while len(self._pending) >= 2:
            self._pending.pop(0).result()
        snap = _tree_map(lambda t: t.detach().clone(), state)
        ready = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            ready = torch.cuda.Event()
            ready.record()
        self._pending.append(self._writer.submit(self._write, step, snap, ready))
        if wait:
            self.wait()

    def _drain_done(self) -> None:
        """Drop finished saves, re-raising any background failure."""
        while self._pending and self._pending[0].done():
            self._pending.pop(0).result()

    def wait(self) -> None:
        """Block until every pending save is on disk."""
        while self._pending:
            self._pending.pop(0).result()

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, map_location=None) -> Any:
        """The saved object at ``step`` (default: the latest)."""
        if step is None:
            step = self.latest_step()
        else:
            self.wait()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self._dir}")
        return torch.load(self.path(step), map_location=map_location, weights_only=True)

    def close(self) -> None:
        self.wait()
        if self._writer is not None:
            self._writer.shutdown(wait=True)
            self._writer = None
