"""The measured windows: a closed loop of training steps or of frames, timed on
the host's clock and closed by a device sync.

A train cell (``kind == "train"``) gives ``step() -> loss`` (one step through
the program, the loss a device scalar, no sync) and ``fetch_every``; a view
cell (``kind == "view"``) gives ``frame() -> outputs`` (one call of the
program) and ``to_host(outputs)``. The loops open the benchmark's own spans
around each call into the program: ``bench.step``, ``bench.fetch``,
``bench.frame``, ``bench.copy``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch
from torch.profiler import record_function


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def step_unit(cell):
    """One step of a train cell inside its span; returns the loss."""
    def step():
        with record_function("bench.step"):
            return cell.step()
    return step


def frame_unit(cell):
    """One frame of a view cell, the call and the copy each in its span;
    returns the host outputs."""
    def frame():
        with record_function("bench.frame"):
            out = cell.frame()
        with record_function("bench.copy"):
            return cell.to_host(out)
    return frame


def train_window(cell, seconds: float) -> Dict:
    """Steps until ``seconds`` have passed on the host's clock, one fetch of
    the losses every ``cell.fetch_every`` steps; the window closes with a
    device sync. Returns the step count, the window's seconds and every
    step's loss (the last partial window's fetched after the close)."""
    losses: List[float] = []
    pending: List[torch.Tensor] = []
    step = step_unit(cell)
    _sync(cell.device)
    t0 = time.perf_counter()
    steps = 0
    while True:
        pending.append(step())
        steps += 1
        if len(pending) == cell.fetch_every:
            with record_function("bench.fetch"):
                losses += torch.stack(pending).float().cpu().tolist()
            pending = []
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(cell.device)
    t1 = time.perf_counter()
    if pending:
        losses += torch.stack(pending).float().cpu().tolist()
    return {"units": steps, "seconds": t1 - t0, "losses": losses}


def view_window(cell, seconds: float) -> Dict:
    """Frames until ``seconds`` have passed, each from the call to its outputs
    on the host; the window closes when the last frame is on the host.
    Returns the frame count, the window's seconds, each frame's latency and
    the frames' host outputs."""
    frames, latencies = [], []
    frame = frame_unit(cell)
    _sync(cell.device)
    t0 = time.perf_counter()
    while True:
        ts = time.perf_counter()
        frames.append(frame())
        te = time.perf_counter()
        latencies.append(te - ts)
        if te - t0 >= seconds:
            break
    _sync(cell.device)
    return {"units": len(frames), "seconds": time.perf_counter() - t0,
            "latencies": latencies, "frames": frames}


def host_step_ms(cell, steps: int) -> List[float]:
    """Host milliseconds of ``steps`` step calls, each started on an idle
    device (a sync before the call, none inside it)."""
    out = []
    step = step_unit(cell)
    for _ in range(steps):
        _sync(cell.device)
        t0 = time.perf_counter()
        step()
        out.append((time.perf_counter() - t0) * 1e3)
    _sync(cell.device)
    return out
