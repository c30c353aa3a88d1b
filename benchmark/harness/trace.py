"""The traced window and what the per-layer readers read from it.

:func:`profile_units` runs a few units (steps or frames) under
``torch.profiler``, bracketed by short spin kernels on the device, and keeps
a window only where it is whole: every device operation was recorded a
multiple of the unit count (the profiler has been seen to drop launches on
the card, most often the last ones of a window). This is ``device_ms`` of
``chip_smoke.py`` (its spin brackets and its whole-window rule, three tries,
then each operation's mean recorded duration times its launches a unit),
frozen here. :func:`busy` is ``busy_us`` of ``tgtc_torch/tools/profile_frame.py``.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import math
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from benchmark.harness import work as W

SPIN = "spin_kernel"
SPANS = ("bench.step", "bench.fetch", "bench.frame", "bench.copy")


@dataclasses.dataclass
class Event:
    name: str
    start: float  # microseconds, the profiler's clock
    end: float


def busy(intervals: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(intervals):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                total += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        total += cur_end - cur_start
    return total


def _spin() -> None:
    for _ in range(4):
        torch.cuda._sleep(2000)


@dataclasses.dataclass
class Trace:
    units: int
    window_s: float             # the traced window's wall seconds
    device: List[Event]         # device operations, the spin brackets left out
    host: List[Event]           # the benchmark's spans and the program's top-level ops
    scale: Dict[str, float]     # per name: 1, or the correction of a window not whole

    @property
    def busy_s(self) -> float:
        return busy([(e.start, e.end) for e in self.device]) * 1e-6

    def seconds(self, match: Callable[[str], bool]) -> float:
        """Device seconds of the operations whose name ``match``es."""
        return sum((e.end - e.start) * self.scale[e.name] for e in self.device
                   if match(e.name)) * 1e-6


def profile_units(unit: Callable[[], None], units: int) -> Trace:
    """A window is whole where every device operation was recorded a whole
    number of times a unit, or, for a unit whose operations vary from unit
    to unit (Phase E's coherence term skips one step a cycle), where two
    windows recorded the same counts, the spin brackets whole in both."""
    from torch.profiler import ProfilerActivity, profile

    seen = []
    for attempt in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _spin()
            t0 = time.perf_counter()
            for _ in range(units):
                unit()
            torch.cuda.synchronize()
            window_s = time.perf_counter() - t0
            _spin()
            torch.cuda.synchronize()
        events = prof.events()
        host_names = {e.name for e in events if e.device_type != torch.autograd.DeviceType.CUDA}
        device, host, spins = [], [], 0
        for e in events:
            ev = Event(e.name, e.time_range.start, e.time_range.end)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # the device-side copies of host annotations are ranges, not work
                if getattr(e, "is_user_annotation", False) or e.name in host_names:
                    continue
                if SPIN in e.name:
                    spins += 1
                else:
                    device.append(ev)
            elif (e.name in SPANS or e.cpu_parent is None
                  or e.cpu_parent.name in SPANS):
                host.append(ev)
        counts = collections.Counter(e.name for e in device)
        if device and (all(c % units == 0 for c in counts.values())
                       or (spins == 8 and counts in seen)):
            return Trace(units, window_s, device, host, {n: 1.0 for n in counts})
        if spins == 8:
            seen.append(counts)
        print(f"[trace] window {attempt + 1} recorded {len(device)} device operations of "
              f"{len(counts)} names over {units} units, not a whole number a unit",
              file=sys.stderr, flush=True)
    if not device:
        raise RuntimeError("the profiler recorded no device operation")
    # each operation's mean recorded duration times its launches a unit
    scale = {n: math.ceil(c / units) * units / c for n, c in counts.items()}
    print("[trace] taking each operation's mean recorded duration times its launches a unit",
          file=sys.stderr, flush=True)
    return Trace(units, window_s, device, host, scale)


def breakdown(trace: Trace, top: int = 10) -> Dict[str, List]:
    """The device operations that took most time, and the longest idle gaps
    of the device, each named by the benchmark's span open on the host at the
    gap's start and the program's top-level op under it."""
    by_name = collections.defaultdict(float)
    for e in trace.device:
        by_name[e.name[:120]] += (e.end - e.start) * trace.scale[e.name] * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]

    merged: List[List[float]] = []
    for s, e in sorted((e.start, e.end) for e in trace.device):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    gaps = [(b[0] - a[1], a[1]) for a, b in zip(merged, merged[1:]) if b[0] > a[1]]
    gaps.sort(reverse=True)
    host = sorted(trace.host, key=lambda e: e.start)
    starts = [e.start for e in host]

    def label(t: float) -> str:
        span, op = "host", None
        for e in host[: bisect.bisect_right(starts, t)]:
            if e.start <= t <= e.end:
                if e.name in SPANS:
                    span = e.name
                elif op is None or e.start > op.start:
                    op = e
        return span if op is None else f"{span} > {op.name[:80]}"

    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[label(t), g * 1e-6] for g, t in gaps[:top]]}


@dataclasses.dataclass
class Context:
    """What a per-layer reader reads: the cell's configuration and work a
    unit, the unprofiled seconds a unit (same process), the trace, and the
    host milliseconds of step calls on an idle device (train cells)."""

    config: Dict
    work: Dict
    unit_s: float
    trace: Trace
    host_ms: Optional[List[float]] = None

    def device_s(self, patterns: Sequence[str]) -> Optional[float]:
        """Device seconds a unit of the operations whose name holds one of
        ``patterns``; None where none ran."""
        match = lambda n: any(p in n for p in patterns)
        if not any(match(e.name) for e in self.trace.device):
            return None
        return self.trace.seconds(match) / self.trace.units

    def roofline(self, kernel: str, patterns: Sequence[str]) -> Optional[float]:
        """``kernel``'s share of its roofline, %: its least time at the
        cell's work a unit over its device time a unit."""
        t = self.device_s(patterns)
        if t is None or kernel not in self.work["kernels"]:
            return None
        flop, nbytes = self.work["kernels"][kernel]
        return 100.0 * W.bound_s(flop, nbytes) / t

    def mfu(self) -> float:
        """The model's FLOP a unit over the unprofiled time a unit, % of the
        bf16 peak."""
        return 100.0 * self.work["model_flop"] / self.unit_s / W.PEAK_BF16_FLOPS

    def idle_share(self) -> float:
        """1 - busy device time a unit (profiled) / the unprofiled time a unit, %."""
        return 100.0 * (1.0 - self.trace.busy_s / self.trace.units / self.unit_s)
