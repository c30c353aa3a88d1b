"""The readers of the program's spans (``benchmark/harness/spans.py`` and the
seven metrics on it) on fabricated traces, and their entries in
``BENCHMARK.json``."""

import json
import re
import statistics

import pytest

from benchmark.harness import spec as S
from benchmark.harness.trace import Context, Event, Trace

SPEC = json.loads((S.ROOT / "BENCHMARK.json").read_text())
CELLS = {w["name"] for w in SPEC["workloads"]}
PHASES = ("forward", "backward", "optimizer")
HOST = [f"step_{p}_host_ms.train" for p in PHASES]
IDLE = [f"step_{p}_idle_ms.train" for p in PHASES]
NEW = HOST + IDLE + ["render_idle_ms.view"]
HOST_MS = [7.0, 9.0, 8.0, 11.0]  # median 8.5


def ev(name, start, end):
    return Event(name, float(start), float(end))


def ctx(host, device, unit_s, units=1, host_ms=HOST_MS):
    trace = Trace(units, 1.0, device, host, {e.name: 1.0 for e in device})
    return Context({}, {}, unit_s, trace, host_ms)


def read(name, c):
    return S.metric_reader(name).read(c)


def two_steps():
    """Two steps in the window (microseconds): each a ``bench.step`` of 100
    holding forward 40, backward 30 and optimizer 10, the rest the feed;
    the device busy 0-50 and 60-150 of the first, 200-230 of the second."""
    host, device = [ev("aten::randperm", 0, 5)], []
    for t in (0, 200):
        host += [ev("bench.step", t, t + 100), ev("tgtc.step.forward", t + 10, t + 50),
                 ev("tgtc.step.backward", t + 50, t + 80),
                 ev("tgtc.step.optimizer", t + 80, t + 90)]
    device += [ev("k1", 0, 50), ev("k3", 60, 150), ev("adam", 200, 230)]
    return host, device


def test_host_ms_split_the_step_by_the_spans_share():
    c = ctx(*two_steps(), unit_s=150e-6, units=2)
    got = {p: read(f"step_{p}_host_ms.train", c) for p in PHASES}
    med = statistics.median(HOST_MS)
    assert got == pytest.approx({"forward": 0.4 * med, "backward": 0.3 * med,
                                 "optimizer": 0.1 * med})
    assert sum(got.values()) == pytest.approx(0.8 * med)


def test_a_gap_that_straddles_two_phases_is_split_by_intersection():
    """One gap, 20-60: 20-30 under the forward, 30-55 under the backward,
    55-60 under none."""
    host = [ev("bench.step", 0, 100), ev("tgtc.step.forward", 0, 30),
            ev("tgtc.step.backward", 30, 55), ev("tgtc.step.optimizer", 70, 80)]
    device = [ev("k", 0, 20), ev("k", 60, 100)]
    c = ctx(host, device, unit_s=100e-6)  # busy 60 of 100: 40% idle, 0.04 ms
    assert read("step_forward_idle_ms.train", c) == pytest.approx(0.04 * 10 / 40)
    assert read("step_backward_idle_ms.train", c) == pytest.approx(0.04 * 25 / 40)
    assert read("step_optimizer_idle_ms.train", c) == 0.0


def test_idle_under_the_spans_and_outside_them_is_the_unit_s_idle():
    """The gaps 50-60, under the first step's backward, and 150-200, between
    the steps and under no span; the unprofiled unit longer than the
    profiled one."""
    host, device = two_steps()
    c = ctx(host, device, unit_s=200e-6, units=2)
    idle_unit_ms = c.idle_share() / 100 * c.unit_s * 1e3
    got = [read(n, c) for n in IDLE]
    assert got == pytest.approx([0.0, idle_unit_ms * 10 / 60, 0.0])
    outside = idle_unit_ms * 50 / 60
    assert sum(got) + outside == pytest.approx(idle_unit_ms)


def test_idle_is_clamped_at_zero_when_the_profiled_unit_is_longer():
    host, device = two_steps()
    c = ctx(host, device, unit_s=50e-6, units=2)  # busy 85 a unit > 50
    assert c.idle_share() < 0
    assert read("step_backward_idle_ms.train", c) == 0.0


def test_render_idle_counts_the_gaps_under_any_render_span():
    host = [ev("bench.frame", 0, 100), ev("tgtc.render.coarse", 0, 20),
            ev("tgtc.render.resample", 20, 30), ev("tgtc.render.fine", 30, 60),
            ev("bench.copy", 100, 120)]
    device = [ev("sigma", 5, 15), ev("sort", 25, 28), ev("k1", 40, 90), ev("copy", 110, 115)]
    c = ctx(host, device, unit_s=115e-6)  # busy 68: idle 47 of the unit
    # gaps 15-25 (coarse 5, resample 5), 28-40 (resample 2, fine 10), 90-110 (none)
    want = c.idle_share() / 100 * c.unit_s * 1e3 * 22 / 42
    assert read("render_idle_ms.view", c) == pytest.approx(want)


@pytest.mark.parametrize("name", NEW)
def test_a_trace_without_the_program_s_spans_reads_none(name):
    host = [ev("bench.step", 0, 100), ev("bench.frame", 0, 100), ev("aten::mm", 10, 20)]
    c = ctx(host, [ev("k", 0, 10), ev("k", 50, 60)], unit_s=100e-6)
    assert read(name, c) is None


@pytest.mark.parametrize("name", NEW)
def test_each_new_metric_has_its_entry_and_reader(name):
    entry = {m["name"]: m for m in SPEC["per_layer"]}[name]
    assert (S.ROOT / "benchmark" / "metrics" / f"{name}.py").is_file()
    assert callable(S.metric_reader(name).read)
    assert entry["workloads"] and set(entry["workloads"]) <= CELLS
    moves = {m["name"]: m for m in SPEC["end_to_end"]}[entry["moves"]]
    assert set(entry["workloads"]) <= set(moves["workloads"])
    assert entry["source"] == "device_trace" and entry["unit"] == "ms"


@pytest.mark.parametrize("name", NEW)
def test_each_reader_names_spans_the_program_opens(name):
    from tgtc_torch.utils.logging import SPANS

    source = (S.ROOT / "benchmark" / "metrics" / f"{name}.py").read_text().split('"""')[-1]
    named = set(re.findall(r'"(tgtc\.[a-z.]+)"', source))
    assert named and named <= set(SPANS), named
