"""On the card: every cell at the tiny size runs its traced path (the
profiler's window, the per-layer readers, the breakdown), and the kernels'
shares of their rooflines and of the peak stay at or under 100%. Skips
without a card; the repository's tier-1 run (``pytest tests/``) does not collect it."""

import time

import pytest
import torch

from benchmark.run import judge, run_cell
from benchmark.tests.tiny import tiny_cell

CELLS = ["nerf-fern.train", "nerf-fern.view", "stylefield-fern.view", "stylefield-fern.distill"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = tiny_cell(name)
    res = run_cell(cell, 2**31 + 17, 0.5, True, "cuda", time.perf_counter())
    assert set(res["metrics"]) == set(cell.per_layer)
    for k, v in res["metrics"].items():
        if "roofline" in k or "mfu" in k:
            assert 0 < v <= 100, (k, v)
    assert 0 < res["trace"]["busy_s"] <= res["trace"]["window_s"]
    assert res["trace"]["breakdown"]["device_ops"]
    assert judge(res["readings"]["program"], cell.workload["limits"])[1]
