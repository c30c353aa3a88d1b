"""tgtc_torch.tools: the host-side logic of the measurement scripts (the
measurements themselves need a card)."""

import pytest
import torch

from tgtc_torch.tools import profile_frame

torch.set_num_threads(1)


@pytest.mark.parametrize("intervals,busy", [
    ([], 0.0),
    ([(5.0, 6.0), (0.0, 2.0), (1.0, 3.0)], 4.0),  # overlap, gap, unsorted
    ([(0.0, 1.0), (1.0, 2.0)], 2.0),              # touching
    ([(0.0, 10.0), (2.0, 3.0)], 10.0),            # nested
])
def test_busy_time_is_the_union_of_intervals(intervals, busy):
    assert profile_frame.busy_us(intervals) == busy


def test_profile_frame_needs_a_card(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr("sys.argv", ["profile_frame"])  # not pytest's own arguments
    with pytest.raises(SystemExit, match="CUDA"):
        profile_frame.main()


@pytest.mark.parametrize("argv", [[], ["--c1"], ["--c2"], ["--e"]])
def test_profile_step_needs_a_card(monkeypatch, argv):
    from tgtc_torch.tools import profile_step

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    monkeypatch.setattr("sys.argv", ["profile_step"] + argv)
    with pytest.raises(SystemExit, match="CUDA"):
        profile_step.main()


@pytest.mark.parametrize("name,kind", [
    ("void flash_fwd_kernel<...>", "K6"),
    ("void at::native::index_reduce_func_cuda_kernel<...>", "index/scatter"),
    ("void at::native::indexFuncLargeIndex<int, int, unsigned int, 1, 1, -2, true>", "index/scatter"),
    ("void at::native::indexing_backward_kernel<float>", "index/scatter"),
    ("sm90_xmma_gemm_bf16bf16_bf16f32", "GEMM"),
    ("elementwise_kernel", "other"),
])
def test_kind_of_sorts_the_c2_kernels(name, kind):
    assert profile_frame.kind_of(name) == kind
