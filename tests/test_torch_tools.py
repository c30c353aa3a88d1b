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


def test_profile_frame_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="CUDA"):
        profile_frame.main()
