"""tools_dev/timing.py's choice of a profiling window: device_busy keeps
a window only when it holds a kernel record for each kernel launch the
host made in it, as the card's tracer can lose device records."""

import pytest

from trident_tpu_torch.tools_dev.timing import whole


@pytest.mark.parametrize("activities, kernels, launches, keep", [
    (0, 0, 5, False),         # every device record lost
    (4, 4, 5, False),         # one kernel record lost
    (5, 5, 5, True),
    (15, 10, 10, True),       # kernels and copies
    (12, 7, 10, False),       # copies kept, kernel records lost
    (2, 0, 0, True),          # copies only, no kernel launched
])
def test_whole(activities, kernels, launches, keep):
    assert whole(activities, kernels, launches) is keep
