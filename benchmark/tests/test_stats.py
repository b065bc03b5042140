"""The 95th percentile over all batches, and the union of intervals and
the labelled idle gaps, on fixed inputs."""
from __future__ import annotations

import pytest

from benchmark.drivers.serve import p95
from benchmark.trace import Slice, idle_gaps, union_s


def test_p95_over_every_batch():
    values = list(range(1, 101))           # 1..100
    # inclusive method: position 0.95 x 99 = 94.05 -> 95 + 0.05
    assert p95(values) == pytest.approx(95.05)
    assert p95([3.0]) == 3.0
    with pytest.raises(RuntimeError):
        p95([])


def test_union_counts_an_overlap_once():
    busy, merged = union_s([(0, 10), (5, 20), (30, 40), (45, 60)], 0, 50)
    assert busy == pytest.approx(35e-6)    # [0, 20] + [30, 40] + [45, 50]
    assert merged == [[0, 20], [30, 40], [45, 50]]


def test_gaps_take_the_innermost_open_span():
    _, merged = union_s([(0, 10), (20, 30)], 0, 40)
    gaps = idle_gaps(merged, 0, 40, [("loop", 0, 40), ("decode", 12, 18),
                                     ("submit", 31, 33)])
    # [10, 20] starts in "loop" only (decode opens at 12); [30, 40] at 30
    assert gaps == {"loop": pytest.approx(20e-6)}
    gaps = idle_gaps(merged, 0, 40, [("loop", 0, 40), ("decode", 9, 18)])
    assert gaps == {"decode": pytest.approx(10e-6),
                    "loop": pytest.approx(10e-6)}


def test_slice_reads_busy_idle_and_groups():
    kernels = [("conv_fprop", 0, 10), ("memcpy", 5, 15),
               ("mel_fft_kernel", 20, 25)]
    s = Slice(kernels, [("submit", 15, 30)], 0, 40, units=2)
    assert s.busy_s == pytest.approx(20e-6)
    assert s.window_s == pytest.approx(40e-6)
    assert s.gaps == {"submit": pytest.approx(5e-6 + 15e-6)}
    assert s.device_s("mel_fft") == (pytest.approx(5e-6), 1)
    # "fft" is a convolution group's piece; the mel kernel is excluded
    assert s.device_s("conv", "fft", exclude=("mel_fft",)) == (
        pytest.approx(10e-6), 1)
    assert s.top_ops(1) == [("conv_fprop", pytest.approx(10e-6))]
