"""The frozen eigenproblem count and the peak table, against rows worked
by hand."""

import pytest

from gpu_bench.roofline import eigh

H100 = eigh.PEAKS["NVIDIA H100 80GB HBM3"]


@pytest.mark.parametrize("d, ops, nbytes", [
    (54, 1_417_176, 47_088),      # 9 * 54^3; 8 * (2 * 54^2 + 54)
    (72, 3_359_232, 83_520),
    (78, 4_270_968, 97_968),
    (104, 10_123_776, 173_888),
])
def test_counts_by_hand(d, ops, nbytes):
    assert eigh.flops(d) == ops
    assert eigh.nbytes(d, 8) == nbytes


def test_least_time_takes_the_larger_bound():
    # one RFO step (D = 54) and one band (D = 72): 4,776,408 operations
    # over 67e12 /s = 7.1290e-8 s; 130,608 bytes over 3.35e12 B/s = 3.899e-8
    t = eigh.least_seconds([(1, 54), (1, 72)], 8, H100)
    assert t == pytest.approx(4_776_408 / 67e12, rel=1e-12)
    # a million 2x2 problems are bound by bytes, not operations
    t = eigh.least_seconds([(10 ** 6, 2)], 8, H100)
    assert t == pytest.approx(10 ** 6 * 8 * 10 / 3.35e12, rel=1e-12)


def test_peaks_are_the_data_sheet():
    assert H100 == {"flop_per_s": 67e12, "byte_per_s": 3.35e12}
