"""The solve's work counts, by hand."""

import pytest

from benchmark.harness import roofline


@pytest.mark.parametrize("F,K,D,n,res", [(600, 15360, 201, 130, False),
                                         (1361, 15872, 513, 150, True), (16, 15360, 201, 10, False)])
def test_work_counts_by_hand(F, K, D, n, res):
    fkd = F * K * D
    # numerator, n + 1 reconstructions, n denominators, the conversion
    flops = 2 * fkd + (n + 1) * 2 * fkd + n * 2 * fkd + 3 * F * K * n + 2 * fkd
    if res:
        flops += 2 * fkd + 2 * F * D
    assert roofline.solve_work(F, K, D, n, res) == (flops, 4 * (2 * F * D + 2 * K * D))


def test_least_time_takes_the_larger_bound():
    flops, nbytes = roofline.solve_work(600, 15360, 201, 130)
    assert flops == 2 * 600 * 15360 * 201 * 263 + 3 * 600 * 15360 * 130
    assert roofline.least_seconds(flops, nbytes) == flops / 67e12
    assert roofline.least_seconds(0, 3.35e12) == 1.0
