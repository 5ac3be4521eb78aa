"""The DTW wavefront kernel's launch plan (pure Python, checked here on the
CPU): rows a lane (1 up to 4096 rows, else 8), warps a CTA and the cluster
cover every Ta the wrappers take, a pair spreads over up to n_sms // n CTAs
(at most 8), and a CPU tensor takes the twin."""

import numpy as np
import pytest
import torch

from exemplars_vc_tpu_torch.align import dtw_cuda
from exemplars_vc_tpu_torch.align.dtw import pairwise_sqdist

N_SMS = 132


def _check_covers(plan, n, ta):
    r, wpc, cl = plan["rows_per_lane"], plan["warps_per_cta"], plan["cluster"]
    assert r == (1 if ta <= dtw_cuda.DTW_ONE_ROW_MAX_TA else 8)
    assert 1 <= wpc <= dtw_cuda.DTW_MAX_WARPS and 1 <= cl <= dtw_cuda.DTW_MAX_CLUSTER
    assert plan["warps"] == -(-ta // (32 * r))
    assert cl * wpc * 32 * r >= ta                 # every row has a lane
    assert (cl - 1) * wpc < plan["warps"]          # no CTA without a row
    assert plan["threads"] == 32 * wpc and plan["grid"] == (n * cl, 1, 1)
    assert plan["chunk"] == {1: 16, 8: 4}[r] == dtw_cuda.DTW_CHUNK[r]


@pytest.mark.parametrize("ta", [1, 2, 31, 32, 33, 511, 512, 513, 683, 1024, 1025, 1408, 1409,
                                2048, 4095, 4096, 4097, 8192, 12345, 16384, 16385,
                                19_370, 19_371, 32_767, dtw_cuda.MAX_TA])
@pytest.mark.parametrize("n", [1, 8, 200])
def test_plan_covers_every_accepted_ta(n, ta):
    plan = dtw_cuda.dtw_wavefront_plan(n, ta, N_SMS)
    _check_covers(plan, n, ta)
    target = min(8, N_SMS // n)
    if ta <= 16 * 32 * target:                     # one row a lane fits the target cluster
        assert plan["rows_per_lane"] == 1 and plan["cluster"] <= target


def test_plan_at_the_main_path_and_mcd_shapes():
    main = dtw_cuda.dtw_wavefront_plan(8, 1408, N_SMS)
    assert (main["rows_per_lane"], main["cluster"], main["warps_per_cta"]) == (1, 8, 6)
    assert main["grid"] == (64, 1, 1)
    mcd = dtw_cuda.dtw_wavefront_plan(1, 683, N_SMS)
    assert (mcd["rows_per_lane"], mcd["cluster"], mcd["warps_per_cta"]) == (1, 8, 3)
    many = dtw_cuda.dtw_wavefront_plan(200, 1408, N_SMS)     # more pairs than SMs
    assert (many["rows_per_lane"], many["cluster"], many["warps_per_cta"]) == (1, 3, 15)


def test_max_ta_is_the_first_designs_range():
    """Every Ta the widest plan reaches (8 CTAs x 16 warps x 32 lanes x 8
    rows) is taken, the first design's 19,370 among them, and no more."""
    assert dtw_cuda.MAX_TA == 8 * 16 * 32 * 8 == 32_768
    assert dtw_cuda.MAX_TA == (dtw_cuda.DTW_MAX_CLUSTER * dtw_cuda.DTW_MAX_WARPS * 32 * 8)
    assert dtw_cuda.fits_plan(1) and dtw_cuda.fits_plan(19_370) and dtw_cuda.fits_plan(32_768)
    assert not dtw_cuda.fits_plan(0) and not dtw_cuda.fits_plan(32_769)
    with pytest.raises(ValueError, match="outside"):
        dtw_cuda.dtw_wavefront_plan(1, 32_769, N_SMS)


# (pairs, Ta) -> (rows a lane, cluster, warps a CTA): the cluster follows the
# SMs a pair gets and widens where a CTA would need more than 16 warps; one
# row a lane up to 4096 rows, eight above
@pytest.mark.parametrize("n,ta,want", [
    (3, 1409, (1, 8, 6)), (40, 1409, (1, 3, 15)), (132, 512, (1, 1, 16)),
    (132, 4096, (1, 8, 16)), (1, 4097, (8, 6, 3)), (1, 19_370, (8, 8, 10)),
    (1, dtw_cuda.MAX_TA, (8, 8, 16)), (8, dtw_cuda.MAX_TA, (8, 8, 16)),
])
def test_plan_at_chosen_shapes(n, ta, want):
    plan = dtw_cuda.dtw_wavefront_plan(n, ta, N_SMS)
    _check_covers(plan, n, ta)
    assert (plan["rows_per_lane"], plan["cluster"], plan["warps_per_cta"]) == want


@pytest.mark.parametrize("ta", [0, -1, dtw_cuda.MAX_TA + 1, 65_536])
def test_impossible_plans_raise(ta):
    with pytest.raises(ValueError, match="outside"):
        dtw_cuda.dtw_wavefront_plan(3, ta, N_SMS)


def test_cpu_tensors_take_the_twin_whatever_the_plan():
    """A CPU tensor runs the twin: no plan is made and nothing launches."""
    rng = np.random.default_rng(3)
    fa = torch.as_tensor(rng.standard_normal((2, 40, 5)).astype(np.float32))
    fb = torch.as_tensor(rng.standard_normal((2, 33, 5)).astype(np.float32))
    C = pairwise_sqdist(fa, fb).contiguous()
    lens = torch.tensor([[40, 33], [17, 9]], dtype=torch.int32)
    before = dtw_cuda.dtw_wavefront.launches
    got = dtw_cuda.dtw_wavefront(C, lens)
    ref = dtw_cuda.dtw_wavefront_plain(C, lens)
    assert dtw_cuda.dtw_wavefront.launches == before
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
