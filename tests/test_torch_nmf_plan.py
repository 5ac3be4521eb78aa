"""Launch plans of the NMF kernels (``nmf_recon_plan``,
``nmf_mu_fused_plan``, ``nmf_update_plan``): pure functions of the shape
and the SM count, so they are checked here without a card. Over a grid of
shapes that includes the main path's (F = 688, K = 6144 and 7680, D = 201),
bench_100k's K = 115,200 and D up to the fused kernel's 6144, every split-K
plan must cut [0, K) into contiguous slices in order, cover F and D with its
tiles, fit one block's shared memory and a portable cluster, and both
split-K kernels must share their slices (so P sums in one order on both
paths). The update's plan must cover F and K with its tiles and keep its
shared memory fixed for every D, 8193 (past the fused kernel's limit)
included."""

import itertools

import numpy as np
import pytest
import torch

from exemplars_vc_tpu_torch.factorize import nmf_cuda
from exemplars_vc_tpu_torch.kernels.build import SMEM_LIMIT_BYTES

H100_SMS = 132
FS = (1, 13, 33, 688, 689, 4000, 5000)
KS = (1, 3, 16, 17, 130, 6144, 7680, 7681, 115_200)
DS = (1, 25, 201, 300, 1232, 1233, 3072, 3073, nmf_cuda.FUSED_MAX_D)
PLANS = {"nmf_recon": nmf_cuda.nmf_recon_plan, "nmf_mu_fused": nmf_cuda.nmf_mu_fused_plan}
UPDATE_DS = (1, 25, 201, 300, 6144, 8193)


def _check_slices(plan, K):
    b = plan["k_bounds"]
    assert len(b) == plan["split"] + 1
    assert b[0] == 0 and b[-1] == K
    assert all(lo < hi for lo, hi in zip(b, b[1:]))          # in order, none empty
    assert all(lo % 16 == 0 for lo in b[:-1])                  # whole staged slices


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("F", FS)
def test_plan_slices_tiles_and_limits(kernel, F):
    for K, D in itertools.product(KS, DS):
        plan = PLANS[kernel](F, K, D, H100_SMS)
        _check_slices(plan, K)
        split = plan["split"]
        assert 1 <= split <= nmf_cuda.MAX_CLUSTER
        assert plan["cluster"] == (split, 1, 1) and plan["grid"][0] == split
        assert plan["smem_bytes"] <= SMEM_LIMIT_BYTES
        bm, bn = plan["tile"]
        tm, tn = plan["thread_tile"]
        assert plan["threads"] == bm * bn // (tm * tn) and plan["threads"] % 32 == 0
        if kernel == "nmf_recon":
            # grid (split, D tiles, F tiles): every output once, no empty tile
            assert (plan["grid"][1] - 1) * bn < D <= plan["grid"][1] * bn
            assert (plan["grid"][2] - 1) * bm < F <= plan["grid"][2] * bm
        else:
            # grid (split, F tiles, 1); the kernel walks D in bn-wide chunks
            # and keeps the whole (D rounded up to 16) x TF P tile in shared
            # memory beside its staging ring
            assert (plan["grid"][1] - 1) * bm < F <= plan["grid"][1] * bm
            assert plan["grid"][2] == 1
            assert plan["smem_bytes"] >= 4 * (-(-D // 16) * 16) * bm


@pytest.mark.parametrize("K", (6144, 7680, 115_200))
def test_plans_fill_the_card_at_the_main_path_shape(K):
    """F = 688, D = 201: at least 132 CTAs for each kernel, one shared split."""
    recon = nmf_cuda.nmf_recon_plan(688, K, 201, H100_SMS)
    fused = nmf_cuda.nmf_mu_fused_plan(688, K, 201, H100_SMS)
    for plan in (recon, fused):
        assert int(np.prod(plan["grid"])) >= H100_SMS
    assert recon["k_bounds"] == fused["k_bounds"]
    assert fused["tile"][0] == 32 and fused["stages"] == 4


@pytest.mark.parametrize("F", FS)
def test_both_kernels_share_their_k_slices(F):
    for K, D in itertools.product(KS, (1, 201, nmf_cuda.FUSED_MAX_D)):
        assert (nmf_cuda.nmf_recon_plan(F, K, D, H100_SMS)["k_bounds"]
                == nmf_cuda.nmf_mu_fused_plan(F, K, D, H100_SMS)["k_bounds"])


def test_split_follows_the_card_and_stays_a_power_of_two():
    # many F tiles need no split; a small F takes a full cluster of 8
    assert nmf_cuda.nmf_recon_plan(5000, 7680, 201, H100_SMS)["split"] == 1
    assert nmf_cuda.nmf_recon_plan(4000, 7680, 201, H100_SMS)["split"] == 2
    assert nmf_cuda.nmf_recon_plan(688, 7680, 201, H100_SMS)["split"] == 8
    assert nmf_cuda.nmf_recon_plan(688, 7680, 201, 40)["split"] == 2
    for F, n_sms in itertools.product(FS, (8, 66, 132, 264)):
        assert nmf_cuda.nmf_mu_fused_plan(F, 7680, 201, n_sms)["split"] in (1, 2, 4, 8)
    # K shorter than a full cluster's slices: fewer CTAs, none without work
    assert nmf_cuda.nmf_recon_plan(688, 3, 201, H100_SMS)["k_bounds"] == (0, 3)
    assert nmf_cuda.nmf_recon_plan(688, 40, 201, H100_SMS)["k_bounds"] == (0, 16, 32, 40)
    assert nmf_cuda.nmf_recon_plan(688, 0, 201, H100_SMS)["k_bounds"] == (0, 0)


@pytest.mark.parametrize("D,tf", [(201, 32), (1232, 32), (1233, 16), (3072, 16), (3073, 8),
                                  (nmf_cuda.FUSED_MAX_D, 8)])
def test_fused_tile_shrinks_with_d(D, tf):
    """A wide D shrinks the F tile (and its staging ring) so the P tile still
    fits; every D the wrapper accepts gets a plan."""
    plan = nmf_cuda.nmf_mu_fused_plan(688, 7680, D, H100_SMS)
    assert plan["tile"][0] == tf and plan["smem_bytes"] <= SMEM_LIMIT_BYTES


def test_fused_plan_refuses_a_d_past_shared_memory():
    with pytest.raises(ValueError, match="shared memory"):
        nmf_cuda.nmf_mu_fused_plan(688, 7680, 6400, H100_SMS)


@pytest.mark.parametrize("F", FS)
def test_update_plan_tiles_and_limits(F):
    """Grid (K tiles, F tiles, 1): every output once, no empty tile; whole
    warps of 8 × 4 outputs; shared memory within one block's limit and the
    same for every D (the kernel stages D in slices)."""
    for K in KS:
        plans = [nmf_cuda.nmf_update_plan(F, K, D, H100_SMS) for D in UPDATE_DS]
        plan = plans[0]
        bm, bn = plan["tile"]
        tm, tn = plan["thread_tile"]
        assert (plan["grid"][0] - 1) * bn < K <= plan["grid"][0] * bn
        assert (plan["grid"][1] - 1) * bm < F <= plan["grid"][1] * bm
        assert plan["grid"][2] == 1
        assert plan["threads"] == bm * bn // (tm * tn) and plan["threads"] % 32 == 0
        assert plan["smem_bytes"] <= SMEM_LIMIT_BYTES
        assert all(p == plan for p in plans)


@pytest.mark.parametrize("K,ctas", [(6144, 528), (7680, 660), (115_200, 9900)])
def test_update_plan_at_the_main_path_shape(K, ctas):
    """F = 688, D = 201: 64 × 128 tiles of 256 threads, 11 F tiles; two CTAs'
    rings fit one SM's 228 KB of shared memory."""
    plan = nmf_cuda.nmf_update_plan(688, K, 201, H100_SMS)
    assert plan["tile"] == (64, 128) and plan["threads"] == 256 and plan["stages"] == 4
    assert plan["grid"][1] == 11 and plan["grid"][0] * plan["grid"][1] == ctas
    assert 2 * plan["smem_bytes"] <= 228 * 1024


def test_plan_packs_into_the_c_struct():
    plan = nmf_cuda.nmf_recon_plan(688, 7680, 201, H100_SMS)
    packed = nmf_cuda._pack(plan)
    assert (packed.bm, packed.bn, packed.threads, packed.stages, packed.split) == (
        *plan["tile"], plan["threads"], plan["stages"], plan["split"])
    assert (packed.grid_x, packed.grid_y, packed.grid_z) == plan["grid"]
    assert list(packed.k_bounds) == list(plan["k_bounds"])
    short = nmf_cuda._pack(nmf_cuda.nmf_recon_plan(688, 40, 201, H100_SMS))
    assert list(short.k_bounds) == [0, 16, 32, 40, 40, 40, 40, 40, 40]
    # the update has no split: one CTA a cluster, bounds the C entry ignores
    update = nmf_cuda.nmf_update_plan(689, 7681, 8193, H100_SMS)
    packed = nmf_cuda._pack(update)
    assert (packed.bm, packed.bn, packed.threads, packed.stages, packed.split) == (
        *update["tile"], update["threads"], update["stages"], 1)
    assert (packed.grid_x, packed.grid_y, packed.grid_z) == update["grid"]
    assert packed.smem_bytes == update["smem_bytes"]


def test_cpu_tensors_take_the_twins_whatever_the_plan():
    rng = np.random.default_rng(0)
    H = torch.as_tensor(rng.uniform(0, 0.05, (13, 40)).astype(np.float32))
    A = torch.as_tensor(np.abs(rng.standard_normal((40, 7))).astype(np.float32))
    Num = torch.as_tensor(np.abs(rng.standard_normal((13, 40))).astype(np.float32))
    bad = dict(nmf_cuda.nmf_recon_plan(13, 40, 7, H100_SMS), split=9)
    bad_update = dict(nmf_cuda.nmf_update_plan(13, 40, 7, H100_SMS), tile=(24, 128),
                      smem_bytes=SMEM_LIMIT_BYTES + 1024)
    fns = (nmf_cuda.nmf_recon, nmf_cuda.nmf_mu_fused, nmf_cuda.nmf_update)
    before = tuple(fn.launches for fn in fns)
    assert torch.equal(nmf_cuda.nmf_recon(H, A, plan=bad), H @ A)
    assert torch.equal(nmf_cuda.nmf_mu_fused(H, A, Num, plan=bad),
                       nmf_cuda.nmf_mu_fused_plain(H, A, Num))
    P = H @ A
    ref = nmf_cuda.nmf_update_plain(P, A, H, Num, 0.3)
    assert torch.equal(nmf_cuda.nmf_update(P, A, H, Num, 0.3, plan=bad_update), ref)
    Hin = H.clone()
    assert nmf_cuda.nmf_update(P, A, Hin, Num, 0.3, out=Hin, plan=bad_update) is Hin
    assert torch.equal(Hin, ref)
    assert tuple(fn.launches for fn in fns) == before
