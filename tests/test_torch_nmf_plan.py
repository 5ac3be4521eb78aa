"""Launch plans of the NMF kernels (``nmf_recon_plan``,
``nmf_mu_fused_plan``, ``nmf_update_plan``): pure functions of the shape
and the SM count, so they are checked here without a card. Over a grid of
shapes that includes the main path's (F = 688, K = 6144 and 7680, D = 201),
bench_100k's K = 115,200 and D up to the fused kernel's 6144, the recon's
pieces must cut [0, K) into contiguous slices in order, its CTAs must
compute every (tile, piece) unit exactly once, and the fused kernel's
cluster ranks must be the recon's groups of pieces (so P sums in one order
on both paths). At the served shapes (K = 14,336: a stream chunk's F = 16,
a request's F = 620 at D = 1025, and the four-rank shard) every SM gets
about the same work. The update's plan must cover F and K with its tiles
and keep its shared memory fixed for every D, 8193 (past the fused
kernel's limit) included."""

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
# the served recon shapes: a stream chunk, a WORLD request, their four-rank shards
SERVED = [(16, 14_336, 201), (620, 14_336, 1025), (16, 3584, 201), (620, 3584, 1025)]


def _check_pieces(plan, K):
    b = plan["piece_bounds"]
    assert len(b) == plan["pieces"] + 1
    assert b[0] == 0 and b[-1] == K
    if K:
        assert all(lo < hi for lo, hi in zip(b, b[1:]))      # in order, none empty
    else:
        assert b == (0, 0)                                    # one empty piece
    assert all(lo % 16 == 0 for lo in b[:-1])                  # whole staged slices
    g = plan["groups"]
    assert 1 <= g <= nmf_cuda.MAX_CLUSTER and g & (g - 1) == 0 and g <= plan["pieces"]
    assert plan["k_bounds"] == tuple(b[r * plan["pieces"] // g] for r in range(g + 1))


def _unit_loads(plan):
    """Each CTA's units, checked to be every unit exactly once; returns the
    staged slices each CTA reduces."""
    T = plan["tiles"][0] * plan["tiles"][1]
    seen = []
    loads = []
    b = plan["piece_bounds"]
    for c in range(plan["grid"][0]):
        units = list(nmf_cuda.recon_units(plan, c))
        seen += units
        loads.append(sum(-(-(b[u // T + 1] - b[u // T]) // 16) for u in units))
    assert sorted(seen) == list(range(plan["units"])) == list(range(T * plan["pieces"]))
    return loads


@pytest.mark.parametrize("kernel", sorted(PLANS))
@pytest.mark.parametrize("F", FS)
def test_plan_slices_tiles_and_limits(kernel, F):
    for K, D in itertools.product(KS, DS):
        plan = PLANS[kernel](F, K, D, H100_SMS)
        _check_pieces(plan, K)
        assert plan["smem_bytes"] <= SMEM_LIMIT_BYTES
        bm, bn = plan["tile"]
        tm, tn = plan["thread_tile"]
        assert plan["threads"] == bm * bn // (tm * tn) and plan["threads"] % 32 == 0
        if kernel == "nmf_recon":
            # tiles of 16·TM rows by 208 columns cover F and D, none empty;
            # every (tile, piece) unit on one CTA; at most one CTA an SM
            tf, td = plan["tiles"]
            assert bm == 16 * tm and (tf - 1) * bm < F <= tf * bm
            assert (td - 1) * bn < D <= td * bn
            assert plan["split"] == 1 and plan["grid"][1:] == (1, 1)
            assert 1 <= plan["grid"][0] <= H100_SMS
            assert min(_unit_loads(plan)) >= 1 or K == 0
            assert plan["workspace_floats"] == plan["units"] * tm * tn * plan["threads"]
        else:
            # grid (split, F tiles, 1), one cluster rank a group of the
            # recon's pieces; the kernel walks D in bn-wide chunks and keeps
            # the whole (D rounded up to 16) x TF P tile in shared memory
            # beside its staging ring
            split = plan["split"]
            assert split == plan["groups"] and plan["cluster"] == (split, 1, 1)
            assert plan["grid"][0] == split
            assert (plan["grid"][1] - 1) * bm < F <= plan["grid"][1] * bm
            assert plan["grid"][2] == 1
            assert plan["smem_bytes"] >= 4 * (-(-D // 16) * 16) * bm


@pytest.mark.parametrize("K", (6144, 7680, 115_200))
def test_plans_fill_the_card_at_the_main_path_shape(K):
    """F = 688, D = 201: every SM has a recon CTA and the fused kernel has at
    least 132 CTAs, its slices the recon's groups."""
    recon = nmf_cuda.nmf_recon_plan(688, K, 201, H100_SMS)
    fused = nmf_cuda.nmf_mu_fused_plan(688, K, 201, H100_SMS)
    assert recon["grid"][0] == H100_SMS and recon["units"] >= H100_SMS
    assert int(np.prod(fused["grid"])) >= H100_SMS
    assert recon["k_bounds"] == fused["k_bounds"]
    assert fused["tile"][0] == 32 and fused["stages"] == 4


@pytest.mark.parametrize("F,K,D", SERVED)
def test_recon_plan_gives_every_sm_work(F, K, D):
    """At least as many units as SMs, one CTA on each, and no CTA more than
    2 % (and one slice) above an even share of the staged slices."""
    plan = nmf_cuda.nmf_recon_plan(F, K, D, H100_SMS)
    loads = _unit_loads(plan)
    assert plan["units"] >= H100_SMS and plan["grid"][0] == H100_SMS
    T = plan["tiles"][0] * plan["tiles"][1]
    even = T * -(-K // 16) / H100_SMS
    assert min(loads) >= 1 and max(loads) <= 1.02 * even + 1, (max(loads), even)


@pytest.mark.parametrize("D,waste", [(201, 0.034), (1025, 0.015)])
def test_recon_d_tile_waste(D, waste):
    """The 208-column D tile idles under 3.5 % of the columns at D = 201 and
    under 1.5 % at D = 1025 (a 128-column tile idled 21 % and 11 %)."""
    plan = nmf_cuda.nmf_recon_plan(620, 14_336, D, H100_SMS)
    cols = plan["tiles"][1] * plan["tile"][1]
    assert (cols - D) / cols < waste


@pytest.mark.parametrize("F,K,D", SERVED + [(688, 7680, 201), (13, 40, 7)])
def test_recon_order_is_a_function_of_the_shape(F, K, D):
    """The order P sums in: each group's pieces in order, then the groups,
    every piece once; the same on every call and for the fused kernel."""
    plan = nmf_cuda.nmf_recon_plan(F, K, D, H100_SMS)
    order = nmf_cuda.recon_order(plan)
    assert [j for group in order for j in group] == list(range(plan["pieces"]))
    assert all(group for group in order) and len(order) == plan["groups"]
    assert nmf_cuda.recon_order(nmf_cuda.nmf_recon_plan(F, K, D, H100_SMS)) == order
    fused = nmf_cuda.nmf_mu_fused_plan(F, K, D, H100_SMS)
    assert nmf_cuda.recon_order(fused) == order


def test_recon_order_sums_like_the_fused_kernel():
    """A float32 model of both kernels' arithmetic (one fma per k from 0.0
    a piece, the pieces of a group, then the groups): the recon's tiles and
    units against the fused kernel's ranks and their pieces, bit for bit,
    and within 1e-5 of the float64 product."""
    rng = np.random.default_rng(3)
    F, K, D = 5, 700, 9
    H = rng.uniform(0, 0.05, (F, K)).astype(np.float32)
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    plan = nmf_cuda.nmf_recon_plan(F, K, D, 40)
    b = plan["piece_bounds"]

    def chain(lo, hi):
        acc = np.zeros((F, D), np.float32)
        for k in range(lo, hi):
            acc = (acc.astype(np.float64) + np.outer(H[:, k], A[k]).astype(np.float64)
                   ).astype(np.float32)   # exact product, one rounding: an fma
        return acc

    parts = {j: chain(b[j], b[j + 1]) for j in range(plan["pieces"])}
    recon = None
    for group in nmf_cuda.recon_order(plan):
        g = parts[group[0]]
        for j in group[1:]:
            g = g + parts[j]
        recon = g if recon is None else recon + g
    fused_plan = nmf_cuda.nmf_mu_fused_plan(F, K, D, 40)
    ks = fused_plan["k_bounds"]
    ranks = []
    for r in range(fused_plan["split"]):
        inside = [j for j in range(fused_plan["pieces"]) if ks[r] <= b[j] < ks[r + 1]]
        acc = chain(b[inside[0]], b[inside[0] + 1])
        for j in inside[1:]:
            acc = acc + chain(b[j], b[j + 1])
        ranks.append(acc)
    fused = ranks[0]
    for acc in ranks[1:]:
        fused = fused + acc
    assert plan["pieces"] > plan["groups"] > 1
    assert np.array_equal(recon, fused)
    exact = H.astype(np.float64) @ A.astype(np.float64)
    assert np.abs(recon - exact).max() / np.abs(exact).max() <= 1e-5


@pytest.mark.parametrize("F", FS)
def test_both_kernels_share_their_k_slices(F):
    """The fused kernel's ranks are the recon's groups, over the same pieces."""
    for K, D in itertools.product(KS, (1, 201, nmf_cuda.FUSED_MAX_D)):
        recon = nmf_cuda.nmf_recon_plan(F, K, D, H100_SMS)
        fused = nmf_cuda.nmf_mu_fused_plan(F, K, D, H100_SMS)
        assert recon["k_bounds"] == fused["k_bounds"]
        assert recon["piece_bounds"] == fused["piece_bounds"]
        assert fused["split"] == recon["groups"]


def test_split_follows_the_card_and_stays_a_power_of_two():
    # many F tiles need no split; a small F takes a full cluster of 8
    assert nmf_cuda.nmf_recon_plan(5000, 7680, 201, H100_SMS)["groups"] == 1
    assert nmf_cuda.nmf_recon_plan(4000, 7680, 201, H100_SMS)["groups"] == 2
    assert nmf_cuda.nmf_recon_plan(688, 7680, 201, H100_SMS)["groups"] == 8
    assert nmf_cuda.nmf_recon_plan(688, 7680, 201, 40)["groups"] == 2
    for F, n_sms in itertools.product(FS, (8, 66, 132, 264)):
        assert nmf_cuda.nmf_mu_fused_plan(F, 7680, 201, n_sms)["split"] in (1, 2, 4, 8)
        # the recon's CTAs follow the card: one an SM at most
        assert nmf_cuda.nmf_recon_plan(F, 7680, 201, n_sms)["grid"][0] <= n_sms
    # fewer pieces than a cluster: the groups halve to fit them
    assert nmf_cuda.nmf_recon_plan(620, 14_336, 1025, H100_SMS)["pieces"] == 6
    assert nmf_cuda.nmf_recon_plan(620, 14_336, 1025, H100_SMS)["groups"] == 4
    # K shorter than a full set of pieces: fewer units, none without work
    assert nmf_cuda.nmf_recon_plan(688, 3, 201, H100_SMS)["k_bounds"] == (0, 3)
    short = nmf_cuda.nmf_recon_plan(688, 40, 201, H100_SMS)
    assert short["piece_bounds"] == (0, 16, 32, 40) and short["k_bounds"] == (0, 16, 40)
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
    plan = nmf_cuda.nmf_recon_plan(620, 14_336, 1025, H100_SMS)
    packed = nmf_cuda._pack(plan)
    assert (packed.bm, packed.bn, packed.threads, packed.stages, packed.split) == (
        *plan["tile"], plan["threads"], plan["stages"], 1)
    assert (packed.grid_x, packed.grid_y, packed.grid_z) == plan["grid"]
    assert list(packed.k_bounds) == list(plan["k_bounds"]) + [14_336] * 4
    assert (packed.long_pieces, packed.rem_kb, packed.pieces, packed.groups) == (
        plan["long_pieces"], plan["rem_kb"], plan["pieces"], plan["groups"])
    assert (packed.single_ctas, packed.range_ctas, packed.range_units) == (
        plan["single_ctas"], plan["range_ctas"], plan["range_units"])
    assert (packed.tiles_f, packed.tiles_d) == plan["tiles"] == (5, 5)
    fused = nmf_cuda._pack(nmf_cuda.nmf_mu_fused_plan(688, 40, 201, H100_SMS))
    assert list(fused.k_bounds) == [0, 16, 40, 40, 40, 40, 40, 40, 40]
    assert (fused.split, fused.groups, fused.pieces) == (2, 2, 3)
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
