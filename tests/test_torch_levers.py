"""The STFT-path levers of the port against the JAX package: each function on
the same seeded numpy inputs, then ``convert_utterance`` as a whole with one
lever on at a time and with the ``quality`` preset, on the synthetic corpus
of ``torch_corpus``.

Tolerances. Gathers and masks (``_stack_context``, ``alignment_keep_mask``,
the f0 tiling) are exact. One float32 product or mean (``_smooth_h``, the
VTLP operators, ``_preprocess_frames``) agrees within 1e-6 of the largest
value; the jitted ``_vtlp_expand_pair`` of the JAX package within 3e-5,
because XLA under jit computes a warp's source positions bin·(1/α) with a
rounded reciprocal where the port (and the JAX package's own eager
``_vtlp_warp``) divide, and one ulp of a position near bin 200 is 1.5e-5 of
an interpolation weight. The refinements that run tens of float32 MU steps
(``prune_topk_refine``, ``sharpen_activations``) agree within 1e-4 relative
L2. The bfloat16 solve is held to the JAX test's own rule
(``tests/test_nmf.py::test_bf16_work_dtype_close_to_f32``): error below
1.05× the float32 solve's + 1e-3 and H within 8 % of it, against the port's
float32 solve and against the JAX bfloat16 solve. A whole conversion:
``torch_corpus.assert_same_conversion`` (1e-3 relative L2, equal n_iter, MCD
within 0.05 dB)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplars_vc_tpu.align import exemplar as jexemplar
from exemplars_vc_tpu.config import load_config as jload_config
from exemplars_vc_tpu.factorize import nmf as jnmf
from exemplars_vc_tpu.io.store import ArtifactStore as JArtifactStore
from exemplars_vc_tpu.pipelines import convert as jconvert
from exemplars_vc_tpu.pipelines import evaluate as jevaluate
from exemplars_vc_tpu_torch.align import exemplar as texemplar
from exemplars_vc_tpu_torch.config import load_config
from exemplars_vc_tpu_torch.factorize import nmf as tnmf
from exemplars_vc_tpu_torch.factorize import nmf_cuda
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.pipelines import convert as tconvert
from exemplars_vc_tpu_torch.pipelines import evaluate as tevaluate
from exemplars_vc_tpu_torch.pipelines import make_dict as tmake_dict
from torch_corpus import OVERRIDES, assert_same_conversion, rel_l2, write_synthetic_corpus


def _max_err(got, ref):
    ref = np.asarray(ref)
    return float(np.abs(np.asarray(got) - ref).max() / max(np.abs(ref).max(), 1e-30))


def _problem(seed, F=24, K=80, D=25, pad_rows=0):
    rng = np.random.default_rng(seed)
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    if pad_rows:
        A[K - pad_rows:] = 0.0
    X = np.abs(rng.standard_normal((F, D))).astype(np.float32)
    return X, A


# ---------------------------------------------------------------------------
# the functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("c", [0, 1, 3])
def test_stack_context_equals_jax(c):
    M = np.random.default_rng(0).standard_normal((11, 5)).astype(np.float32)
    got = tconvert._stack_context(torch.as_tensor(M), c)
    assert got.shape == (11, 5 * (2 * c + 1))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jconvert._stack_context(jnp.asarray(M), c)))


@pytest.mark.parametrize("s", [0, 1, 2, 20])     # 20: wider than the signal
def test_smooth_h_matches_jax(s):
    H = np.abs(np.random.default_rng(1).standard_normal((13, 7))).astype(np.float32)
    got = tconvert._smooth_h(torch.as_tensor(H), s)
    assert _max_err(got.numpy(), jconvert._smooth_h(jnp.asarray(H), s)) <= 1e-6


WARPS = (0.9, 0.95, 1.05, 1.1)


def test_vtlp_expand_pair_matches_jax_and_the_per_alpha_warp():
    rng = np.random.default_rng(2)
    A = np.abs(rng.standard_normal((12, 201))).astype(np.float32)
    B = np.abs(rng.standard_normal((12, 201))).astype(np.float32)
    At, Bt = torch.as_tensor(A), torch.as_tensor(B)
    ga, gb = tconvert._vtlp_expand_pair(At, Bt, WARPS)
    ra, rb = jconvert._vtlp_expand_pair(jnp.asarray(A), jnp.asarray(B), WARPS)
    assert ga.shape == (5 * 12, 201)
    assert _max_err(ga.numpy(), ra) <= 3e-5 and _max_err(gb.numpy(), rb) <= 3e-5
    np.testing.assert_array_equal(ga[:12].numpy(), A)         # the identity block
    for w, alpha in enumerate(WARPS, start=1):
        block = ga[12 * w: 12 * (w + 1)].numpy()
        warped = tconvert._vtlp_warp(At, alpha).numpy()
        assert _max_err(block, warped) <= 1e-6                # operator ≡ gather form
        assert _max_err(warped, jconvert._vtlp_warp(jnp.asarray(A), alpha)) <= 1e-6
    # lo and hi coincide at the clamped top edge: the weights add up to 1
    P = tconvert._vtlp_matrix(201, 0.9, torch.float32, torch.device("cpu"))[3]
    np.testing.assert_allclose(P.sum(dim=0).numpy(), 1.0, atol=1e-6)


def test_augment_dicts_tiles_f0_and_warps_spectra():
    rng = np.random.default_rng(3)
    S = np.abs(rng.standard_normal((6, 33))).astype(np.float32)
    f0 = np.abs(rng.standard_normal((6, 1))).astype(np.float32)
    dicts = {"stft": (S, S + 1), "f0": (f0, 2 * f0)}
    got = tconvert._augment_dicts({k: tuple(map(torch.as_tensor, v)) for k, v in dicts.items()},
                                  WARPS[:2])
    ref = jconvert._augment_dicts(dicts, WARPS[:2])
    for name in dicts:
        for g, r in zip(got[name], ref[name]):
            assert g.shape == (18, dicts[name][0].shape[1])
            assert _max_err(g.numpy(), r) <= (0 if name == "f0" else 3e-5)
    np.testing.assert_array_equal(got["f0"][0].numpy(), np.tile(f0, (3, 1)))
    assert tconvert._parse_warps("0.9, 1.1,") == jconvert._parse_warps("0.9, 1.1,") == (0.9, 1.1)
    assert tconvert._parse_warps("") == ()


@pytest.mark.parametrize("prune_frac", [0.1, 0.5, 0.999])
def test_alignment_keep_mask_equals_jax(prune_frac):
    rng = np.random.default_rng(4)
    fa = rng.standard_normal((3, 16, 5)).astype(np.float32)
    fb = rng.standard_normal((3, 16, 5)).astype(np.float32)
    lens = [12, 16, 7]
    pi = np.full((3, 20), -1, np.int32)
    pj = np.full((3, 20), -1, np.int32)
    for n, ln in enumerate(lens):
        pi[n, :ln] = np.sort(rng.integers(0, 16, ln))
        pj[n, :ln] = np.sort(rng.integers(0, 16, ln))
    k_true, k_pad = sum(lens), 40
    ref = jexemplar.alignment_keep_mask(jnp.asarray(fa), jnp.asarray(fb), jnp.asarray(pi),
                                        jnp.asarray(pj), k_pad=k_pad, k_true=k_true,
                                        prune_frac=prune_frac)
    got = texemplar.alignment_keep_mask(*map(torch.as_tensor, (fa, fb, pi, pj)), k_pad=k_pad,
                                        k_true=k_true, prune_frac=prune_frac)
    assert got.dtype == torch.bool and got.shape == (k_pad,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not got[k_true:].any() and 1 <= int(got.sum()) <= k_true
    M = rng.standard_normal((k_pad, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        texemplar.apply_keep_mask(torch.as_tensor(M), got).numpy(),
        np.asarray(jexemplar.apply_keep_mask(jnp.asarray(M), ref)))


@pytest.mark.parametrize("overrides", [
    ["nmf.solve_domain=mel", "nmf.solve_mels=40"], ["nmf.context_frames=2"],
    ["nmf.solve_domain=mel", "nmf.solve_mels=40", "nmf.context_frames=1"],
    ["nmf.solve_domain=mel", "nmf.solve_mels=300"],      # wider than the bins: untouched
], ids=["mel", "context", "mel+context", "mel-noop"])
def test_preprocess_frames_matches_jax(overrides):
    X = np.abs(np.random.default_rng(5).standard_normal((9, 201))).astype(np.float32)
    got = tconvert._preprocess_frames(torch.as_tensor(X), load_config(overrides=overrides))
    ref = np.asarray(jconvert._preprocess_frames(jnp.asarray(X), jload_config(overrides=overrides)))
    assert got.shape == ref.shape
    assert _max_err(got.numpy(), ref) <= 1e-6


@pytest.mark.parametrize("beta", ["frobenius", "kullback-leibler"])
def test_prune_topk_refine_matches_jax(beta):
    X, A = _problem(6, pad_rows=8)
    dense = jnmf.nmf_activations(jnp.asarray(X), jnp.asarray(A), beta_loss=beta, tol=0.0,
                                 max_iter=60)
    H = np.asarray(dense.H)
    ref = jnmf.prune_topk_refine(jnp.asarray(X), jnp.asarray(A), jnp.asarray(H), k=10,
                                 beta_loss=beta, n_iter=40)
    got = tnmf.prune_topk_refine(*map(torch.as_tensor, (X, A, H)), k=10, beta_loss=beta,
                                 n_iter=40)
    assert got.n_iter == int(ref.n_iter) == 40
    assert ((got.H != 0).sum(dim=1) <= 10).all()
    assert rel_l2(got.H.numpy(), ref.H) <= 1e-4
    np.testing.assert_allclose(float(got.error), float(ref.error), rtol=1e-4)
    with pytest.raises(ValueError, match="beta_loss"):
        tnmf.prune_topk_refine(*map(torch.as_tensor, (X, A, H)), k=10, beta_loss="is")


@pytest.mark.parametrize("gamma", [1.0, 1.5])
def test_sharpen_activations_matches_jax(gamma):
    X, A = _problem(7)
    H = np.random.default_rng(8).uniform(0, 0.1, (X.shape[0], A.shape[0])).astype(np.float32)
    ref = jnmf.sharpen_activations(jnp.asarray(H), jnp.asarray(A), jnp.asarray(X), gamma)
    got = tnmf.sharpen_activations(*map(torch.as_tensor, (H, A, X)), gamma)
    assert rel_l2(got.numpy(), ref) <= 1e-4


@pytest.mark.parametrize("beta", ["frobenius", "kullback-leibler"])
def test_bf16_work_dtype_close_to_f32_and_to_jax(beta):
    rng = np.random.default_rng(10)
    A = np.abs(rng.standard_normal((64, 32))).astype(np.float32)
    X = np.abs(rng.standard_normal((40, 32))).astype(np.float32)
    Xt, At = torch.as_tensor(X), torch.as_tensor(A)
    kw = dict(beta_loss=beta, tol=0.0, max_iter=100)
    f32 = tnmf.nmf_activations(Xt, At, **kw)
    bf16 = tnmf.nmf_activations(Xt, At, work_dtype=torch.bfloat16, **kw)
    jbf16 = jnmf.nmf_activations(jnp.asarray(X), jnp.asarray(A), work_dtype=jnp.bfloat16, **kw)
    assert bf16.H.dtype == torch.float32 and bf16.n_iter == int(jbf16.n_iter) == 100
    for ref_err, ref_H in ((float(f32.error), f32.H.numpy()),
                           (float(jbf16.error), np.asarray(jbf16.H))):
        assert float(bf16.error) < 1.05 * ref_err + 1e-3
        assert rel_l2(bf16.H.numpy(), ref_H) < 0.08
    # float32 asked for by name is the default solve
    same = tnmf.nmf_activations(Xt, At, work_dtype=torch.float32, **kw)
    assert torch.equal(same.H, f32.H)
    with pytest.raises(ValueError, match="work_dtype"):
        tnmf.nmf_activations(Xt, At, work_dtype=torch.bfloat16, fused=True)


def test_normalize_exemplars_returns_the_unnormalised_basis():
    """H comes back in the basis of A, as the reference computes it, and the
    H columns of zero padding rows are exactly 0."""
    X, A = _problem(11, F=16, K=48, pad_rows=12)
    ov = ["nmf.normalize_exemplars=true", "nmf.max_iter=40", "nmf.tol=0"]
    ref = jconvert._solve_activations(jnp.asarray(X), jnp.asarray(A), jload_config(overrides=ov))
    got = tconvert._solve_activations(torch.as_tensor(X), torch.as_tensor(A),
                                      load_config(overrides=ov))
    assert got.n_iter == int(ref.n_iter) == 40
    assert rel_l2(got.H.numpy(), ref.H) <= 1e-4
    assert (got.H[:, -12:] == 0).all()
    plain = tconvert._solve_activations(torch.as_tensor(X), torch.as_tensor(A),
                                        load_config(overrides=ov[1:]))
    fit = lambda H: float(torch.linalg.norm(torch.as_tensor(X) - H @ torch.as_tensor(A)))
    assert fit(got.H) < 1.05 * fit(plain.H)


# ---------------------------------------------------------------------------
# the repaired error check: its recon feeds the next update
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tol,max_iter,check_every", [(0.0, 40, 10), (1e-2, 150, 10),
                                                      (0.0, 45, 10), (0.0, 7, 10)])
def test_error_check_recon_is_reused(monkeypatch, tol, max_iter, check_every):
    """``nmf_recon`` runs once for the initial error and once a step, and not
    once more a check; H, n_iter and the error are what a solve that
    recomputes P for every step gives."""
    rng = np.random.default_rng(12)
    A = (np.abs(rng.standard_normal((256, 60))) ** 2).astype(np.float32)
    A[200:] = 0.0
    X = (np.abs(rng.standard_normal((30, 60))) ** 2).astype(np.float32)
    Xt, At = torch.as_tensor(X), torch.as_tensor(A)

    # the solve as it was: a recon for every step and another for every check
    H = torch.sqrt(torch.clamp(Xt.mean(), min=0.0) / 256).expand(30, 256).contiguous()
    Num = Xt @ At.T
    err = lambda H: torch.sqrt(torch.sum((Xt - H @ At) ** 2))
    e0 = prev = e = err(H)
    n = 0
    for _ in range(max_iter // check_every):
        for _ in range(check_every):
            H = nmf_cuda.nmf_update_plain(H @ At, At, H, Num)
        n += check_every
        e = err(H)
        if tol > 0 and bool((prev - e) < tol * e0):
            break
        prev = e
    if max_iter % check_every:
        for _ in range(max_iter % check_every):
            H = nmf_cuda.nmf_update_plain(H @ At, At, H, Num)
        n += max_iter % check_every
        e = err(H)

    calls = []
    real = tnmf.nmf_recon
    monkeypatch.setattr(tnmf, "nmf_recon", lambda H, A: (calls.append(1), real(H, A))[1])
    got = tnmf.nmf_activations(Xt, At, tol=tol, max_iter=max_iter, check_every=check_every)
    assert got.n_iter == n
    assert len(calls) == 1 + n
    assert torch.equal(got.H, H) and float(got.error) == float(e)
    # the fused solve's check keeps its own recon: one a check
    calls.clear()
    fused = tnmf.nmf_activations(Xt, At, tol=tol, max_iter=max_iter, check_every=check_every,
                                 fused=True)
    checks = 1 + fused.n_iter // check_every + (1 if max_iter % check_every else 0)
    assert len(calls) == checks and fused.n_iter == n


# ---------------------------------------------------------------------------
# convert_utterance, one lever at a time
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_synthetic_corpus(tmp_path_factory.mktemp("synthetic_corpus"))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    """One store a package for the whole module: the DTW paths are built
    once a hop and loaded by the later cases."""
    root = tmp_path_factory.mktemp("stores")
    return JArtifactStore(str(root / "j")), ArtifactStore(str(root / "t"))


LEVERS = {
    "context_frames": ["nmf.context_frames=2"],
    "h_smooth": ["nmf.h_smooth=1"],
    "solve_domain_mel": ["nmf.solve_domain=mel"],
    "mel_with_context": ["nmf.solve_domain=mel", "nmf.solve_mels=40", "nmf.context_frames=1"],
    "normalize_exemplars": ["nmf.normalize_exemplars=true"],
    "prune_topk": ["nmf.prune_topk=4", "nmf.prune_iters=20"],
    "prune_topk_kl": ["nmf.prune_topk=6", "nmf.prune_iters=20",
                      "nmf.beta_loss=kullback-leibler"],
    "activation_power": ["nmf.activation_power=1.5"],
    "dict_augment_warps": ["data.dict_augment_warps=0.9"],
    "dict_prune_frac": ["data.dict_prune_frac=0.1"],
    "dict_hop_divisor": ["data.dict_hop_divisor=2"],
    "sparsity_l1": ["nmf.sparsity_l1=0.05"],
    "solver_qr": ["nmf.solver=qr"],
    "solver_cd": ["nmf.solver=cd"],
    "solver_nnls": ["nmf.solver=nnls", "nmf.nnls_iters=60"],
    "gl_init_random_magnitude": ["nmf.gl_init=random"],
}


@pytest.mark.parametrize("name", list(LEVERS))
def test_lever_converts_as_jax(name, corpus, stores):
    data, src, tar = corpus
    jstore, tstore = stores
    ov = OVERRIDES + LEVERS[name]
    ref = jconvert.convert_utterance(jload_config(overrides=ov), jstore, data, src, nb_file=3,
                                     synth_iters=5, reference_wav=tar)
    got = tconvert.convert_utterance(load_config(overrides=ov), tstore, data, src, nb_file=3,
                                     synth_iters=5, reference_wav=tar, device="cpu")
    if name == "gl_init_random_magnitude":
        # the random seed phases are each package's own: hold the magnitude
        assert rel_l2(got.converted["stft"].numpy(), ref.converted["stft"]) < 1e-3
        assert got.n_iter == ref.n_iter and np.isfinite(got.audio).all()
        return
    assert_same_conversion(got, ref)
    jdicts, _ = jconvert._aligned_dicts(jload_config(overrides=ov), jstore, data, 3)   # memoised
    assert got.nmf_shape[1] == jdicts["stft"][0].shape[0]


def test_quality_preset_converts_as_jax(corpus, stores):
    """``load_config(preset="quality")``: KL, four VTLP warps, h_smooth=2."""
    data, src, tar = corpus
    jstore, tstore = stores
    cfg, jcfg = load_config(preset="quality", overrides=OVERRIDES), \
        jload_config(preset="quality", overrides=OVERRIDES)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    ref = jconvert.convert_utterance(jcfg, jstore, data, src, nb_file=3, synth_iters=5,
                                     reference_wav=tar)
    got = tconvert.convert_utterance(cfg, tstore, data, src, nb_file=3, synth_iters=5,
                                     reference_wav=tar, device="cpu")
    assert_same_conversion(got, ref)
    assert got.nmf_shape[1] == 5 * 512           # the dictionary and its four warped copies


def test_bf16_solve_converts(corpus, stores):
    """``nmf.work_dtype=bfloat16`` through ``convert_utterance``: the JAX
    rule again, against the port's float32 conversion and the JAX bfloat16
    one (magnitude within 8 %)."""
    data, src, _ = corpus
    jstore, tstore = stores
    ov = OVERRIDES + ["nmf.work_dtype=bfloat16"]
    f32 = tconvert.convert_utterance(load_config(overrides=OVERRIDES), tstore, data, src,
                                     nb_file=3, synth_iters=3, device="cpu")
    got = tconvert.convert_utterance(load_config(overrides=ov), tstore, data, src, nb_file=3,
                                     synth_iters=3, device="cpu")
    ref = jconvert.convert_utterance(jload_config(overrides=ov), jstore, data, src, nb_file=3,
                                     synth_iters=3)
    assert got.n_iter == ref.n_iter == f32.n_iter
    assert got.nmf_error < 1.05 * f32.nmf_error + 1e-3
    assert got.nmf_error < 1.05 * ref.nmf_error + 1e-3
    assert rel_l2(got.converted["stft"].numpy(), f32.converted["stft"].numpy()) < 0.08
    assert rel_l2(got.converted["stft"].numpy(), ref.converted["stft"]) < 0.08
    assert np.isfinite(got.audio).all()


def test_unknown_solver_raises(corpus, stores):
    data, src, _ = corpus
    with pytest.raises(ValueError, match="unknown nmf solver"):
        tconvert.convert_utterance(load_config(overrides=OVERRIDES + ["nmf.solver=lbfgs"]),
                                   stores[1], data, src, nb_file=3, device="cpu")


# ---------------------------------------------------------------------------
# the dictionary memo
# ---------------------------------------------------------------------------

def test_dicts_memo_builds_once_and_keys_on_misc_and_device(corpus, tmp_path, monkeypatch):
    data, _, _ = corpus
    cfg = load_config(overrides=OVERRIDES)
    store = ArtifactStore(str(tmp_path / "s"))
    cpu = torch.device("cpu")
    tconvert._DICTS_MEMO.clear()
    builds, dtws = tconvert._aligned_dicts.builds, tmake_dict.make_dictionary.builds
    first = tconvert._aligned_dicts(cfg, store, data, 3, cpu)
    assert (tconvert._aligned_dicts.builds, tmake_dict.make_dictionary.builds) == \
        (builds + 1, dtws + 1)
    again = tconvert._aligned_dicts(cfg, store, data, 3, cpu)
    assert again[0] is first[0]                               # nothing built, nothing copied
    assert (tconvert._aligned_dicts.builds, tmake_dict.make_dictionary.builds) == \
        (builds + 1, dtws + 1)
    # misc is part of the key: another cpu_rate is another dictionary (whose
    # DTW paths come from the store, so the gather runs and the DTW does not)
    other = dataclasses.replace(cfg, misc=dataclasses.replace(cfg.misc, cpu_rate=0.5))
    tconvert._aligned_dicts(other, store, data, 3, cpu)
    assert (tconvert._aligned_dicts.builds, tmake_dict.make_dictionary.builds) == \
        (builds + 2, dtws + 1)
    keys = list(tconvert._DICTS_MEMO)
    assert len(keys) == 2 and keys[0][-1] == "cpu" and keys[0][:-1] != keys[1][:-1]
    # the device is part of the key
    assert (*keys[0][:-1], "cuda:0") not in tconvert._DICTS_MEMO
    # bounded, first in first out
    monkeypatch.setattr(tconvert, "_DICTS_MEMO_MAX", 2)
    third = dataclasses.replace(cfg, misc=dataclasses.replace(cfg.misc, cpu_rate=0.4))
    tconvert._aligned_dicts(third, store, data, 3, cpu)
    assert len(tconvert._DICTS_MEMO) == 2 and keys[0] not in tconvert._DICTS_MEMO
    tconvert._DICTS_MEMO.clear()


def test_heldout_pair_equals_jax(corpus):
    data, src, tar = corpus
    assert tevaluate.HELD_OUT_UTT == jevaluate.HELD_OUT_UTT
    assert tevaluate.heldout_pair(data) == jevaluate.heldout_pair(data) == (src, tar)
    assert tevaluate.heldout_pair(data, "SM1", "TM3") == jevaluate.heldout_pair(data, "SM1", "TM3")


def test_dictionary_host_copies_reach_the_store(tmp_path):
    """``host_copies`` hands the store what its writer thread can turn into
    arrays: on the CPU the arrays themselves; for a copy still in flight a
    handle whose array waits for the copy's event (a stub here)."""
    rng = np.random.default_rng(13)
    arrays = dict(path_i=rng.integers(-1, 9, (2, 7)), path_j=rng.integers(-1, 9, (2, 7)),
                  path_len=np.array([5, 7]), feat_a=rng.standard_normal((2, 9, 3)),
                  feat_b=rng.standard_normal((2, 9, 3)), len_a=np.array([9, 8]),
                  len_b=np.array([9, 7]), distance=rng.standard_normal(2))
    art = tmake_dict.from_jax_artifacts(arrays, "cpu")
    assert art.path_len.device.type == "cpu" and art.path_len.dtype == torch.int32
    host = art.host_copies()
    assert sorted(host) == sorted(arrays)
    for k, v in art.to_numpy().items():
        np.testing.assert_array_equal(np.asarray(host[k]), v)

    class Event:
        waited = 0

        def synchronize(self):
            Event.waited += 1

    handle = tmake_dict._HostCopy(art.feat_a, Event())
    store = ArtifactStore(str(tmp_path))
    store.save("k", feat_a=handle, path_i=host["path_i"])
    got = store.load("k")                                   # joins the writer thread
    assert Event.waited == 1
    np.testing.assert_array_equal(got["feat_a"], art.feat_a.numpy())
    assert np.asarray(handle, dtype=np.float64).dtype == np.float64
