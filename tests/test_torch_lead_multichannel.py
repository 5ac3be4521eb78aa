"""The port's composed multichannel source-F0-filter model
(``exemplars_vc_tpu_torch/separate/lead_multichannel.py``) on the CPU:
counterparts of ``tests/test_lead_multichannel.py`` and the same inputs
through the JAX package and the port.

Tolerances. From well-conditioned inits (identity-plus-rank-1 spatial
covariances, random factors, a dictionary that covers every bin) the
composed EM's factors after 6 iterations within 5e-3 relative of the JAX
package's (measured ≤ 2e-6) and the NLL trace within 1e-5. The pipeline
seeds its EM from the stereo SIMM's factors and DEMIX's rank-1-plus-5 %-
diffuse covariances, which makes the float32 fit ill-conditioned: from such
seeds the JAX package alone, given the input times (1 + 1e-7·noise), moves
its factors after 6 EM iterations by HF0 1.6e-2, TW 4.1e-3, W 4.4e-3, H
4.8e-3 and R 2.2e-3 relative, and the port parts from it by about as much
(HF0 1.4e-2, TW 5.7e-3, W 5.6e-3, H 4.8e-3, R 2.8e-3, NLL 2.3e-5). There
the 5e-3 gate cannot hold (the JAX package misses it against itself, which
the test shows), so the port is held within 5e-2 on every factor and its
NLL trace within 1e-4; the whole pipeline's audio within 1e-2 of the
mixture's peak (measured 2.3e-3 at 6 SIMM iterations and 6 EM), its NLL
trace within 1e-3 (measured 1.1e-4: from the empirical covariances the
first E-step's log det already differs by that) and its melody equal on
≥ 99 % of frames. Bins that the source dictionary leaves empty do the same:
v clamps at 1e-10 there and R̂/v amplifies float32 roundoff (with 6
harmonics in place of 30 in ``_em_inputs``, R after one E-step is 8e-5
apart); ``_em_inputs`` covers every bin."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.separate import fit_multichannel_sf as jax_fit_multichannel_sf
from exemplars_vc_tpu.separate import separate_lead_multichannel as jax_separate_lmc
from exemplars_vc_tpu.separate.lead_multichannel import _sf_updates as jax_sf_updates
from exemplars_vc_tpu.separate.multichannel import random_spatial_init as jax_spatial_init
from exemplars_vc_tpu_torch.dsp.stft import stft
from exemplars_vc_tpu_torch.io.standin import synthetic_mixture
from exemplars_vc_tpu_torch.separate import fit_multichannel_sf, separate_lead_multichannel
from exemplars_vc_tpu_torch.separate.lead import (
    f0_grid,
    hann_filter_basis,
    harmonic_dictionary,
)
from exemplars_vc_tpu_torch.separate.lead_multichannel import (
    _sf_updates,
    _wiener_images_sf,
    model_power,
)
from test_stereo_simm import _stereo_melody_mixture
from test_torch_separate import key_kw

CPU = "cpu"
FIELDS = ("HF0", "FW", "TW", "W", "H", "R")


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def _mixture_stft(x, n_fft=1024, hop=256) -> torch.Tensor:
    return stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop).permute(2, 1, 0)  # (F,N,C)


def _bases(F, n_f0, n_harm, n_atoms):
    grid = 150.0 * 2.0 ** (np.arange(n_f0) / 12.0)
    return harmonic_dictionary(grid, (F - 1) * 2, 16000.0, n_harm), hann_filter_basis(F, n_atoms)


# ---- counterparts of tests/test_lead_multichannel.py -----------------------


class TestFitMultichannelSF:
    def test_nll_decreases(self):
        X = _mixture_stft(_stereo_melody_mixture(T=8000)[0])
        WF0, WGAMMA = _bases(X.shape[0], 20, 10, 10)
        model = fit_multichannel_sf(X, WF0, WGAMMA, n_acc_sources=1, n_filters=3,
                                    n_acc_components=4, n_em=15, device=CPU)
        nll = model.neg_log_like.numpy()
        assert np.isfinite(nll).all() and nll[-1] < nll[0]
        assert np.mean(np.diff(nll) <= abs(nll[0]) * 1e-5) > 0.85

    def test_spatial_covariances_hermitian_normalized(self):
        X = _mixture_stft(_stereo_melody_mixture(T=8000)[0])
        WF0, WGAMMA = _bases(X.shape[0], 12, 8, 8)
        R = fit_multichannel_sf(X, WF0, WGAMMA, n_em=5, n_acc_components=3,
                                device=CPU).R.numpy()
        assert np.allclose(R, np.conj(np.swapaxes(R, -1, -2)), atol=1e-5)
        assert np.allclose(np.real(np.trace(R, axis1=-2, axis2=-1)), 2.0, atol=1e-3)

    def test_wiener_images_reconstruct_mixture(self):
        X = _mixture_stft(_stereo_melody_mixture(T=8000)[0])
        WF0, WGAMMA = _bases(X.shape[0], 12, 8, 8)
        model = fit_multichannel_sf(X, WF0, WGAMMA, n_em=10, n_acc_components=4, device=CPU)
        Y = _wiener_images_sf(X, model_power(model, torch.from_numpy(WF0),
                                             torch.from_numpy(WGAMMA)), model.R)
        resid = (Y.sum(dim=0) - X).abs().numpy()
        assert resid.mean() < 0.15 * float(X.abs().mean())


class TestSeparateLeadMultichannel:
    def test_improves_over_mixture_and_tracks_panning(self):
        x, true_lead, _ = _stereo_melody_mixture()
        res = separate_lead_multichannel(
            x, sample_rate=16000.0, n_fft=1024, hop_length=256, f0_min=150.0, f0_max=500.0,
            n_harmonics=10, n_accomp=8, n_iter_simm=25, n_em=15, device=CPU)
        lead = res.lead.numpy().astype(np.float64)
        assert lead.shape == x.shape and np.isfinite(lead).all()

        def snr(est):
            return 10 * np.log10(np.sum(true_lead ** 2) / np.sum((est - true_lead) ** 2))

        assert snr(lead) > snr(x.astype(np.float64)) + 4.0
        w, V = np.linalg.eigh(res.model.R.numpy()[0].mean(axis=0))
        a = np.abs(V[:, -1])
        truth = np.array([np.cos(0.2), np.sin(0.2)])
        assert float(a @ truth / np.linalg.norm(a)) > 0.95

    def test_empirical_spatial_init(self):
        x, _, _ = _stereo_melody_mixture(T=8000)
        res = separate_lead_multichannel(x, f0_min=150.0, f0_max=500.0, n_harmonics=10,
                                         n_accomp=6, n_iter_simm=15, n_em=8,
                                         spatial_init="empirical", device=CPU)
        assert torch.isfinite(res.lead).all() and res.accomp.shape == x.shape

    def test_multiple_accompaniment_sources(self):
        x, _, _ = _stereo_melody_mixture(T=8000)
        res = separate_lead_multichannel(x, f0_min=150.0, f0_max=500.0, n_harmonics=10,
                                         n_accomp=6, n_iter_simm=10, n_em=6, n_acc_sources=2,
                                         device=CPU)
        assert res.model.W.shape[0] == 2 and res.model.R.shape[0] == 3
        assert res.lead.shape == x.shape and res.accomp.shape == x.shape
        nll = res.model.neg_log_like.numpy()
        assert nll[-1] < nll[0]


# ---- parity with the JAX package -------------------------------------------


def _em_inputs(seed=0, F=129, N=40, n_f0=16, P=10, K=3, Ka=4, J_acc=1):
    rng = np.random.default_rng(seed)
    x, _, _ = _stereo_melody_mixture(T=N * 64 - 64, seed=seed)
    X = _mixture_stft(x, n_fft=(F - 1) * 2, hop=64).numpy()
    X = X / np.sqrt((np.abs(X) ** 2).mean())
    WF0, WGAMMA = _bases(F, n_f0, 30, P)
    inits = dict(HF0_init=np.abs(rng.standard_normal((n_f0, N))).astype(np.float32),
                 FW_init=np.abs(rng.standard_normal((P, K))).astype(np.float32),
                 TW_init=np.abs(rng.standard_normal((K, N))).astype(np.float32),
                 W_init=(rng.random((J_acc, F, Ka)) + 0.1).astype(np.float32),
                 H_init=(rng.random((J_acc, Ka, N)) + 0.1).astype(np.float32),
                 R_init=np.array(jax_spatial_init(jax.random.PRNGKey(seed), 1 + J_acc, F, 2)))
    return X.astype(np.complex64), WF0, WGAMMA, inits


def test_sf_updates_match_jax():
    rng = np.random.default_rng(1)
    _, WF0, WGAMMA, inits = _em_inputs(1)
    z = (rng.random((WF0.shape[0], 40)) + 0.05).astype(np.float32)
    args = [inits[k] for k in ("HF0_init", "FW_init", "TW_init")]
    want = jax_sf_updates(jnp.asarray(z), jnp.asarray(WF0), jnp.asarray(WGAMMA),
                          *map(jnp.asarray, args))
    got = _sf_updates(torch.from_numpy(z), torch.from_numpy(WF0), torch.from_numpy(WGAMMA),
                      *map(torch.from_numpy, args))
    for g, w in zip(got, want):
        assert rel(g.numpy(), w) < 1e-5


@pytest.mark.parametrize("n_inner,J_acc", [(1, 1), (2, 2)])
def test_em_sf_loop_matches_jax(n_inner, J_acc):
    X, WF0, WGAMMA, inits = _em_inputs(2, J_acc=J_acc)
    kw = dict(n_acc_sources=J_acc, n_filters=3, n_acc_components=4, n_em=6, n_inner=n_inner)
    ref = jax_fit_multichannel_sf(jnp.asarray(X), jnp.asarray(WF0), jnp.asarray(WGAMMA),
                                  **kw, **inits)
    got = fit_multichannel_sf(X, WF0, WGAMMA, device=CPU, **kw, **inits)
    for name in FIELDS:
        assert rel(getattr(got, name).numpy(), getattr(ref, name)) < 5e-3, name
    nll = np.asarray(ref.neg_log_like)
    assert np.abs(got.neg_log_like.numpy() - nll).max() / np.abs(nll).max() < 1e-5


@pytest.mark.parametrize("seed", [None, 7])
def test_fit_multichannel_sf_from_a_key_matches_jax(seed):
    """No inits: the factors (0.75·|randn| + 0.25) and R from the six-way
    split of the key in both packages; the tolerances of
    ``test_em_sf_loop_matches_jax``."""
    X, WF0, WGAMMA, _ = _em_inputs(2)
    jk, tk = key_kw(seed)
    kw = dict(n_filters=3, n_acc_components=4, n_em=6)
    ref = jax_fit_multichannel_sf(jnp.asarray(X), jnp.asarray(WF0), jnp.asarray(WGAMMA),
                                  **kw, **jk)
    got = fit_multichannel_sf(X, WF0, WGAMMA, device=CPU, **kw, **tk)
    for name in FIELDS:
        assert rel(getattr(got, name).numpy(), getattr(ref, name)) < 5e-3, name
    nll = np.asarray(ref.neg_log_like)
    assert np.abs(got.neg_log_like.numpy() - nll).max() / np.abs(nll).max() < 1e-5


def test_fit_from_the_pipeline_seeds_is_ill_conditioned_in_both_packages():
    """The composed fit as ``separate_lead_multichannel`` seeds it (the
    stereo SIMM's factors, DEMIX covariances of the separated images, the
    unit-power STFT; made here by the port and fed to both packages), 6 EM
    iterations: the JAX package against itself on the input times
    (1 + 1e-7·noise) parts by more than 5e-3 on HF0; the port stays within
    5e-2 of it."""
    from exemplars_vc_tpu_torch.separate import demix, separate_lead_stereo
    from exemplars_vc_tpu_torch.separate.glue import host_stft_stack, stack_spatial, unit_power

    x = synthetic_mixture()
    simm = separate_lead_stereo(x, n_accomp=20, n_iter=10, device=CPU)
    X = unit_power(host_stft_stack(x, 1024, 256, device=CPU)).numpy()
    F = X.shape[0]
    WF0 = harmonic_dictionary(f0_grid(100.0, 800.0, 4), 1024, 16000.0, 30)
    WUF0 = np.concatenate([WF0, np.ones((F, 1), np.float32)], axis=1)
    WGAMMA = hann_filter_basis(F, 20)
    R = [demix(img, n_sources=1, n_fft=1024, hop_length=256, device=CPU).spatial_init(
        np.arange(F) / 1024, device=CPU)[0] for img in (simm.lead, simm.accomp)]
    m = simm.model
    seeds = dict(HF0_init=m.HF0.numpy(), FW_init=m.HGAMMA.numpy(), TW_init=m.HPHI.numpy(),
                 W_init=m.WM.numpy()[None], H_init=m.HM.numpy()[None],
                 R_init=stack_spatial(*R, 1).numpy())
    kw = dict(n_acc_components=20, n_em=6)
    ref = jax_fit_multichannel_sf(jnp.asarray(X), jnp.asarray(WUF0), jnp.asarray(WGAMMA),
                                  **kw, **seeds)
    noise = np.random.default_rng(0).standard_normal(X.shape).astype(np.float32)
    ref_p = jax_fit_multichannel_sf(jnp.asarray(X * (1 + 1e-7 * noise)), jnp.asarray(WUF0),
                                    jnp.asarray(WGAMMA), **kw, **seeds)
    assert rel(ref_p.HF0, ref.HF0) > 5e-3
    got = fit_multichannel_sf(X, WUF0, WGAMMA, device=CPU, **kw, **seeds)
    for name in FIELDS:
        assert rel(getattr(got, name).numpy(), getattr(ref, name)) < 5e-2, name
    nll = np.asarray(ref.neg_log_like)
    assert np.abs(got.neg_log_like.numpy() - nll).max() / np.abs(nll).max() < 1e-4


@pytest.mark.parametrize("spatial_init", ["demix", "empirical"])
def test_separate_lead_multichannel_matches_jax(spatial_init):
    """The slice's composed pipeline, both packages from ``PRNGKey(2)``:
    stereo SIMM → spatial estimates of the separated images → composed EM
    → Wiener images, 6 SIMM iterations a round and 6 EM."""
    x = synthetic_mixture()
    jk, tk = key_kw(2)
    kw = dict(sample_rate=16000.0, n_fft=1024, hop_length=256, f0_min=100.0, f0_max=800.0,
              n_accomp=20, n_iter_simm=6, n_em=6, spatial_init=spatial_init)
    ref = jax_separate_lmc(jnp.asarray(x), **jk, **kw)
    got = separate_lead_multichannel(x, device=CPU, **tk, **kw)
    assert np.mean(got.f0 == ref.f0) >= 0.99
    for part in ("lead", "accomp"):
        want = np.asarray(getattr(ref, part))
        assert tuple(getattr(got, part).shape) == want.shape
        assert np.abs(getattr(got, part).numpy() - want).max() < 1e-2 * np.abs(x).max(), part
    nll = np.asarray(ref.model.neg_log_like)
    assert np.abs(got.model.neg_log_like.numpy() - nll).max() / np.abs(nll).max() < 1e-3


@pytest.mark.parametrize("seed", [None, 7])
def test_separate_lead_multichannel_from_a_key_matches_jax(seed):
    """The composed pipeline with no inits: the stereo SIMM draws from the
    first half of ``split(key)`` in both packages; the tolerances of
    ``test_separate_lead_multichannel_matches_jax``."""
    x = synthetic_mixture()
    jk, tk = key_kw(seed)
    kw = dict(sample_rate=16000.0, n_fft=1024, hop_length=256, f0_min=100.0, f0_max=800.0,
              n_accomp=20, n_iter_simm=6, n_em=6)
    ref = jax_separate_lmc(jnp.asarray(x), **kw, **jk)
    got = separate_lead_multichannel(x, device=CPU, **kw, **tk)
    assert np.mean(got.f0 == ref.f0) >= 0.99
    for part in ("lead", "accomp"):
        want = np.asarray(getattr(ref, part))
        assert np.abs(getattr(got, part).numpy() - want).max() < 1e-2 * np.abs(x).max(), part
    nll = np.asarray(ref.model.neg_log_like)
    assert np.abs(got.model.neg_log_like.numpy() - nll).max() / np.abs(nll).max() < 1e-3


def test_demix_init_falls_back_to_empirical_beyond_two_channels():
    x, _, _ = _stereo_melody_mixture(T=6000)
    x3 = np.concatenate([x, x[:1] * 0.5 + x[1:] * 0.5]).astype(np.float32)
    kw = dict(f0_min=150.0, f0_max=500.0, n_harmonics=8, n_accomp=4, n_iter_simm=3, n_em=2,
              device=CPU)
    a = separate_lead_multichannel(x3, spatial_init="demix", **kw)
    b = separate_lead_multichannel(x3, spatial_init="empirical", **kw)
    assert a.lead.shape == (3, 6000) and torch.equal(a.lead, b.lead)
    with pytest.raises(ValueError, match="spatial_init"):
        separate_lead_multichannel(x, spatial_init="nope", **kw)


def test_entry_points_default_to_the_card():
    import inspect

    for fn in (fit_multichannel_sf, separate_lead_multichannel):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        separate_lead_multichannel(np.zeros((2, 4000), np.float32))
