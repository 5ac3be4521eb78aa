"""Multichannel NMF separation as the benchmark serves it
(``separate.speech60``): the port against the benchmark's plain reference
(``benchmark/reference/separate.py``), on the CPU at a small size, and the
reference's work count (``benchmark/harness/roofline_sep.py``).

Tolerances, each with its reason:

- the NLL of every iteration, 1e-5 relative: both sides compute the same
  equations in float32 (complex64) from the same start, in another order
  (the port's einsums against the reference's matmuls, a reciprocal of the
  determinant against a division by it), so they part at float32 roundoff;
  the EM amplifies it, ROADMAP's "two correct implementations agree to 1e-4
  after 5–6 EM iterations", and the NLL, a sum over every bin, moves far
  less than the parameters (measured ~4e-8 at 5 iterations);
- the source images, 1e-4 relative L2: the same roundoff carried through
  the Wiener filter and the ISTFT (measured ~2e-7 at 5 iterations).

The reference with its products in TF32 (operands rounded to 10 mantissa
bits, as the card's TF32 matmul rounds them) fails these at 5 iterations.
"""

import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from benchmark.harness import roofline, roofline_sep
from benchmark.reference import separate as ref
from exemplars_vc_tpu_torch.io.standin import speech_mixture
from exemplars_vc_tpu_torch.prng import PRNGKey
from exemplars_vc_tpu_torch.separate import separate_signal
from exemplars_vc_tpu_torch.separate.glue import host_stft_stack, images_istft
from exemplars_vc_tpu_torch.separate.multichannel import _wiener_images, fit_multichannel_nmf

FIT = {"n_sources": 2, "n_components": 8, "n_em": 5, "n_fft": 400, "hop_length": 80,
       "spectral_model": "nmf", "spatial_init": "random", "key": 0}
NLL_RTOL, IMAGES_RTOL = 1e-5, 1e-4


@pytest.fixture(scope="module")
def mixture():
    x, _, _ = speech_mixture(seconds=2.0)
    return x


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def nll_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float((np.abs(a - b) / np.abs(b)).max())


def _both(x, n_em):
    """(port images, port NLLs, reference images, reference NLLs) from the
    reference's start."""
    T = x.shape[-1]
    X = ref.mixture_stft(x, 400, 80, "cpu")
    F, N, C = X.shape
    W, H, R = ref.inits(0, 2, 8, F, N, C, "cpu")
    Xp = host_stft_stack(x, 400, 80, device="cpu")
    m = fit_multichannel_nmf(Xp, n_sources=2, n_components=8, n_em=n_em, W_init=W, H_init=H,
                             R_init=R, device="cpu")
    img = images_istft(_wiener_images(Xp, m.W, m.H, m.R), 400, 80, T)
    W2, H2, R2, nlls = ref.fit(X, W, H, R, n_em)
    return img, m.neg_log_like, ref.images(X, W2, H2, R2, 400, 80, T), nlls


def test_the_reference_stft_is_the_programs(mixture):
    assert torch.equal(ref.mixture_stft(mixture, 400, 80, "cpu"),
                       host_stft_stack(mixture, 400, 80, device="cpu"))


@pytest.mark.parametrize("n_em", [1, 5])
def test_port_fit_matches_the_reference_from_its_start(mixture, n_em):
    img, nll, img_ref, nll_ref = _both(mixture, n_em)
    assert nll.shape == nll_ref.shape == (n_em,)
    assert nll_rel(nll, nll_ref) <= NLL_RTOL
    assert img.shape == img_ref.shape == (2, 2, mixture.shape[-1])
    assert rel_l2(img, img_ref) <= IMAGES_RTOL


@pytest.mark.parametrize("n_em", [1, 5])
def test_separate_signal_matches_the_reference_from_the_key(mixture, n_em):
    """The call the benchmark times, from ``PRNGKey(0)``: the port's own
    draws are the reference's."""
    img, model = separate_signal(mixture, n_sources=2, n_components=8, n_em=n_em, n_fft=400,
                                 hop_length=80, key=PRNGKey(0), device="cpu")
    img_ref, nll_ref = ref.separate(mixture, dict(FIT, n_em=n_em), "cpu")
    assert nll_rel(model.neg_log_like, nll_ref) <= NLL_RTOL
    assert rel_l2(img, img_ref) <= IMAGES_RTOL


def _tf32(t):
    """float32 rounded to TF32's 10 mantissa bits (nearest); complex by parts."""
    if t.is_complex():
        return torch.complex(_tf32(t.real), _tf32(t.imag))
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def test_the_reference_in_tf32_fails_the_tolerances(mixture, monkeypatch):
    matmul = torch.matmul
    monkeypatch.setattr(torch, "matmul", lambda a, b: matmul(_tf32(a), _tf32(b)))
    img, model = separate_signal(mixture, n_sources=2, n_components=8, n_em=5, n_fft=400,
                                 hop_length=80, key=PRNGKey(0), device="cpu")
    img_ref, nll_ref = ref.separate(mixture, FIT, "cpu")
    assert (nll_rel(model.neg_log_like, nll_ref) > NLL_RTOL
            or rel_l2(img, img_ref) > IMAGES_RTOL)


def test_the_reference_refuses_what_it_does_not_fit(mixture):
    for bad in ({"spectral_model": "hmm"}, {"spatial_init": "demix"}):
        with pytest.raises(ValueError, match="reference fits an NMF"):
            ref.separate(mixture, dict(FIT, **bad), "cpu")
    with pytest.raises(ValueError, match="stereo"):
        ref.separate(mixture[:1], FIT, "cpu")


@pytest.mark.parametrize("F,N,C,J,K,n_em,n_inner", [(201, 12001, 2, 2, 8, 50, 1),
                                                    (5, 7, 2, 3, 4, 2, 1),
                                                    (5, 7, 2, 2, 4, 3, 0)])
def test_em_work_by_hand(F, N, C, J, K, n_em, n_inner):
    # a source-bin: v 2K; vR and its sum 4C²; G and G·vR 2 × 8C³; ŷ 8C², ŷŷᴴ 6C²;
    # R̂ 4C²; the M-step's sum 4C² + 1; z 4C² + 2
    source_bin = 2 * K + 4 * C**2 + 16 * C**3 + 14 * C**2 + 4 * C**2 + 4 * C**2 + 1 \
        + 4 * C**2 + 2
    # a bin: δ and the ridge 2C + 2; the closed-form inverse 45; the NLL 8C² + 4C + 3
    bin_ = 2 * C + 2 + 45 + 8 * C**2 + 4 * C + 3
    # a source and frequency: R's mean, Hermitian part, normalization, ridge,
    # inverse, and W's rows scaled
    source_freq = 8 * C**2 + 2 * C + 47 + K
    # IS-NMF a source: six F·K·N products, the ratios twice, W's and H's updates
    nmf = 6 * 2 * F * K * N + 2 * 4 * F * N + 4 * F * K + 3 * K * N
    flops = n_em * (J * F * N * source_bin + F * N * bin_ + J * F * source_freq
                    + J * n_inner * nmf)
    # x once an iteration (complex64); W, H (float32) and R (complex64) read and written
    nbytes = n_em * (8 * F * N * C + 2 * 4 * J * F * K + 2 * 4 * J * K * N
                     + 2 * 8 * J * F * C * C)
    assert roofline_sep.em_work(F, N, C, J, K, n_em, n_inner) == (flops, nbytes)


def test_em_work_at_the_cell():
    """The cell's fit: ~101 GFLOP, so the least time is the operations'
    (~1.5 ms), and ~2 GB (~0.6 ms)."""
    flops, nbytes = roofline_sep.em_work(201, 12001, 2, 2, 8, 50, 1)
    assert 1.0e11 < flops < 1.02e11 and 1.9e9 < nbytes < 2.1e9
    assert roofline.least_seconds(flops, nbytes) == flops / roofline.PEAK_FP32_FLOPS
