"""The port's WORLD analysis against the float64 WORLD oracles of
``tests/oracles/`` (standalone numpy ports of the published algorithms), at
the gates of the JAX package's golden tests (``tests/test_golden_dio.py``,
``tests/test_golden_world.py``). Those tests read the VCC corpus, which
the repo does not ship; these run the oracles on in-repo speech
(``artifacts/audio/loo``: two WORLD-path conversions) instead, so the port
is held to WORLD and not only to the JAX package. The STFT-path files
there carry Griffin-Lim phase artifacts on which the reference's own DIO
misses the gate too (``stft_parity_100001``: median 2.49 cents against the
oracle, JAX and port alike).

Gates (as the golden tests'):
- DIO: voicing agrees with the oracle on ≥ 90 % of frames, on frames voiced
  in both the median f0 difference ≤ 2 cents and the 95th percentile ≤ 25;
- StoneMask on the oracle's DIO contour: median ≤ 2 cents, p95 ≤ 15;
- CheapTrick on every 29th frame: log-spectral distortion ≤ 0.1 dB;
- D4C on every 29th frame: aperiodicity within 0.5 dB;
- a known vibrato contour: DIO median ≤ 15 cents from the truth, StoneMask
  ≤ 3; white noise: under 30 % of frames voiced;
- the stored goldens ``tests/goldens/world_{cheaptrick,d4c}_oracle.npz``
  at the same CheapTrick and D4C gates, where the VCC corpus they were made
  from is present (they skip otherwise, as the golden tests do);
- D4C on harmonic + noise mixes at known HNRs: the band aperiodicity falls
  with the HNR and lies within 2.5× of √(noise / total);
- CheapTrick at f0 0 equals CheapTrick at WORLD's default 500 Hz (rtol
  1e-6).
"""

import os

import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads under several workers)
from exemplars_vc_tpu_torch import world as tw
from exemplars_vc_tpu_torch.io.wav import read_wav
from tests.oracles.make_goldens import W_FFT, W_HOP_MS, WORLD_UTTS
from tests.oracles.world_cheaptrick import cheaptrick_oracle
from tests.oracles.world_d4c import d4c_oracle
from tests.oracles.world_dio import dio_oracle, stonemask_refine_oracle
from tests.test_golden_world import REF_DATA   # the VCC corpus the goldens were made from

TESTS = os.path.dirname(os.path.abspath(__file__))
LOO = os.path.join(TESTS, "..", "artifacts", "audio", "loo")
UTTS = ("world_parity_100001", "world_parity_100005")
STRIDE = 29     # golden frames: every 29th (tests/oracles/make_goldens.py)


@pytest.fixture(scope="module", params=UTTS)
def speech(request):
    x, sr = read_wav(os.path.join(LOO, request.param + ".wav"))
    return request.param, np.asarray(x, np.float64), sr


def _cents(a, b):
    return 1200 * np.abs(np.log2(a / b))


def test_dio_matches_oracle(speech):
    utt, x, sr = speech
    f0_o, _ = dio_oracle(x, sr)
    f0_t = tw.estimate_f0_dio(torch.as_tensor(x, dtype=torch.float32), sr=sr)[0].numpy()
    n = min(len(f0_o), len(f0_t))
    f0_o, f0_t = f0_o[:n], f0_t[:n]
    assert float(((f0_o > 0) == (f0_t > 0)).mean()) >= 0.90, utt
    both = (f0_o > 0) & (f0_t > 0)
    assert both.sum() > 50, utt
    cents = _cents(f0_t[both], f0_o[both])
    assert np.median(cents) <= 2.0 and np.percentile(cents, 95) <= 25.0, (
        utt, float(np.median(cents)), float(np.percentile(cents, 95)))


def test_stonemask_matches_oracle(speech):
    """The same input contour (the oracle's DIO) through both refiners."""
    utt, x, sr = speech
    f0_o, pos = dio_oracle(x, sr)
    ref_o = stonemask_refine_oracle(x, sr, f0_o, pos)
    ref_t = tw.refine_f0_stonemask(torch.as_tensor(x, dtype=torch.float32),
                                   torch.as_tensor(f0_o, dtype=torch.float32), sr=sr).numpy()
    n = min(len(ref_o), len(ref_t))
    m = (ref_o[:n] > 0) & (ref_t[:n] > 0)
    assert m.sum() > 50, utt
    cents = _cents(ref_t[:n][m], ref_o[:n][m])
    assert np.median(cents) <= 2.0 and np.percentile(cents, 95) <= 15.0, (
        utt, float(np.median(cents)), float(np.percentile(cents, 95)))


def _golden_frames(x, sr):
    """The golden tests' contour (the NCC estimator refined by StoneMask,
    tests/oracles/make_goldens.py) and its every 29th frame."""
    xt = torch.as_tensor(x, dtype=torch.float32)
    f0 = tw.refine_f0_stonemask(xt, tw.estimate_f0(xt, sr=sr)[0], sr=sr).numpy()
    sel = np.arange(0, len(f0), STRIDE)
    return xt, f0, sel


def test_cheaptrick_matches_oracle(speech):
    utt, x, sr = speech
    xt, f0, sel = _golden_frames(x, sr)
    centers = np.arange(len(f0)) * 80
    env = tw.cheaptrick(xt, torch.as_tensor(f0), torch.as_tensor(centers), sr=sr,
                        fft_size=1024).numpy()[sel]
    ref = cheaptrick_oracle(x, sr, f0[sel].astype(np.float64), sel * 80 / sr, fft_size=1024)
    lsd = np.sqrt(np.mean((10 * np.log10(env + 1e-30) - 10 * np.log10(ref + 1e-30)) ** 2, -1))
    assert lsd.max() <= 0.1, (utt, float(lsd.max()))


def test_d4c_matches_oracle(speech):
    utt, x, sr = speech
    xt, f0, sel = _golden_frames(x, sr)
    centers = np.arange(len(f0)) * 80
    ap = tw.d4c_aperiodicity(xt, torch.as_tensor(f0), torch.as_tensor(centers), sr=sr,
                             fft_size=1024).numpy()[sel]
    ref = d4c_oracle(x, sr, f0[sel].astype(np.float64), sel * 80 / sr, 1024)
    d_db = np.abs(20 * np.log10(ap + 1e-12) - 20 * np.log10(ref + 1e-12))
    assert d_db.max() <= 0.5, (utt, float(d_db.max()))


def test_dio_known_truth_synthetic():
    """A known contour (vibrato, 11 harmonics, noise): DIO within 15 cents
    median of the truth, StoneMask within 3."""
    fs = 16000
    t = np.arange(int(fs * 0.8)) / fs
    f_true = 180.0 + 12.0 * np.sin(2 * np.pi * 4.0 * t)
    phase = 2 * np.pi * np.cumsum(f_true) / fs
    rng = np.random.default_rng(0)
    x = sum(np.sin(k * phase) / k for k in range(1, 12))
    x = torch.as_tensor((x + 0.02 * rng.standard_normal(len(t))).astype(np.float32))
    f0, _ = tw.estimate_f0_dio(x, sr=fs)
    f0 = f0.numpy()
    truth = np.interp(np.arange(len(f0)) * 0.005, t, f_true)
    v = f0 > 0
    assert v.mean() > 0.9
    assert np.median(_cents(f0[v], truth[v])) <= 15.0
    ref = tw.refine_f0_stonemask(x, torch.as_tensor(f0), sr=fs).numpy()
    m = ref > 0
    assert np.median(_cents(ref[m], truth[m])) <= 3.0


def test_dio_rejects_white_noise():
    rng = np.random.default_rng(1)
    x = torch.as_tensor((0.1 * rng.standard_normal(16000)).astype(np.float32))
    assert float(tw.estimate_f0_dio(x, sr=16000)[1].float().mean()) < 0.3


@pytest.mark.parametrize("what", ["cheaptrick", "d4c"])
def test_matches_stored_goldens(what):
    """The goldens' own contour and frames, their gates: LSD ≤ 0.1 dB
    (CheapTrick), ≤ 0.5 dB (D4C)."""
    if not os.path.isdir(REF_DATA):
        pytest.skip("reference data not available")
    gold = np.load(os.path.join(TESTS, "goldens", "world_cheaptrick_oracle.npz"))
    d4c_gold = np.load(os.path.join(TESTS, "goldens", "world_d4c_oracle.npz"))
    for spk, name in WORLD_UTTS:
        key = f"{spk}_{name}"
        x, sr = read_wav(os.path.join(REF_DATA, spk, name + ".wav"))
        f0, sel = gold[f"{key}_f0"], gold[f"{key}_sel"]
        centers = torch.arange(len(f0)) * int(round(sr * W_HOP_MS / 1000.0))
        args = (torch.as_tensor(x, dtype=torch.float32), torch.as_tensor(f0, dtype=torch.float32),
                centers)
        if what == "cheaptrick":
            env = tw.cheaptrick(*args, sr=sr, fft_size=W_FFT).numpy()[sel]
            lsd = np.sqrt(np.mean((10 * np.log10(env + 1e-30)
                                   - 10 * np.log10(gold[f"{key}_sp"].astype(np.float64) + 1e-30))
                                  ** 2, -1))
            assert lsd.max() <= 0.1, (key, float(lsd.max()))
        else:
            ap = tw.d4c_aperiodicity(*args, sr=sr, fft_size=W_FFT).numpy()[sel]
            ref = d4c_gold[f"{key}_ap"].astype(np.float64)
            d_db = np.abs(20 * np.log10(ap + 1e-12) - 20 * np.log10(ref + 1e-12))
            assert d_db.max() <= 0.5, (key, float(d_db.max()))


def test_d4c_known_hnr():
    """Harmonic (1/k roll-off) + white noise at HNR 20, 10, 0 dB: the median
    aperiodicity of the 2.3–3.6 kHz band falls with the HNR and lies within
    2.5× of the band's √(noise / total)."""
    sr, f0v = 16000, 200.0
    t = np.arange(int(sr * 0.6)) / sr
    rng = np.random.default_rng(0)
    harm = np.zeros_like(t)
    for k in range(1, 36):
        if k * f0v < 7800:
            harm += np.sin(2 * np.pi * k * f0v * t + rng.uniform(0, 6)) / k
    harm /= np.sqrt(np.mean(harm ** 2))
    noise = rng.standard_normal(len(t))
    noise /= np.sqrt(np.mean(noise ** 2))
    n_frames = len(t) // 80
    centers = torch.arange(n_frames) * 80
    f0 = torch.full((n_frames,), f0v)
    freqs = np.fft.rfftfreq(len(t), 1 / sr)
    band = (freqs > 2300) & (freqs < 3600)
    ph = np.sum(np.abs(np.fft.rfft(harm))[band] ** 2)
    pn = np.sum(np.abs(np.fft.rfft(noise))[band] ** 2)
    measured = []
    for hnr_db in (20.0, 10.0, 0.0):
        g = 10.0 ** (-hnr_db / 20.0)
        x = torch.as_tensor((harm + g * noise).astype(np.float32))
        ap = tw.d4c_aperiodicity(x, f0, centers, sr=sr, fft_size=1024).numpy()
        measured.append(float(np.median(ap[5:-5, 150:230])))
        expected = np.sqrt(g * g * pn / (ph + g * g * pn))
        assert expected / 2.5 < measured[-1] < min(1.0, expected * 2.5), (hnr_db, measured[-1])
    assert measured[0] < measured[1] < measured[2]


def test_cheaptrick_unvoiced_uses_default_f0():
    """WORLD's rule: an f0 at or below the floor (unvoiced 0 too) is
    analysed at kDefaultF0 = 500 Hz."""
    x, sr = read_wav(os.path.join(LOO, UTTS[0] + ".wav"))
    xt = torch.as_tensor(x, dtype=torch.float32)
    centers = torch.arange(10) * 80 + 8000
    e0 = tw.cheaptrick(xt, torch.zeros(10), centers, sr=sr, fft_size=1024)
    e500 = tw.cheaptrick(xt, torch.full((10,), 500.0), centers, sr=sr, fft_size=1024)
    torch.testing.assert_close(e0, e500, rtol=1e-6, atol=0)
