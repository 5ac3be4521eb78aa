"""The port's WORLD modules against the JAX package's, module by module, on
the same numpy inputs: a seeded 0.6 s voiced signal (vibrato, 14
harmonics, a little noise) and 0.6 s of in-repo speech
(``artifacts/audio/loo``). The JAX side runs on the CPU as its own tests
run it; its outputs are made once per module.

Tolerances, each stated where it is checked:
- f0 estimators (DIO, Harvest, NCC, tracked): voicing agrees on ≥ 99 % of
  frames, and on frames voiced in both the 99th percentile of the f0
  difference is ≤ 1 cent (measured ≤ 0.006 cents);
- StoneMask, CheapTrick and D4C are given the same f0 (the JAX one, so a
  voicing flip cannot hide a drift): refined f0 within 0.1 cent, sp within
  0.01 dB, ap within 1e-3 absolute (measured 0.0004 cents, 0.0003 dB,
  7e-6);
- ``synthesize`` from the same key, whose noise is the JAX package's within
  3 ulp: relative L2 ≤ 1e-4 (measured
  5e-5 to 8e-5: the phase is a float32 running sum over every sample, and
  the cosines of k·φ reach 10⁵ rad);
- ``convert_f0_logmv`` ≤ 1e-5 relative.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads under several workers)
from exemplars_vc_tpu import world as jw
from exemplars_vc_tpu.pipelines.convert import convert_f0_logmv as jconvert_f0_logmv
from exemplars_vc_tpu.world.cheaptrick import world_fft_size as jworld_fft_size
from exemplars_vc_tpu.world.dio import _extend_from_candidates as jextend
from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch import world as tw
from exemplars_vc_tpu_torch.io.wav import read_wav
from exemplars_vc_tpu_torch.pipelines.convert import convert_f0_logmv
from exemplars_vc_tpu_torch.world import _ops, dio as tdio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SR = 16000
SIGNALS = ("voiced", "speech")


def _voiced(rng) -> np.ndarray:
    t = np.arange(int(0.6 * SR)) / SR
    phase = 2 * np.pi * np.cumsum(180 + 20 * np.sin(2 * np.pi * 3 * t)) / SR
    x = sum(np.sin(k * phase) / k for k in range(1, 15)) * np.hanning(len(t)) ** 0.3
    return (x + 0.01 * rng.standard_normal(len(t))).astype(np.float32)


@pytest.fixture(scope="module")
def signals():
    loo = os.path.join(REPO, "artifacts", "audio", "loo")
    speech, sr = read_wav(os.path.join(loo, sorted(os.listdir(loo))[0]))
    assert sr == SR
    start = 10_000          # its most voiced 0.6 s (two thirds of the frames)
    return {"voiced": _voiced(np.random.default_rng(0)),
            "speech": np.asarray(speech[start:start + int(0.6 * SR)], np.float32)}


@pytest.fixture(scope="module")
def jref(signals):
    """The JAX package's outputs on each signal, made once."""
    out = {}
    for name, x in signals.items():
        xj = jnp.asarray(x)
        f0 = np.asarray(jw.estimate_f0_dio(xj)[0])
        refined = np.asarray(jw.refine_f0_stonemask(xj, jnp.asarray(f0)))
        centers = np.arange(len(refined)) * 80
        sp = np.asarray(jw.cheaptrick(xj, jnp.asarray(refined), jnp.asarray(centers)))
        ap = np.asarray(jw.d4c_aperiodicity(xj, jnp.asarray(refined), jnp.asarray(centers)))
        out[name] = dict(
            dio=f0, harvest=np.asarray(jw.estimate_f0_harvest(xj)[0]),
            ncc=np.asarray(jw.estimate_f0(xj)[0]), tracked=np.asarray(jw.estimate_f0_tracked(xj)[0]),
            refined=refined, centers=centers, sp=sp, ap=ap,
            audio=np.asarray(jw.synthesize(jnp.asarray(refined), jnp.asarray(sp), jnp.asarray(ap))))
    return out


def _assert_same_contour(got, ref, what):
    """Voicing agrees on ≥ 99 % of frames; on frames voiced in both, the
    99th percentile of the difference is ≤ 1 cent."""
    assert got.shape == ref.shape, what
    agree = float(((got > 0) == (ref > 0)).mean())
    assert agree >= 0.99, (what, agree)
    both = (got > 0) & (ref > 0)
    assert both.sum() > 20, what
    cents = 1200 * np.abs(np.log2(got[both] / ref[both]))
    assert np.percentile(cents, 99) <= 1.0, (what, float(np.percentile(cents, 99)))


@pytest.mark.parametrize("sig", SIGNALS)
@pytest.mark.parametrize("method", ["dio", "harvest", "ncc", "tracked"])
def test_f0_estimators_match_jax(signals, jref, sig, method):
    fn = {"dio": tw.estimate_f0_dio, "harvest": tw.estimate_f0_harvest,
          "ncc": tw.estimate_f0, "tracked": tw.estimate_f0_tracked}[method]
    f0, voiced = fn(torch.as_tensor(signals[sig]))
    assert torch.equal(voiced, f0 > 0)
    _assert_same_contour(f0.numpy(), jref[sig][method], f"{method} on {sig}")


@pytest.mark.parametrize("sig", SIGNALS)
def test_stonemask_matches_jax(signals, jref, sig):
    """Refined f0 within 0.1 cent on the same input contour."""
    r = jref[sig]
    got = tw.refine_f0_stonemask(torch.as_tensor(signals[sig]), torch.as_tensor(r["dio"])).numpy()
    assert np.array_equal(got > 0, r["refined"] > 0)
    v = got > 0
    assert np.abs(1200 * np.log2(got[v] / r["refined"][v])).max() <= 0.1


@pytest.mark.parametrize("sig", SIGNALS)
def test_cheaptrick_matches_jax(signals, jref, sig):
    """sp within 0.01 dB on every bin of every frame."""
    r = jref[sig]
    sp = tw.cheaptrick(torch.as_tensor(signals[sig]), torch.as_tensor(r["refined"]),
                       torch.as_tensor(r["centers"])).numpy()
    assert sp.shape == r["sp"].shape == (len(r["refined"]), 513)
    assert np.abs(10 * np.log10(sp) - 10 * np.log10(r["sp"])).max() <= 0.01


@pytest.mark.parametrize("sig", SIGNALS)
def test_d4c_matches_jax(signals, jref, sig):
    """ap within 1e-3 absolute, and the same frames fully aperiodic."""
    r = jref[sig]
    ap = tw.d4c_aperiodicity(torch.as_tensor(signals[sig]), torch.as_tensor(r["refined"]),
                             torch.as_tensor(r["centers"])).numpy()
    assert ap.shape == r["ap"].shape
    assert np.abs(ap - r["ap"]).max() <= 1e-3
    assert 0 < ap.min() and ap.max() < 1


@pytest.mark.parametrize("sig", SIGNALS)
def test_synthesize_matches_jax_with_its_noise(signals, jref, sig):
    """The default key draws the JAX synthesizer's own noise
    (``normal(PRNGKey(0))``, within 3 ulp)."""
    r = jref[sig]
    y = tw.synthesize(torch.as_tensor(r["refined"]), torch.as_tensor(r["sp"]),
                      torch.as_tensor(r["ap"])).numpy()
    assert y.shape == r["audio"].shape and np.isfinite(y).all()
    assert np.linalg.norm(y - r["audio"]) / np.linalg.norm(r["audio"]) <= 1e-4


def test_synthesize_noise_is_seeded(jref):
    """The noise comes from ``key`` (``PRNGKey(0)`` when None): two calls
    give the same audio, another key other audio, the JAX package's for
    that key."""
    r = jref["speech"]
    args = [torch.as_tensor(r[k]) for k in ("refined", "sp", "ap")]
    a, b = tw.synthesize(*args), tw.synthesize(*args)
    c = tw.synthesize(*args, key=prng.PRNGKey(1)).numpy()
    assert torch.equal(a, b) and not np.array_equal(a.numpy(), c)
    want = np.asarray(jw.synthesize(*(jnp.asarray(r[k]) for k in ("refined", "sp", "ap")),
                                    key=jax.random.PRNGKey(1)))
    assert np.linalg.norm(c - want) / np.linalg.norm(want) <= 1e-4


def test_default_noise_is_kept_and_sliced(jref):
    """The default key's noise is drawn once and sliced: a shorter, a longer
    and again a shorter synthesis give the audio of an explicit
    ``PRNGKey(0)``, whose draw is made anew each call."""
    from exemplars_vc_tpu_torch.world import synthesis

    r = jref["speech"]
    args = [torch.as_tensor(r[k]) for k in ("refined", "sp", "ap")]
    synthesis._DEFAULT_NOISE.clear()
    for n in (len(args[0]) // 2, len(args[0]), len(args[0]) // 3):
        part = [a[:n] for a in args]
        assert torch.equal(tw.synthesize(*part), tw.synthesize(*part, key=prng.PRNGKey(0))), n
    assert len(synthesis._DEFAULT_NOISE[torch.device("cpu")]) == (len(args[0]) - 1) * 80


def test_analyze_batch_equals_single(signals):
    """Two utterances of one length analysed as a batch give what each
    gives alone (per-row reductions only), DIO and StoneMask on."""
    x = torch.as_tensor(np.stack([signals["voiced"], signals["speech"]]))
    both = tw.analyze(x, f0_method="dio")
    for u in range(2):
        one = tw.analyze(x[u], f0_method="dio")
        assert torch.equal(both.f0[u] > 0, one.f0 > 0)
        torch.testing.assert_close(both.f0[u], one.f0, rtol=1e-6, atol=0)
        torch.testing.assert_close(both.sp[u], one.sp, rtol=1e-5, atol=0)
        torch.testing.assert_close(both.ap[u], one.ap, rtol=1e-5, atol=1e-7)


def test_convert_f0_logmv_matches_jax():
    rng = np.random.default_rng(3)
    f0 = rng.uniform(90, 200, (50, 1)).astype(np.float32)
    f0[::7] = 0
    A = np.concatenate([rng.uniform(80, 180, (40, 1)), np.zeros((24, 1))]).astype(np.float32)
    B = np.concatenate([rng.uniform(150, 300, (40, 1)), np.zeros((24, 1))]).astype(np.float32)
    A[::5] = 0
    ref = np.asarray(jconvert_f0_logmv(jnp.asarray(f0), jnp.asarray(A), jnp.asarray(B)))
    got = convert_f0_logmv(*(torch.as_tensor(a) for a in (f0, A, B))).numpy()
    assert np.array_equal(got > 0, ref > 0) and (got[::7] == 0).all()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


@pytest.mark.parametrize("sr,floor", [(16000, 71.0), (16000, 40.0), (22050, 71.0),
                                       (48000, 71.0)])
def test_world_fft_size_matches_jax(sr, floor):
    """CheapTrick's default FFT size (1024 at the repo's 16 kHz, floor 71)."""
    assert tw.world_fft_size(sr, floor) == jworld_fft_size(sr, floor)
    assert tw.world_fft_size(16000, 71.0) == 1024


@pytest.mark.parametrize("n", [1, 5, 16, 17, 1000, 55_000])
def test_cumsum_rounds_as_xla(n):
    """The float32 running sum of the port equals ``jnp.cumsum`` under jit
    on the CPU bit for bit (XLA's order: rows of 16, carried)."""
    x = np.random.default_rng(n).uniform(100, 200, n).astype(np.float32)
    ref = np.asarray(jax.jit(jnp.cumsum)(jnp.asarray(x)))
    np.testing.assert_array_equal(_ops.cumsum(torch.as_tensor(x)).numpy(), ref)


def test_interp_matches_jnp():
    xp = np.asarray([0.0, 3000.0, 8000.0], np.float32)
    fp = np.random.default_rng(1).uniform(-60, 0, (4, 3)).astype(np.float32)
    x = np.linspace(-100, 8100, 97).astype(np.float32)
    ref = np.stack([np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp), jnp.asarray(f)))
                    for f in fp])
    got = _ops.interp(torch.as_tensor(x), torch.as_tensor(xp), torch.as_tensor(fp)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("check_every", [1, 3, 16])
def test_extension_checks_every_n_sweeps(check_every, monkeypatch):
    """The candidate-pool extension checks for a stable contour every n
    sweeps: the result equals the reference's loop (a check every sweep),
    and a check is one host sync, counted."""
    rng = np.random.default_rng(5)
    C, Fr = 4, 120
    cands = rng.uniform(100, 120, (C, Fr)).astype(np.float32)
    cands[rng.random((C, Fr)) < 0.3] = 0
    f0 = np.zeros(Fr, np.float32)
    f0[[10, 60, 61, 100]] = cands[0, [10, 60, 61, 100]]
    ref = np.asarray(jextend(jnp.asarray(f0), jnp.asarray(cands), 0.1))
    monkeypatch.setattr(tdio, "EXTEND_CHECK_EVERY", check_every)
    before = tdio.extend_from_candidates.syncs
    got = tdio.extend_from_candidates(torch.as_tensor(f0)[None], torch.as_tensor(cands)[None], 0.1)
    np.testing.assert_array_equal(got[0].numpy(), ref)
    syncs = tdio.extend_from_candidates.syncs - before
    assert 1 <= syncs <= -(-Fr // check_every)
