"""Stage 02's warpings in the port (``exemplars_vc_tpu_torch/pipelines/freq_warp.py``)
against the JAX package's, on in-repo speech, seeded spectra and the
stand-in corpus (3 pairs).

Tolerances. DFW paths and warping curves are integer DTW paths and their
means: equal on the same spectra. The stage's own |STFT| pairs agree with the
JAX package's to float32 rounding (≤ 1e-6 of the largest bin; 1.4e-7
measured), and that rounding flips a few near-ties of the DFW costs: its
curves may differ by one bin on at most 0.1 % of their entries (7 of 102,912
measured) and the mean curve by 0.01 bins. ``apply_warping`` on the same
anchors: ≤ 1e-4. The AMF anchors
are LSPs of float32 LPC in the JAX package, up to ~1e-3 rad off the float64
solution on ill-conditioned speech frames (``tests/test_torch_lpc.py``); the
port's LPC is float64. So the port's anchors are held to ≤ 1e-4 rad of a
float64 oracle (``scipy.linalg.solve_toeplitz`` LPC, ``np.roots`` LSPs) on
every pair, and to the JAX package's within its own distance to that oracle
plus 1e-4; the mean anchors, within 1e-4 of the JAX package's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.config import load_config as jload_config
from exemplars_vc_tpu.io.store import ArtifactStore as JArtifactStore
from exemplars_vc_tpu.pipelines import freq_warp as jfw
from exemplars_vc_tpu_torch.config import load_config
from exemplars_vc_tpu_torch.io.standin import AUDIO_DIR, build_standin_corpus
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.io.wav import read_wav
from exemplars_vc_tpu_torch.pipelines import freq_warp as tfw
from test_torch_lpc import polynomial_roots, yule_walker

OVERRIDES = ["data.tar=TF1", "misc.nb_file=3"]


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    return build_standin_corpus(str(tmp_path_factory.mktemp("standin")), n_pairs=3)


def aligned_speech_frames(n_pairs: int = 64):
    """Raw 400-sample frame pairs at the same seeded positions of the two
    renditions of stand-in utterance 100001 (their DTW path stays near the
    diagonal)."""
    xa, _ = read_wav(str(AUDIO_DIR / "loo" / "stft_parity_100001.wav"), dtype=np.float32)
    xb, _ = read_wav(str(AUDIO_DIR / "loo" / "stft_quality_100001.wav"), dtype=np.float32)
    fa = np.lib.stride_tricks.sliding_window_view(xa, 400)[::80]
    fb = np.lib.stride_tricks.sliding_window_view(xb, 400)[::80]
    idx = np.sort(np.random.default_rng(0).choice(min(len(fa), len(fb)), n_pairs,
                                                  replace=False))
    return np.ascontiguousarray(fa[idx]), np.ascontiguousarray(fb[idx])


def amf_oracle(frames: np.ndarray) -> np.ndarray:
    """float64 LSPs (order 20) of hamming-windowed frames."""
    return polynomial_roots(yule_walker(frames * np.hamming(400), 20)[3])


def assert_anchors_match(a_t, a_j, FA, FB):
    assert a_t.shape == a_j.shape == (len(FA), 2, 22)
    assert (a_t[..., 0] == 0).all() and np.allclose(a_t[..., -1], np.pi, rtol=0, atol=1e-6)
    for side, frames in ((0, FA), (1, FB)):
        oracle = amf_oracle(frames)
        assert np.abs(a_t[:, side, 1:-1] - oracle).max() <= 1e-4
        assert (np.abs(a_t[:, side, 1:-1] - a_j[:, side, 1:-1])
                <= np.abs(a_j[:, side, 1:-1] - oracle) + 1e-4).all()


def test_amf_warping_matches_jax():
    FA, FB = aligned_speech_frames()
    a_j = np.asarray(jfw.amf_warping(jnp.asarray(FA), jnp.asarray(FB), order=20))
    a_t = tfw.amf_warping(torch.as_tensor(FA), torch.as_tensor(FB), order=20).numpy()
    assert_anchors_match(a_t, a_j, FA, FB)
    # where both frames are well conditioned the packages agree outright
    well = (yule_walker(FA * np.hamming(400), 20)[2] <= 300) & \
           (yule_walker(FB * np.hamming(400), 20)[2] <= 300)
    assert np.abs(a_t[well] - a_j[well]).max(initial=0.0) <= 1e-4


def test_apply_warping_matches_jax():
    """On the same anchors, including anchors that do not reach 0 and π
    (the edge rule: jnp.interp clamps to the end values)."""
    FA, FB = aligned_speech_frames(8)
    anchors = np.asarray(jfw.amf_warping(jnp.asarray(FA), jnp.asarray(FB), order=20))
    inner = anchors[:, :, 1:-1].copy()            # from the first LSP to the last
    rng = np.random.default_rng(3)
    for a in list(anchors) + list(inner):
        spec = np.abs(rng.standard_normal(201)).astype(np.float32)
        got = tfw.apply_warping(torch.as_tensor(spec), torch.as_tensor(a)).numpy()
        ref = np.asarray(jfw.apply_warping(jnp.asarray(spec), jnp.asarray(a)))
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4)


def tie_heavy_spectra(rng, n: int = 64, bins: int = 201) -> np.ndarray:
    """|N(0, 1)| spectra whose tails from a random bin on are exact zeros:
    their log, floored at log(1e-8), gives runs of equal costs."""
    s = np.abs(rng.standard_normal((n, bins))).astype(np.float32)
    for row, cut in zip(s, rng.integers(bins // 2, bins, n)):
        row[cut:] = 0.0
    return s


def test_dfw_warping_paths_equal_jax():
    rng = np.random.default_rng(4)
    sa, sb = tie_heavy_spectra(rng), tie_heavy_spectra(rng)
    pi_j, pj_j = jfw.dfw_warping(jnp.asarray(sa), jnp.asarray(sb))
    pi_t, pj_t = tfw.dfw_warping(torch.as_tensor(sa), torch.as_tensor(sb))
    np.testing.assert_array_equal(pi_t, np.asarray(pi_j))
    np.testing.assert_array_equal(pj_t, np.asarray(pj_j))
    for i in range(len(sa)):
        np.testing.assert_array_equal(
            tfw.warping_curve_from_path(pi_t[i], pj_t[i], 201),
            jfw.warping_curve_from_path(np.asarray(pi_j[i]), np.asarray(pj_j[i]), 201))
    # identical spectra warp by the identity
    pi, pj = tfw.dfw_warping(torch.as_tensor(sa[:2]), torch.as_tensor(sa[:2]))
    np.testing.assert_array_equal(tfw.warping_curve_from_path(pi[0], pj[0], 201), np.arange(201))


@pytest.mark.parametrize("variant", ["amf", "dfw"])
def test_run_freq_warp_matches_jax(standin, variant, tmp_path, monkeypatch):
    data = standin[0]
    seen = {}
    amf, dfw, tdfw = tfw.amf_warping, jfw.dfw_warping, tfw.dfw_warping

    def amf_spy(fa, fb, order=20):
        seen["frames"] = fa.numpy(), fb.numpy()
        return amf(fa, fb, order=order)

    def jax_dfw_spy(sa, sb):
        seen["jax_spectra"] = np.asarray(sa), np.asarray(sb)
        seen["jax_paths"] = dfw(sa, sb)
        return seen["jax_paths"]

    def dfw_spy(sa, sb):
        seen["spectra"] = sa.numpy(), sb.numpy()
        return tdfw(sa, sb)

    monkeypatch.setattr(tfw, "amf_warping", amf_spy)
    monkeypatch.setattr(tfw, "dfw_warping", dfw_spy)
    monkeypatch.setattr(jfw, "dfw_warping", jax_dfw_spy)
    ref = jfw.run_freq_warp(jload_config(overrides=OVERRIDES), JArtifactStore(str(tmp_path / "j")),
                            data, variant=variant, nb_file=3)
    store = ArtifactStore(str(tmp_path / "t"))
    got = tfw.run_freq_warp(load_config(overrides=OVERRIDES), store, data, variant=variant,
                            nb_file=3, device="cpu")
    assert sorted(got) == sorted(ref)
    if variant == "dfw":
        assert got["curves"].shape == (512, 201)
        # on the JAX package's |STFT| pairs the port's DFW gives its paths
        sa, sb = seen["jax_spectra"]
        pi, pj = tdfw(torch.as_tensor(sa), torch.as_tensor(sb))
        np.testing.assert_array_equal(pi, seen["jax_paths"][0])
        np.testing.assert_array_equal(pj, seen["jax_paths"][1])
        d = np.abs(got["curves"] - ref["curves"])
        for got_s, ref_s in zip(seen["spectra"], seen["jax_spectra"]):
            assert np.abs(got_s - ref_s).max() <= 1e-6 * np.abs(ref_s).max()
        # the curves of the two runs: a near-tie may flip on that rounding
        d = np.abs(got["curves"] - ref["curves"])
        assert d.max() <= 1.0 and (d > 0).mean() <= 1e-3
        np.testing.assert_allclose(got["mean_curve"], ref["mean_curve"], rtol=0, atol=1e-2)
    else:
        assert_anchors_match(got["anchors"], np.asarray(ref["anchors"]), *seen["frames"])
        np.testing.assert_allclose(got["mean_anchors"], ref["mean_anchors"], rtol=0, atol=1e-4)
    assert store.has(f"freq_warp_{variant}_SF12TF1_3_torch")
    again = tfw.run_freq_warp(load_config(overrides=OVERRIDES), store, data, variant=variant,
                              nb_file=3, device="cpu")          # a store hit
    assert all(np.array_equal(again[k], got[k]) for k in got)
    with pytest.raises(ValueError, match="unknown warping variant"):
        tfw.run_freq_warp(load_config(overrides=OVERRIDES), store, data, variant="nope",
                          nb_file=3, device="cpu")
