"""The port's WORLD conversion path (``data.use_stft=false``) as a whole
against the JAX package's, on the tiny synthetic corpus of
``tests/torch_corpus.py`` (3 seeded vowel-sequence pairs, ``nmf.max_iter=20``),
with the default WORLD configuration: DIO + StoneMask, fft 1024, 5 ms
frames, log-MV f0, power-domain sp, residual compensation on.

Tolerances: equal n_iter for each solve; converted sp and ap within 1e-3
relative L2 and f0 within 1e-5 (float32 rounding through the analysis and
20 MU steps; measured ~1e-6); the audio within 1e-3 relative L2, the
synthesizer drawing the JAX synthesizer's noise from the same default key
(measured 8e-4: the synthesizer's phase
integrates f0 over every sample, so an f0 difference of 2e-4 Hz becomes a
phase drift); the MCD within 0.05 dB. The conversion features of each f0
estimator: voicing on ≥ 99 % of frames, 99th percentile ≤ 1 cent, sp and
ap within 1e-3 relative L2.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from exemplars_vc_tpu.config import load_config as jload_config
from exemplars_vc_tpu.io.store import ArtifactStore as JArtifactStore
from exemplars_vc_tpu.io.wav import read_wav as jread_wav
from exemplars_vc_tpu.pipelines import conv_dicts as jconv_dicts
from exemplars_vc_tpu.pipelines import convert as jconvert
from exemplars_vc_tpu_torch.config import load_config
from exemplars_vc_tpu_torch.io.store import ArtifactStore, load_speaker
from exemplars_vc_tpu_torch.pipelines import conv_dicts
from exemplars_vc_tpu_torch.pipelines import convert as tconvert
from exemplars_vc_tpu_torch.pipelines.make_dict import from_jax_artifacts
from exemplars_vc_tpu_torch.pipelines.serve import Converter
from torch_corpus import OVERRIDES, rel_l2, write_synthetic_corpus

WORLD = OVERRIDES + ["data.use_stft=false"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_synthetic_corpus(tmp_path_factory.mktemp("synthetic_corpus"))


@pytest.fixture(scope="module")
def jax_world(corpus, tmp_path_factory):
    """The JAX package's WORLD conversion of the held-out input, its store
    and n_iter of each solve."""
    data, src, tar = corpus
    jcfg = jload_config(overrides=WORLD)
    jstore = JArtifactStore(str(tmp_path_factory.mktemp("jax_store")))
    ref = jconvert.convert_utterance(jcfg, jstore, data, src, nb_file=3, reference_wav=tar)
    # n_iter of each solve: the same (memoised) dictionaries and features
    dicts, _ = jconvert._aligned_dicts(jcfg, jstore, data, 3)
    x, _ = jread_wav(src)
    feats = jconv_dicts.extract_world_features(x, jcfg)
    n_iter = {name: int(jconvert._solve_activations(jnp.asarray(feats[name]),
                                                     jnp.asarray(dicts[name][0]), jcfg).n_iter)
              for name in ("sp", "ap")}
    return ref, jstore, n_iter


def _assert_same_world_conversion(got, ref, n_iter):
    assert {name: s[3] for name, s in got.solves.items()} == n_iter
    assert got.n_iter == int(ref.n_iter)
    for name in ("sp", "ap"):
        Y, Yr = got.converted[name].numpy(), np.asarray(ref.converted[name])
        assert Y.shape == Yr.shape and Y.shape[1] == 513
        assert rel_l2(Y, Yr) < 1e-3, name
    f0, f0r = got.converted["f0"].numpy(), np.asarray(ref.converted["f0"])
    assert np.array_equal(f0 > 0, f0r > 0) and rel_l2(f0, f0r) < 1e-5
    assert got.audio.shape == ref.audio.shape and np.isfinite(got.audio).all()
    assert rel_l2(got.audio, ref.audio) < 1e-3
    assert abs(got.mcd_vs_reference - ref.mcd_vs_reference) < 0.05


def test_world_convert_matches_jax(corpus, jax_world, tmp_path):
    data, src, tar = corpus
    ref, jstore, n_iter = jax_world
    cfg = load_config(overrides=WORLD)
    got = tconvert.convert_utterance(cfg, ArtifactStore(str(tmp_path)), data, src, nb_file=3,
                                     reference_wav=tar, device="cpu")
    _assert_same_world_conversion(got, ref, n_iter)
    F = len(ref.audio) // 80 + 1
    assert got.solves["sp"][:3] == got.solves["ap"][:3] == (F, 512, 513)
    assert set(got.timings) == {"dicts", "features", "nmf_solve", "synthesis"}
    # the WORLD features were persisted under the reference's keys
    for spk in ("SF1", "TF1"):
        key = conv_dicts.conversion_features_key(cfg, spk, 3)
        assert key == f"conv_feats_{spk}_world_3" and jstore.has(key)
        assert ArtifactStore(str(tmp_path)).has(key)


def test_world_convert_with_jax_dictionaries(corpus, jax_world, tmp_path):
    """The JAX package's dictionary and WORLD features (its store), carried
    over: the port's solves and synthesis alone against the reference's."""
    data, src, tar = corpus
    ref, jstore, n_iter = jax_world
    store = ArtifactStore(jstore.root)
    arrays = store.load("exemplar_dict_SF12TF1_mfcc_3")
    store.save("exemplar_dict_SF12TF1_mfcc_3_torch", **from_jax_artifacts(arrays, "cpu").to_numpy())
    tconvert._DICTS_MEMO.clear()
    got = tconvert.convert_utterance(load_config(overrides=WORLD), store, data, src, nb_file=3,
                                     reference_wav=tar, device="cpu")
    _assert_same_world_conversion(got, ref, n_iter)


@pytest.mark.parametrize("method", ["dio", "ncc", "tracked", "harvest"])
def test_world_features_match_jax(corpus, method):
    """One speaker's conversion features (the batched analysis of its
    padded utterances) for each ``world.f0_method``."""
    data = corpus[0]
    over = WORLD + [f"world.f0_method={method}"]
    sigs, _ = load_speaker(data, "SF1", nb_file=3, use_native=False)
    jfeats, jlens = jconv_dicts.extract_world_features_stacked(sigs, jload_config(overrides=over))
    feats, lens = conv_dicts.extract_world_features_stacked(sigs, load_config(overrides=over), "cpu")
    np.testing.assert_array_equal(lens, jlens)
    f0, f0r = feats["f0"].numpy()[..., 0], np.asarray(jfeats["f0"])[..., 0]
    assert f0.shape == f0r.shape
    assert float(((f0 > 0) == (f0r > 0)).mean()) >= 0.99
    both = (f0 > 0) & (f0r > 0)
    assert np.percentile(1200 * np.abs(np.log2(f0[both] / f0r[both])), 99) <= 1.0
    for name in ("sp", "ap"):
        assert rel_l2(feats[name].numpy(), np.asarray(jfeats[name])) < 1e-3, name


def test_stft_speaker_dicts_match_jax(corpus, tmp_path):
    """The per-speaker build on the STFT path: the |STFT| batch, as the
    reference's (recomputed, not stored)."""
    data = corpus[0]
    ref = jconv_dicts.build_conversion_dicts(jload_config(overrides=OVERRIDES),
                                             JArtifactStore(str(tmp_path / "j")), data, "TF1", 3)
    got = conv_dicts.build_conversion_dicts(load_config(overrides=OVERRIDES),
                                            ArtifactStore(str(tmp_path / "t")), data, "TF1", 3,
                                            device="cpu")
    assert got.kind == ref.kind == "stft"
    np.testing.assert_array_equal(got.lens, ref.lens)
    np.testing.assert_allclose(got.feats["stft"].numpy(), np.asarray(ref.feats["stft"]),
                               rtol=1e-4, atol=1e-4)


def test_world_converter(corpus, tmp_path):
    """``Converter`` of the WORLD kind: ``convert`` gives the audio of
    ``convert_utterance`` on the same dictionaries (the same seeded noise),
    and ``convert_batch`` converts one by one, so its items equal single
    conversions."""
    data, src, _ = corpus
    cfg = load_config(overrides=WORLD)
    store = ArtifactStore(str(tmp_path))
    one = tconvert.convert_utterance(cfg, store, data, src, nb_file=3, device="cpu")
    conv = Converter(cfg, store, data, nb_file=3, device="cpu")
    assert conv.kind == "world" and set(conv.dicts) == {"sp", "ap", "f0"}
    got = conv.convert(src)
    np.testing.assert_array_equal(got.audio, one.audio)
    assert got.nmf_iters == one.n_iter
    batch = conv.convert_batch([src, src], out_dir=str(tmp_path / "out"))
    for b in batch:
        np.testing.assert_array_equal(b.audio, got.audio)
        assert b.nmf_iters == got.nmf_iters


@pytest.mark.parametrize("overrides", [["world.f0_method=harvest"],
                                       ["world.sp_domain=magnitude", "nmf.use_residual=off"]],
                         ids=["harvest", "magnitude-no-residual"])
def test_world_levers_convert(corpus, tmp_path, overrides):
    """The WORLD levers the chip smoke also runs: finite audio of the
    input's frames, both solves run, a finite MCD."""
    data, src, tar = corpus
    cfg = load_config(overrides=WORLD + overrides)
    res = tconvert.convert_utterance(cfg, ArtifactStore(str(tmp_path)), data, src, nb_file=3,
                                     reference_wav=tar, device="cpu")
    assert set(res.solves) == {"sp", "ap"} and np.isfinite(res.audio).all()
    assert len(res.audio) == (res.solves["sp"][0] - 1) * 80
    assert np.isfinite(res.mcd_vs_reference)
