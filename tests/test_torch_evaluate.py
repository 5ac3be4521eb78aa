"""The port's evaluation protocols (``exemplars_vc_tpu_torch/pipelines/evaluate.py``)
and its MCEP-aligned dictionary against the JAX package's, on the stand-in
corpus (3 pairs; 20 MU iterations and 5 Griffin-Lim iterations to keep the
CPU run short).

Tolerances: configurations, fold lists and fold directories equal; MCDs
within 0.05 dB (the conversion tests' rule); MCEP dictionary paths equal,
features within 1e-4 of their largest value.
"""

import dataclasses
import os

import numpy as np
import pytest

import torch_corpus
from exemplars_vc_tpu.config import load_config as jload_config
from exemplars_vc_tpu.io.store import ArtifactStore as JArtifactStore
from exemplars_vc_tpu.pipelines import evaluate as jeval
from exemplars_vc_tpu.pipelines.make_dict import make_dictionary as jmake_dictionary
from exemplars_vc_tpu_torch.config import load_config
from exemplars_vc_tpu_torch.io.standin import build_standin_corpus
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.pipelines import evaluate as teval
from exemplars_vc_tpu_torch.pipelines.make_dict import make_dictionary

OVERRIDES = torch_corpus.OVERRIDES          # TF1, 3 files, 20 MU iterations


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    return build_standin_corpus(str(tmp_path_factory.mktemp("standin")), n_pairs=3)


@pytest.mark.parametrize("preset", [None, "quality"])
def test_configs_and_levers_equal_jax(preset):
    cfg, jcfg = load_config(preset=preset), jload_config(preset=preset)
    for fn in ("_configs", "lever_configs"):
        got, ref = getattr(teval, fn)(cfg), getattr(jeval, fn)(jcfg)
        assert list(got) == list(ref)
        for name in got:
            assert dataclasses.asdict(got[name]) == dataclasses.asdict(ref[name]), (fn, name)


def test_folds_and_fold_dirs_equal_jax(standin, tmp_path):
    data = standin[0]
    cfg = load_config(overrides=OVERRIDES)
    assert teval.loo_utterances(data, "SF1", "TF1") == \
        jeval.loo_utterances(data, "SF1", "TF1") == ["100001", "100002", "100003"]
    for root, mod in ((tmp_path / "t", teval), (tmp_path / "j", jeval)):
        fold = mod._fold_data_dir(str(root), data, cfg, "100002")
        assert fold == os.path.join(str(root), "loo", "data_wo_100002")
    for spk in ("SF1", "TF1"):
        t_dir = tmp_path / "t" / "loo" / "data_wo_100002" / spk
        j_dir = tmp_path / "j" / "loo" / "data_wo_100002" / spk
        assert sorted(os.listdir(t_dir)) == sorted(os.listdir(j_dir)) == ["100001.wav",
                                                                          "100003.wav"]
        for n in os.listdir(t_dir):
            assert os.readlink(t_dir / n) == os.readlink(j_dir / n)
    # a second call keeps the links
    teval._fold_data_dir(str(tmp_path / "t"), data, cfg, "100002")
    assert teval.reference_artifacts(data) == jeval.reference_artifacts(data) == {}


def test_evaluate_heldout_matches_jax(standin, tmp_path):
    data = standin[0]
    ref = jeval.evaluate_heldout(jload_config(overrides=OVERRIDES),
                                 JArtifactStore(str(tmp_path / "j")), data, nb_file=3,
                                 configs=["stft_parity"], synth_iters=5)
    got = teval.evaluate_heldout(load_config(overrides=OVERRIDES),
                                 ArtifactStore(str(tmp_path / "t")), data, nb_file=3,
                                 configs=["stft_parity"], synth_iters=5, device="cpu")
    assert list(got) == ["stft_parity"]
    assert np.isfinite(got["stft_parity"].mcd)
    assert abs(got["stft_parity"].mcd - ref["stft_parity"].mcd) <= 0.05
    assert got["stft_parity"].result.n_iter == ref["stft_parity"].result.n_iter
    base_t = teval.no_conversion_baseline(load_config(overrides=OVERRIDES), data, device="cpu")
    base_j = jeval.no_conversion_baseline(jload_config(overrides=OVERRIDES), data)
    assert abs(base_t - base_j) <= 0.05


def test_evaluate_loo_matches_jax(standin, tmp_path):
    data = standin[0]
    kw = dict(folds=["100001"], configs=["stft_parity"], synth_iters=5)
    ref_folds, ref_sum = jeval.evaluate_loo(jload_config(overrides=OVERRIDES),
                                            JArtifactStore(str(tmp_path / "j")), data, **kw)
    folds, summary = teval.evaluate_loo(load_config(overrides=OVERRIDES),
                                        ArtifactStore(str(tmp_path / "t")), data,
                                        audio_dir=str(tmp_path / "audio"), device="cpu", **kw)
    assert [f.utt for f in folds] == [f.utt for f in ref_folds] == ["100001"]
    assert abs(folds[0].mcd["stft_parity"] - ref_folds[0].mcd["stft_parity"]) <= 0.05
    assert abs(folds[0].no_conversion_mcd - ref_folds[0].no_conversion_mcd) <= 0.05
    assert sorted(summary) == sorted(ref_sum) and sorted(summary["stft_parity"]) == \
        sorted(ref_sum["stft_parity"])
    assert summary["stft_parity"]["n"] == 1 and summary["stft_parity"]["std"] == 0.0
    assert summary["stft_parity"]["folds_beating_anchor"] == \
        ref_sum["stft_parity"]["folds_beating_anchor"]
    assert os.path.isfile(tmp_path / "audio" / "stft_parity_100001.wav")
    with pytest.raises(FileNotFoundError, match="no foldable pairs"):
        teval.evaluate_loo(load_config(overrides=OVERRIDES), ArtifactStore(str(tmp_path / "t")),
                           data, folds=["999999"], device="cpu")


def test_make_dictionary_mcep_matches_jax(standin, tmp_path):
    data = standin[0]
    jart = jmake_dictionary(jload_config(overrides=OVERRIDES), JArtifactStore(str(tmp_path / "j")),
                            data, feat="mcep", nb_file=3)
    store = ArtifactStore(str(tmp_path / "t"))
    tart = make_dictionary(load_config(overrides=OVERRIDES), store, data, feat="mcep", nb_file=3,
                           device="cpu")
    for name in ("path_i", "path_j", "path_len", "len_a", "len_b"):
        np.testing.assert_array_equal(getattr(tart, name).numpy(), np.asarray(getattr(jart, name)))
    for name in ("feat_a", "feat_b"):
        ref = np.asarray(getattr(jart, name))
        assert getattr(tart, name).shape == ref.shape and ref.shape[2] == 26
        np.testing.assert_allclose(getattr(tart, name).numpy(), ref, rtol=0,
                                   atol=1e-4 * np.abs(ref).max())
    assert store.has("exemplar_dict_SF12TF1_mcep_3_torch")
    with pytest.raises(ValueError, match="unsupported alignment feature"):
        make_dictionary(load_config(overrides=OVERRIDES), store, data, feat="lpc", nb_file=3,
                        device="cpu")
