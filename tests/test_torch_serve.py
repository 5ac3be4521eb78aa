"""The port's ``Converter`` (``pipelines/serve.py``) against the JAX
package's on the synthetic corpus of ``torch_corpus``, and the batch
conversion against the conversions one by one.

Tolerances. Port against JAX: audio within 1e-3 relative L2 and equal
n_iter, the rule of ``torch_corpus.assert_same_conversion`` (float32
rounding through 20 MU steps and 5 Griffin-Lim iterations). Batch against
single: ``atol=2e-4`` on the audio, the JAX package's own rule
(``tests/test_pipelines.py::test_serve_convert_batch_matches_single``), with
``nmf.tol=0`` so that the stacked solve and the single solves run the same
number of steps (a stacked solve has one n_iter, decided by the stacked
error)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from exemplars_vc_tpu.config import load_config as jload_config
from exemplars_vc_tpu.io.store import ArtifactStore as JArtifactStore
from exemplars_vc_tpu.pipelines.serve import Converter as JConverter
from exemplars_vc_tpu_torch.config import load_config
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.pipelines import convert as tconvert
from exemplars_vc_tpu_torch.pipelines import make_dict as tmake_dict
from exemplars_vc_tpu_torch.pipelines.serve import Converted, Converter
from torch_corpus import OVERRIDES, rel_l2, write_synthetic_corpus

EXACT = OVERRIDES + ["nmf.tol=0"]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_synthetic_corpus(tmp_path_factory.mktemp("synthetic_corpus"))


@pytest.fixture(scope="module")
def stores(tmp_path_factory):
    root = tmp_path_factory.mktemp("stores")
    return JArtifactStore(str(root / "j")), ArtifactStore(str(root / "t"))


def _paths(corpus):
    data, src, _ = corpus
    return [src, os.path.join(data, "SF1", "100001.wav"), os.path.join(data, "SF1", "100003.wav")]


CONFIGS = {
    "default": dict(overrides=OVERRIDES),
    "quality": dict(preset="quality", overrides=OVERRIDES),
    "context+mel": dict(overrides=OVERRIDES + ["nmf.solve_domain=mel", "nmf.solve_mels=40",
                                                "nmf.context_frames=1"]),
    "random_init": dict(overrides=OVERRIDES + ["nmf.gl_init=random"]),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_converter_matches_jax(name, corpus, stores, tmp_path):
    data = corpus[0]
    jstore, tstore = stores
    paths = _paths(corpus)
    jconv = JConverter(jload_config(**CONFIGS[name]), jstore, data, nb_file=3)
    conv = Converter(load_config(**CONFIGS[name]), tstore, data, nb_file=3, device="cpu")
    assert conv.kind == jconv.kind == "stft" and conv.prepare_seconds > 0
    for k in ("stft",):
        assert conv.dicts[k][0].shape == jconv.dicts[k][0].shape
        assert rel_l2(conv.dicts[k][1].numpy(), jconv.dicts[k][1]) < 1e-4
    ref = jconv.convert(paths[0], synth_iters=5)
    got = conv.convert(paths[0], out_path=str(tmp_path / "one.wav"), synth_iters=5)
    assert isinstance(got, Converted) and got.sr == ref.sr and got.seconds > 0
    assert got.nmf_iters == ref.nmf_iters
    np.testing.assert_allclose(got.nmf_error, ref.nmf_error, rtol=1e-3)
    assert os.path.isfile(tmp_path / "one.wav")
    refs = jconv.convert_batch(paths, synth_iters=5)
    gots = conv.convert_batch(paths, out_dir=str(tmp_path / "batch"), synth_iters=5)
    assert len(gots) == len(refs) == 3
    for p, g, r in zip(paths, gots, refs):
        assert os.path.isfile(tmp_path / "batch" / os.path.basename(p))
        assert g.nmf_iters == r.nmf_iters and g.audio.shape == r.audio.shape
        assert np.isfinite(g.audio).all()
    if name == "random_init":
        return      # the random seed phases are each package's own
    assert rel_l2(got.audio, ref.audio) < 1e-3
    for g, r in zip(gots, refs):
        assert rel_l2(g.audio, r.audio) < 1e-3


BATCH_CASES = {
    "default": [],
    "context_frames": ["nmf.context_frames=2"],
    "h_smooth": ["nmf.h_smooth=2"],
    "mel_with_context": ["nmf.solve_domain=mel", "nmf.solve_mels=40", "nmf.context_frames=1"],
    "quality": ["nmf.beta_loss=kullback-leibler", "data.dict_augment_warps=0.9,0.95,1.05,1.1",
                "nmf.h_smooth=2"],
    "prune+sharpen": ["nmf.prune_topk=8", "nmf.prune_iters=10", "nmf.activation_power=1.3"],
}


@pytest.mark.parametrize("name", list(BATCH_CASES))
def test_convert_batch_equals_single(name, corpus, stores):
    """One stacked solve ≡ the solves one by one: mel and context run per
    utterance before stacking, the box filter per utterance slice after."""
    data = corpus[0]
    conv = Converter(load_config(overrides=EXACT + BATCH_CASES[name]), stores[1], data, nb_file=3,
                     device="cpu")
    paths = _paths(corpus)
    batch = conv.convert_batch(paths, synth_iters=5)
    for p, b in zip(paths, batch):
        single = conv.convert(p, synth_iters=5)
        # the refinement reports its own budget, as in the reference
        assert b.nmf_iters == single.nmf_iters == (10 if "prune" in name else 20)
        np.testing.assert_allclose(b.audio, single.audio, atol=2e-4)
    assert conv.convert_batch([]) == []


def test_converter_prepares_once(corpus, tmp_path):
    """The dictionaries are built in ``__init__``; no conversion builds or
    aligns again, and a second converter of the same arguments takes them
    from the memo."""
    data = corpus[0]
    cfg = load_config(overrides=OVERRIDES)
    store = ArtifactStore(str(tmp_path / "s"))
    tconvert._DICTS_MEMO.clear()
    builds, dtws = tconvert._aligned_dicts.builds, tmake_dict.make_dictionary.builds
    conv = Converter(cfg, store, data, nb_file=3, device="cpu")
    counts = (tconvert._aligned_dicts.builds, tmake_dict.make_dictionary.builds)
    assert counts == (builds + 1, dtws + 1)
    conv.convert(corpus[1], synth_iters=2)
    conv.convert_batch(_paths(corpus)[:2], synth_iters=2)
    again = Converter(cfg, store, data, nb_file=3, device="cpu")
    assert (tconvert._aligned_dicts.builds, tmake_dict.make_dictionary.builds) == counts
    assert again.dicts["stft"][0].data_ptr() == conv.dicts["stft"][0].data_ptr()
    tconvert._DICTS_MEMO.clear()


def test_converter_refuses_what_is_not_ported(corpus, tmp_path):
    """Nothing is refused any more: the sharded solver (ROADMAP queue 1 item
    12) converts, in a world of one process as ``mu`` does, bit for bit; the
    WORLD path, which waited for item 10, prepares its dictionaries (its
    conversions: ``tests/test_torch_world_convert.py``)."""
    data = corpus[0]
    store = ArtifactStore(str(tmp_path / "s"))
    sharded = Converter(load_config(overrides=OVERRIDES + ["nmf.solver=mu_sharded"]), store,
                        data, nb_file=3, device="cpu").convert(corpus[1], synth_iters=2)
    plain = Converter(load_config(overrides=OVERRIDES), store, data, nb_file=3,
                      device="cpu").convert(corpus[1], synth_iters=2)
    assert sharded.nmf_iters == plain.nmf_iters
    np.testing.assert_array_equal(sharded.audio, plain.audio)
    conv = Converter(load_config(overrides=OVERRIDES + ["data.use_stft=false"]), store, data,
                     nb_file=3, device="cpu")
    assert conv.kind == "world" and conv.dicts["sp"][0].shape == (512, 513)


def test_converter_defaults_to_the_card(corpus, tmp_path):
    import inspect

    assert inspect.signature(Converter.__init__).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        Converter(load_config(overrides=OVERRIDES), ArtifactStore(str(tmp_path)), corpus[0],
                  nb_file=3)
