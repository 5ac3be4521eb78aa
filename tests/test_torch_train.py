"""The port's warping-net trainer (``exemplars_vc_tpu_torch/models/train.py``)
against the JAX package's on the stand-in corpus (3 pairs, 3 epochs), both
from the JAX package's initial parameters (carried in by monkeypatching the
port's ``init_warping_params``) or each from its own draws of one seed.

Tolerances: the datasets (the dictionary's MFCC along equal DTW paths, or
|STFT| along them) within 1e-4 of the largest value, masks equal; the
normalisation stats within 1e-6 (relative to their scale); the history's
losses within 1e-3 relative; epochs run, best epoch and the metrics' keys
equal; ``apply_warping_net`` within 1e-4 of the values' scale.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.config import load_config as jload_config
from exemplars_vc_tpu.io.store import ArtifactStore as JArtifactStore
from exemplars_vc_tpu.models import train as jtrain
from exemplars_vc_tpu.models import warping as jwarp
from exemplars_vc_tpu_torch.config import load_config
from exemplars_vc_tpu_torch.io.standin import build_standin_corpus
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.models import train as ttrain
from exemplars_vc_tpu_torch.models import warping as twarp
from exemplars_vc_tpu_torch.obs.scalars import read_scalars

OVERRIDES = ["data.tar=TF1", "misc.nb_file=3", "net.nb_epoch=3"]


@pytest.fixture(scope="module")
def standin(tmp_path_factory):
    return build_standin_corpus(str(tmp_path_factory.mktemp("standin")), n_pairs=3)[0]


def jax_init_into_port(monkeypatch):
    """The port's trainer starts from the JAX package's initial parameters
    (``init_warping_params(PRNGKey(seed))``)."""
    def init(key, cfg):
        jcfg = jwarp.WarpingNetConfig(**{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})
        params = jwarp.init_warping_params(jax.random.PRNGKey(0), jcfg)
        return twarp.warping_params_from_jax(jax.tree_util.tree_map(np.asarray, params), cfg)

    monkeypatch.setattr(ttrain, "init_warping_params", init)


def test_train_warping_net_matches_jax(standin, tmp_path, monkeypatch):
    jax_init_into_port(monkeypatch)
    jstore, tstore = JArtifactStore(str(tmp_path / "j")), ArtifactStore(str(tmp_path / "t"))
    ref = jtrain.train_warping_net(jload_config(overrides=OVERRIDES), jstore, standin, nb_file=3)
    got = ttrain.train_warping_net(load_config(overrides=OVERRIDES), tstore, standin, nb_file=3,
                                   device="cpu")
    assert sorted(got) == sorted(ref)
    for k in ("epochs_run", "best_epoch", "steps_run", "minibatch_utterances", "checkpoint"):
        assert got[k] == ref[k], k
    assert got["epochs_run"] == 3 and got["steps_run"] == 6
    for h_t, h_j in zip(got["history"], ref["history"]):
        assert h_t["epoch"] == h_j["epoch"]
        for k in ("train_loss", "test_loss", "test_l1_per_frame"):
            np.testing.assert_allclose(h_t[k], h_j[k], rtol=1e-3)
    np.testing.assert_allclose(got["best_test_loss"], ref["best_test_loss"], rtol=1e-3)

    norm_t, norm_j = tstore.load("warping_norm"), jstore.load("warping_norm")
    for k in ("mu", "sd"):
        np.testing.assert_allclose(norm_t[k], norm_j[k], rtol=0,
                                   atol=1e-6 * np.abs(norm_j[k]).max())
    events = read_scalars(f"{got['run_dir']}/scalars.jsonl")
    ref_events = read_scalars(f"{ref['run_dir']}/scalars.jsonl")
    assert [(e["step"], e["tag"]) for e in events] == [(e["step"], e["tag"]) for e in ref_events]

    feats = np.random.default_rng(0).standard_normal((2, 50, 20)).astype(np.float32) * 20
    cfg, jcfg = load_config(overrides=OVERRIDES), jload_config(overrides=OVERRIDES)
    out_t = ttrain.apply_warping_net(tstore, cfg, feats, device="cpu").numpy()
    out_j = np.asarray(jtrain.apply_warping_net(jstore, jcfg, jnp.asarray(feats)))
    np.testing.assert_allclose(out_t, out_j, rtol=0, atol=1e-4 * np.abs(out_j).max())


def test_train_warping_net_from_a_seed_matches_jax(standin, tmp_path):
    """Each trainer draws its initial net from ``PRNGKey(seed)`` itself; the
    port's draws are the JAX package's, so the runs agree as above."""
    jstore, tstore = JArtifactStore(str(tmp_path / "j")), ArtifactStore(str(tmp_path / "t"))
    ref = jtrain.train_warping_net(jload_config(overrides=OVERRIDES), jstore, standin, nb_file=3,
                                   seed=5)
    got = ttrain.train_warping_net(load_config(overrides=OVERRIDES), tstore, standin, nb_file=3,
                                   seed=5, device="cpu")
    for k in ("epochs_run", "best_epoch", "steps_run"):
        assert got[k] == ref[k], k
    for h_t, h_j in zip(got["history"], ref["history"], strict=True):
        for k in ("train_loss", "test_loss", "test_l1_per_frame"):
            np.testing.assert_allclose(h_t[k], h_j[k], rtol=1e-3)


@pytest.mark.parametrize("features", ["dict", "stft"])
def test_make_warping_dataset_matches_jax(standin, tmp_path, features):
    src_j, tar_j, mask_j = jtrain.make_warping_dataset(
        jload_config(overrides=OVERRIDES), JArtifactStore(str(tmp_path / "j")), standin,
        nb_file=3, features=features)
    src_t, tar_t, mask_t = ttrain.make_warping_dataset(
        load_config(overrides=OVERRIDES), ArtifactStore(str(tmp_path / "t")), standin,
        nb_file=3, features=features, device="cpu")
    np.testing.assert_array_equal(mask_t, mask_j)
    for got, ref in ((src_t, src_j), (tar_t, tar_j)):
        assert got.shape == ref.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    assert src_t.shape[2] == (20 if features == "dict" else 201)


def test_train_test_split_and_options(standin, tmp_path):
    for n in (1, 3, 8, 20):
        for a, b in zip(ttrain.train_test_split(n), jtrain.train_test_split(n)):
            np.testing.assert_array_equal(a, b)
    cfg = load_config(overrides=OVERRIDES)
    with pytest.raises(ValueError, match="orbax"):
        ttrain.load_params(ArtifactStore(str(tmp_path)), "x",
                           twarp.WarpingNetConfig(), backend="orbax")
    # data_parallel on one device trains as without it
    m = ttrain.train_warping_net(load_config(overrides=OVERRIDES[:2] + ["net.nb_epoch=1"]),
                                 ArtifactStore(str(tmp_path / "dp")), standin, nb_file=3,
                                 data_parallel=True, device="cpu")
    assert m["epochs_run"] == 1 and m["minibatch_utterances"] == cfg.net.batch_size
