"""The dictionary-sharded conversion and the data-parallel warping-net
training over two processes (one world on the CPU over gloo, spawned once
for the module).

- ``convert_utterance`` with ``nmf.solver=mu_sharded`` against the port's
  ``mu`` run in the same rank, as the JAX package's two-process gate
  (``tests/test_multihost.py::test_two_process_production_convert``) holds
  it: 10 MU steps without the tolerance, two pairs, the first second of the
  held-out input, dY = max|Y_sharded − Y_mu| / max|Y_mu| ≤ 2e-3; both ranks'
  Y and audio equal bit for bit.
- ``train_warping_net(data_parallel=True)`` at W = 2 with
  ``net.batch_size=8`` (a multiple of 2 and of the JAX side's 8 devices)
  against the JAX trainer with ``data_parallel=True`` from the same initial
  parameters: the history within 1e-3 relative (the tolerance of
  ``tests/test_torch_train.py``), equal step counts and minibatch size; the
  two ranks' parameters equal bit for bit.
"""

import jax
import numpy as np
import pytest

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.config import load_config as jload_config
from exemplars_vc_tpu.io.store import ArtifactStore as JArtifactStore
from exemplars_vc_tpu.models import train as jtrain
from exemplars_vc_tpu.models import warping as jwarp
from exemplars_vc_tpu_torch.io.standin import build_standin_corpus
from torch_parallel_workers import run_world

TRAIN_OVERRIDES = ["data.tar=TF1", "misc.nb_file=3", "net.nb_epoch=3", "net.batch_size=8"]


def _jax_init_leaves():
    """The JAX trainer's initial parameters (``PRNGKey(0)``) as the
    ``leaf_i`` leaves of its checkpoints."""
    net = jload_config(overrides=TRAIN_OVERRIDES).net
    jcfg = jwarp.WarpingNetConfig(in_size=net.in_size, hidden_size=net.hidden_size,
                                  out_size=net.out_size, nb_lstm_layers=net.nb_lstm_layers,
                                  bidirectional=net.bidirectional)
    params = jwarp.init_warping_params(jax.random.PRNGKey(0), jcfg)
    return {f"leaf_{i}": np.asarray(x) for i, x in enumerate(jax.tree_util.tree_leaves(params))}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("parallel_convert")
    data2, wav, _ = build_standin_corpus(str(root / "c2"), n_pairs=2)
    data3 = build_standin_corpus(str(root / "c3"), n_pairs=3)[0]
    stores = root / "stores"
    stores.mkdir()
    cases = [("convert", (data2, wav, str(stores))),
             ("train", (data3, str(stores), _jax_init_leaves(), TRAIN_OVERRIDES))]
    ranks = run_world(2, cases)
    return {"convert": [r["cases"][0] for r in ranks], "train": [r["cases"][1] for r in ranks],
            "data3": data3, "root": root}


def test_two_rank_sharded_conversion(world):
    r0, r1 = world["convert"]
    for r in (r0, r1):
        Y, Ymu = r["sharded"]["Y"].double().numpy(), r["mu"]["Y"].double().numpy()
        dY = float(np.abs(Y - Ymu).max() / max(np.abs(Ymu).max(), 1e-12))
        assert dY <= 2e-3, dY
        assert np.isfinite(r["sharded"]["audio"]).all()
        assert r["sharded"]["n_iter"] == r["mu"]["n_iter"] == 10
        assert r["sharded"]["K"] % 2 == 0
    assert r0["sharded"]["Y"].equal(r1["sharded"]["Y"])
    np.testing.assert_array_equal(r0["sharded"]["audio"], r1["sharded"]["audio"])


def test_data_parallel_training_matches_jax(world):
    ref = jtrain.train_warping_net(jload_config(overrides=TRAIN_OVERRIDES),
                                   JArtifactStore(str(world["root"] / "j")), world["data3"],
                                   nb_file=3, data_parallel=True)
    (m0, p0), (m1, p1) = ((r["metrics"], r["params"]) for r in world["train"])
    assert sorted(m0) == sorted(ref)
    for k in ("epochs_run", "best_epoch", "steps_run", "minibatch_utterances"):
        assert m0[k] == m1[k] == ref[k], k
    assert m0["minibatch_utterances"] == 8
    for h_t, h_j in zip(m0["history"], ref["history"]):
        for k in ("train_loss", "test_loss", "test_l1_per_frame"):
            np.testing.assert_allclose(h_t[k], h_j[k], rtol=1e-3)
    assert m0["history"] == m1["history"]
    assert sorted(p0) == sorted(p1)
    for k in p0:
        np.testing.assert_array_equal(p0[k], p1[k])
