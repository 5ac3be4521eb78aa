"""The port's warping net (``exemplars_vc_tpu_torch/models/warping.py``) and
its training step against the JAX package's, on seeded padded batches.

Tolerances: the forward of JAX parameters carried over by
``warping_params_from_jax`` within 1e-5 of ``warping_forward_batch`` (float32
LSTM gates summed in another order); the masked L1-sum loss within 1e-5
relative; the gradients within 1e-5 of each tensor's largest; the parameters
after one RMSprop step within 1e-6 of the JAX package's ``_update`` with
``reference_rmsprop`` wherever the gradient stands above float32's
cancellation floor (|g| > 1e-4 · max |g| of its tensor). The first step is
lr · g / (√(0.01 g²) + 1e-8) ≈ ±0.05 for any gradient above ~1e-6, so a
gradient that is the rounding residue of cancelling L1 signs gets a step set
by its rounding (1 element of 400 on this batch, 9e-4 apart); and a second
trainable LSTM bias shows at once. Checkpoints cross both ways with the same
forward (1e-5).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.io.store import ArtifactStore as JArtifactStore
from exemplars_vc_tpu.models import train as jtrain
from exemplars_vc_tpu.models import warping as jwarp
from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.models import train as ttrain
from exemplars_vc_tpu_torch.models import warping as twarp

VARIANTS = {"unidirectional": dict(),
            "bidirectional": dict(bidirectional=True),
            "deep_head": dict(deep_head=True, fc_neurons=64)}


def padded_batch(seed: int, n: int = 3, t: int = 40, d: int = 20):
    """Seeded inputs and targets (n, t, d) whose rows past each length are
    zero, and the valid-frame mask (n, t)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(t // 2, t + 1, n)
    mask = (np.arange(t)[None, :] < lens[:, None]).astype(np.float32)
    x = rng.standard_normal((n, t, d)).astype(np.float32) * mask[..., None]
    y = rng.standard_normal((n, t, d)).astype(np.float32) * mask[..., None]
    return x, y, mask


def jax_params(kw: dict, seed: int = 0):
    cfg = jwarp.WarpingNetConfig(**kw)
    return cfg, jwarp.init_warping_params(jax.random.PRNGKey(seed), cfg)


def numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_matches_jax(variant):
    cfg, params = jax_params(VARIANTS[variant], seed=1)
    net = twarp.warping_params_from_jax(numpy_tree(params),
                                        twarp.WarpingNetConfig(**VARIANTS[variant]))
    x, _, _ = padded_batch(2)
    ref = np.asarray(jwarp.warping_forward_batch(params, jnp.asarray(x)))
    with torch.no_grad():
        got = net(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    # the flat leaf_i layout gives the same net; the leaves go back unchanged
    flat = {f"leaf_{i}": np.asarray(v) for i, v in enumerate(jax.tree_util.tree_leaves(params))}
    net2 = twarp.warping_params_from_jax(flat, net.cfg)
    assert all(torch.equal(a, b) for a, b in zip(net.state_dict().values(),
                                                 net2.state_dict().values()))
    for a, b in zip(twarp.warping_params_to_jax(net), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_config_and_init_distributions_match_jax():
    assert [f.name for f in dataclasses.fields(twarp.WarpingNetConfig)] == \
        [f.name for f in dataclasses.fields(jwarp.WarpingNetConfig)]
    assert twarp.WarpingNetConfig() == twarp.WarpingNetConfig(**dataclasses.asdict(
        jwarp.WarpingNetConfig()))
    for kw in VARIANTS.values():
        for seed in (0, 7):
            # the same key gives the same net: every leaf bit-equal
            cfg = twarp.WarpingNetConfig(**kw)
            net = twarp.init_warping_params(prng.PRNGKey(seed), cfg)
            _, params = jax_params(kw, seed)
            for got, ref in zip(twarp.warping_params_to_jax(net),
                                jax.tree_util.tree_leaves(params)):
                np.testing.assert_array_equal(got, np.asarray(ref))


def test_loss_and_one_rmsprop_step_match_jax():
    kw = VARIANTS["unidirectional"]
    _, params = jax_params(kw, seed=2)
    x, y, mask = padded_batch(5)
    lr, wd = 5e-3, 1e-4
    opt = jtrain.reference_rmsprop(lr, wd)
    p1, _, loss_j = jtrain._update(params, opt.init(params), jnp.asarray(x), jnp.asarray(y),
                                   jnp.asarray(mask), opt)
    net = twarp.warping_params_from_jax(numpy_tree(params), twarp.WarpingNetConfig(**kw))
    xt, yt, mt = (torch.as_tensor(a) for a in (x, y, mask))
    eval_j = float(jtrain._eval_loss(params, jnp.asarray(x), jnp.asarray(y), jnp.asarray(mask)))
    np.testing.assert_allclose(float(ttrain.eval_loss(net, xt, yt, mt)), eval_j, rtol=1e-5)
    topt = ttrain.reference_rmsprop(net, lr, wd)
    assert not any(p is q for g in topt.param_groups for p in g["params"]
                   for n, q in net.lstm.named_parameters() if n.startswith("bias_hh"))
    loss_t = ttrain.update_step(net, topt, xt, yt, mt)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)

    grads_j = jax.grad(lambda p: jnp.sum(jnp.abs(jwarp.warping_forward_batch(p, jnp.asarray(x))
                                                 - y) * mask[..., None]))(params)
    as_grads = copy.deepcopy(net)
    with torch.no_grad():
        for p, q in zip(as_grads.parameters(), net.parameters()):
            p.copy_(q.grad if q.grad is not None else torch.zeros_like(q))
    apart = 0
    for got, ref, g_t, g_j in zip(twarp.warping_params_to_jax(net), jax.tree_util.tree_leaves(p1),
                                  twarp.warping_params_to_jax(as_grads),
                                  jax.tree_util.tree_leaves(grads_j)):
        g_j = np.asarray(g_j)
        np.testing.assert_allclose(g_t, g_j, rtol=0, atol=1e-5 * np.abs(g_j).max())
        above = np.abs(g_j) > 1e-4 * np.abs(g_j).max()
        np.testing.assert_allclose(got[above], np.asarray(ref)[above], rtol=0, atol=1e-6)
        apart += int((np.abs(got - np.asarray(ref)) > 1e-6).sum())
    assert apart <= 4      # each below the floor (75 elements of 4,060 are; 1 parts)
    for name, p in net.lstm.named_parameters():
        if name.startswith("bias_hh"):
            assert not p.requires_grad and not p.any()


def test_a_trained_bias_hh_parts_from_jax():
    """The case the single-bias rule guards: with ``bias_hh`` trainable
    beside ``bias_ih`` both get the bias's gradient, and one RMSprop step
    moves their sum twice as far as the JAX trainer moves its bias."""
    kw = VARIANTS["unidirectional"]
    _, params = jax_params(kw, seed=2)
    x, y, mask = padded_batch(5)
    opt = jtrain.reference_rmsprop(5e-3, 1e-4)
    p1, _, _ = jtrain._update(params, opt.init(params), jnp.asarray(x), jnp.asarray(y),
                              jnp.asarray(mask), opt)
    net = twarp.warping_params_from_jax(numpy_tree(params), twarp.WarpingNetConfig(**kw))
    for name, p in net.lstm.named_parameters():
        p.requires_grad_(True)
    topt = torch.optim.RMSprop(net.parameters(), lr=5e-3, alpha=0.99, eps=1e-8,
                               weight_decay=1e-4)
    ttrain.update_step(net, topt, *(torch.as_tensor(a) for a in (x, y, mask)))
    b_ref = np.asarray(p1["lstm"][0]["fwd"]["b"]) - np.asarray(params["lstm"][0]["fwd"]["b"])
    b_got = twarp.warping_params_to_jax(net)[3] - np.asarray(params["lstm"][0]["fwd"]["b"])
    np.testing.assert_allclose(b_got, 2 * b_ref, rtol=1e-3, atol=1e-6)
    assert np.abs(b_got - b_ref).max() > 1e-3


def test_checkpoints_cross_both_ways(tmp_path):
    kw = VARIANTS["bidirectional"]
    jcfg, params = jax_params(kw, seed=3)
    tcfg = twarp.WarpingNetConfig(**kw)
    x, _, _ = padded_batch(6)
    ref = np.asarray(jwarp.warping_forward_batch(params, jnp.asarray(x)))
    jstore = JArtifactStore(str(tmp_path / "j"))
    jtrain.save_params(jstore, "ck", params)
    jstore.flush()
    net = ttrain.load_params(ArtifactStore(str(tmp_path / "j")), "ck", tcfg)
    with torch.no_grad():
        np.testing.assert_allclose(net(torch.as_tensor(x)).numpy(), ref, rtol=0, atol=1e-5)
    # the other way: the port's checkpoint loads in the JAX package
    tstore = ArtifactStore(str(tmp_path / "t"))
    ttrain.save_params(tstore, "ck", net)
    tstore.flush()
    assert tstore.load_json("ck_meta") == jstore.load_json("ck_meta")
    like = jwarp.init_warping_params(jax.random.PRNGKey(9), jcfg)
    back = jtrain.load_params(JArtifactStore(str(tmp_path / "t")), "ck", like)
    np.testing.assert_allclose(np.asarray(jwarp.warping_forward_batch(back, jnp.asarray(x))),
                               ref, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="orbax"):
        ttrain.save_params(tstore, "ck2", net, backend="orbax")
    with pytest.raises(ValueError, match="orbax"):
        ttrain.load_params(tstore, "ck", tcfg, backend="orbax")
