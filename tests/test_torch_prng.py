"""The port's counterpart of ``jax.random`` (``exemplars_vc_tpu_torch/prng.py``)
against ``jax.random`` on the CPU (JAX 0.9: threefry2x32, partitionable,
64-bit types off), and against the draws ``tools/jax_prng_golden.py`` and
``tools/jax_simm_draws.py`` recorded, which need no JAX.

Tolerances: keys, splits, bits, ``uniform`` and ``randint`` bit-equal;
``normal`` within 4 ulp of JAX's, and bit-equal on at least 90 % of a large
draw (measured: 3 ulp at most, 99.1 % bit-equal over 10⁶ draws; the rest is
``log1p``, which XLA's CPU code rounds otherwise than torch's).

The cases that compare with ``jax.random`` import JAX (and ``hypothesis``)
inside the test, so on a machine without them the file still runs its
golden-file cases:

    python -m pytest --noconftest tests/test_torch_prng.py -q
"""

import numpy as np
import pytest
import torch

from exemplars_vc_tpu_torch import prng

SEEDS = (0, 1, 42, 2 ** 31 - 1)
# the golden file's shapes (tools/jax_prng_golden.py SHAPES)
SHAPES = {"scalar": (), "odd": (7,), "empty": (0,), "jfk": (2, 201, 8)}
WARP_BOUND = float(np.float32(1.0) / np.sqrt(np.float32(20)))


def ulp_apart(a, b) -> np.ndarray:
    """|a − b| in float32 ulp (both finite and of one sign)."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.fixture
def jr():
    return pytest.importorskip("jax").random


def tkey(jax_key) -> torch.Tensor:
    return torch.as_tensor(np.asarray(jax_key).astype(np.int64))


def draws(key: torch.Tensor, shape) -> dict:
    """Every sampler of ``prng`` at ``shape``, as numpy, keyed as the golden
    file's entries."""
    out = {"bits": prng._random_bits(key, shape).to(torch.int64),
           "uniform": prng.uniform(key, shape),
           "uniformb": prng.uniform(key, shape, minval=-WARP_BOUND, maxval=WARP_BOUND),
           "normal": prng.normal(key, shape),
           "randint": prng.randint(key, shape, 0, 8)}
    out = {n: a.cpu().numpy() for n, a in out.items()}
    out["bits"] = out["bits"].astype(np.uint32)
    return out


def jax_draws(jr, key, shape) -> dict:
    return {"bits": np.asarray(jr.bits(key, shape)),
            "uniform": np.asarray(jr.uniform(key, shape)),
            "uniformb": np.asarray(jr.uniform(key, shape, minval=-WARP_BOUND,
                                              maxval=WARP_BOUND)),
            "normal": np.asarray(jr.normal(key, shape)),
            "randint": np.asarray(jr.randint(key, shape, 0, 8))}


def assert_same_draws(got: dict, want: dict, normal_share: float | None = None):
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        if name == "normal":
            if w.size:
                ulp = ulp_apart(g, w)
                assert ulp.max() <= 4, (name, int(ulp.max()))
                if normal_share is not None:
                    assert (ulp == 0).mean() >= normal_share
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_and_splits_match_jax(jr, seed):
    k = jr.PRNGKey(seed)
    assert torch.equal(prng.PRNGKey(seed), tkey(k))
    for num in (2, 3, 6):
        assert torch.equal(prng.split(prng.PRNGKey(seed), num), tkey(jr.split(k, num)))
    # a split key carries across: split of a split, as the sites nest them
    k1 = jr.split(k)[1]
    assert torch.equal(prng.split(tkey(k1), 5), tkey(jr.split(k1, 5)))


@pytest.mark.parametrize("shape", list(SHAPES.values()), ids=list(SHAPES))
@pytest.mark.parametrize("seed", SEEDS)
def test_samplers_match_jax(jr, seed, shape):
    k = jr.PRNGKey(seed)
    assert_same_draws(draws(tkey(k), shape), jax_draws(jr, k, shape),
                      normal_share=0.9 if np.prod(shape) >= 1000 else None)


def test_randint_spans_and_normal_share_of_a_large_draw(jr):
    """randint at spans that wrap JAX's uint32 arithmetic (above 2¹⁶, the
    whole int32 range, an empty range); the normals of 10⁵ draws."""
    k = jr.PRNGKey(3)
    for lo, hi in ((0, 1), (0, 70_000), (-5, 2 ** 31 - 1), (-2 ** 31, 2 ** 31 - 1), (4, 4),
                   (9, 2)):
        np.testing.assert_array_equal(prng.randint(tkey(k), (257,), lo, hi).numpy(),
                                      np.asarray(jr.randint(k, (257,), lo, hi)),
                                      err_msg=str((lo, hi)))
    ulp = ulp_apart(prng.normal(tkey(k), (100_000,)).numpy(), jr.normal(k, (100_000,)))
    assert ulp.max() <= 4 and (ulp == 0).mean() >= 0.9


def test_any_seed_and_shape_matches_jax():
    """A ``hypothesis`` search over seeds and shapes (imported here, as JAX
    is, so that the golden-file cases need neither)."""
    hyp = pytest.importorskip("hypothesis")
    st = pytest.importorskip("hypothesis.strategies")
    jr = pytest.importorskip("jax").random

    @hyp.settings(max_examples=25, deadline=None, database=None)
    @hyp.given(seed=st.integers(min_value=-2 ** 31, max_value=2 ** 31 - 1),
               shape=st.lists(st.integers(min_value=0, max_value=9), min_size=0, max_size=3))
    def case(seed, shape):
        k = jr.PRNGKey(seed)
        assert torch.equal(prng.PRNGKey(seed), tkey(k))
        assert_same_draws(draws(tkey(k), tuple(shape)), jax_draws(jr, k, tuple(shape)))

    case()


def test_key_checks_and_dtypes():
    k = prng.PRNGKey(0)
    with pytest.raises(TypeError, match="shape \\(2,\\)"):
        prng.normal(prng.split(k, 3), (2,))
    with pytest.raises(TypeError, match="float32"):
        prng.uniform(k, (2,), torch.float64)
    with pytest.raises(ValueError, match="int32"):
        prng.randint(k, (2,), 0, 2 ** 31)
    assert prng.randint(k, (3,), 0, 5).dtype == torch.int32
    assert prng.normal(k).shape == () and prng.uniform(k, (0, 4)).shape == (0, 4)


def test_draws_are_a_prefix_of_longer_draws():
    """An element's bits depend on its index only (the partitionable
    counter), so a draw of n is the first n of a longer one: the WORLD
    noise check reads a prefix of the golden noise."""
    k = prng.PRNGKey(0)
    long = prng.normal(k, (1000,))
    assert torch.equal(prng.normal(k, (377,)), long[:377])
    assert torch.equal(prng.normal(k, (10, 100)).reshape(-1), long)


def golden_checks(device: str) -> None:
    """The port on ``device`` against ``jax_prng_golden.npz`` and
    ``jax_simm_draws_key1.npz``, without JAX."""
    from exemplars_vc_tpu_torch.io.standin import jax_prng_golden, jax_simm_draws
    from exemplars_vc_tpu_torch.models.warping import (
        WarpingNetConfig,
        init_warping_params,
        warping_params_to_jax,
    )
    from exemplars_vc_tpu_torch.parallel.sharded_separate import batch_inits
    from exemplars_vc_tpu_torch.separate.isnmf import _init
    from exemplars_vc_tpu_torch.separate.multichannel import random_spatial_init
    from exemplars_vc_tpu_torch.separate.stereo_simm import simm_draws

    def key(seed):
        return prng.PRNGKey(seed).to(device)

    g = jax_prng_golden()
    assert str(g["jax_version"]).startswith("0.9")
    for s in SEEDS:
        assert np.array_equal(key(s).cpu().numpy(), g[f"key_{s}"].astype(np.int64))
        for n in (2, 6):
            assert np.array_equal(prng.split(key(s), n).cpu().numpy(),
                                  g[f"split{n}_{s}"].astype(np.int64))
        for name, shape in SHAPES.items():
            got = draws(key(s), shape)
            assert_same_draws(got, {n: g[f"{n}_{s}_{name}"] for n in got},
                              normal_share=0.9 if name == "jfk" else None)

    def close(got, name):
        """A raw normal draw within 4 ulp; a quantity made of such draws
        (g², (1 + g)², aaᴴ/‖a‖²) within 1e-6 of its largest entry, since
        (1 + g)² near g = −1 turns a few ulp of g into many of the result."""
        want = g[name]
        got = got.cpu().numpy()
        assert got.shape == want.shape, name
        if name in ("hmm_a_re", "world_noise"):
            assert ulp_apart(got, want).max() <= 4, name
        else:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max(),
                                       err_msg=name)

    J, K, F, N, C = 2, 8, 201, 401, 2
    kw, kh, kr = prng.split(key(0), 3)
    close(prng.normal(kw, (J, F, K)) ** 2, "separate_W")
    close(prng.normal(kh, (J, K, N)) ** 2, "separate_H")
    close(random_spatial_init(kr, J, F, C, device=device), "separate_R")
    kw, kr, kp = prng.split(key(0), 3)
    close(prng.normal(kw, (J, F, K)) ** 2, "hmm_W")
    assert np.array_equal(prng.randint(kp, (J, N), 0, K).cpu().numpy(), g["hmm_paths"])
    close(prng.normal(kr, (J, C)), "hmm_a_re")
    ks = prng.split(key(1), 6)
    for name, k, shape, sq in (("lead_H", ks[1], (145, 126), True),
                               ("lead_HF", ks[3], (20, 126), True),
                               ("lead_WR", ks[4], (513, 20), False),
                               ("lead_HR", ks[5], (20, 126), False)):
        close(_init(k, shape, None, device, squared=sq), name)
    for got, name in zip(batch_inits(key(0), 2, J, F, K, N, C), ("batch_W", "batch_H", "batch_R")):
        close(got, name)
    net = init_warping_params(key(0), WarpingNetConfig())
    for i, leaf in enumerate(warping_params_to_jax(net)):
        assert np.array_equal(leaf, g[f"warp_leaf_{i}"]), i
    close(prng.normal(key(0), (len(g["world_noise"]),)), "world_noise")
    # the stereo SIMM's rounds from PRNGKey(1) (tools/jax_simm_draws.py)
    for got, want in zip((simm_draws(k, 513, 126, 145, 20, 4, 20)
                          for k in prng.split(key(1))), jax_simm_draws()):
        assert set(got) == set(want)
        for name, w in want.items():
            a = got[name].cpu().numpy()
            if name == "beta_init":
                np.testing.assert_array_equal(a, w, err_msg=name)
            else:
                assert ulp_apart(a, w).max() <= 4, name


def test_golden_draws_reproduced_without_jax():
    golden_checks("cpu")


@pytest.mark.cuda
def test_golden_draws_reproduced_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: checks the draws on the card")
    golden_checks("cuda")
