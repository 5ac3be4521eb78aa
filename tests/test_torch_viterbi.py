"""The port's Viterbi tracker (``exemplars_vc_tpu_torch/align/viterbi.py``)
against the pyfasst oracle of ``tests/test_viterbi.py`` and against the JAX
package's ``viterbi_track`` on the same numpy inputs, on the CPU. Paths are
integers: every comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.align.viterbi import viterbi_track as jax_viterbi
from exemplars_vc_tpu_torch.align.viterbi import (
    viterbi_paths,
    viterbi_track,
    viterbi_track_batch,
)
from test_viterbi import ref_viterbi


def _int_logs(rng, S, N, lead=()):
    """Integer-valued logs: sums stay exact in float32, so argmax ties are
    real ties and first-index tie-breaking is what the comparison sees."""
    return (rng.integers(-6, 6, lead + (S, N)).astype(np.float32),
            rng.integers(-6, 6, S).astype(np.float32),
            rng.integers(-6, 6, (S, S)).astype(np.float32))


def test_matches_pyfasst_semantics():
    rng = np.random.default_rng(0)
    for _ in range(4):
        S, N = int(rng.integers(3, 12)), int(rng.integers(5, 40))
        ld, lp, lt = _int_logs(rng, S, N)
        got = viterbi_track(ld, lp, lt, device="cpu").numpy()
        np.testing.assert_array_equal(got, ref_viterbi(ld, lp, lt))


def test_batched():
    rng = np.random.default_rng(1)
    ld, lp, lt = _int_logs(rng, 6, 25, lead=(3,))
    got = viterbi_track_batch(ld, lp, lt, device="cpu").numpy()
    for b in range(3):
        np.testing.assert_array_equal(got[b], ref_viterbi(ld[b], lp, lt))


def test_strong_diagonal_stays():
    S, N = 5, 30
    ld = np.zeros((S, N))
    lp = np.array([0.0, 5.0, 0.0, 0.0, 0.0])
    lt = np.full((S, S), -100.0)
    np.fill_diagonal(lt, 0.0)
    assert (viterbi_track(ld, lp, lt, device="cpu").numpy() == 1).all()


@pytest.mark.parametrize("seed", range(4))
def test_paths_equal_jax_on_random_densities(seed):
    rng = np.random.default_rng(10 + seed)
    S, N = int(rng.integers(2, 16)), int(rng.integers(1, 300))
    ld = rng.standard_normal((S, N)).astype(np.float32) * 3
    lp = np.log(rng.dirichlet(np.ones(S))).astype(np.float32)
    lt = np.log(rng.dirichlet(np.ones(S), size=S)).astype(np.float32)
    ref = np.asarray(jax_viterbi(jnp.asarray(ld), jnp.asarray(lp), jnp.asarray(lt)))
    np.testing.assert_array_equal(viterbi_track(ld, lp, lt, device="cpu").numpy(), ref)


def test_ties_go_to_the_first_index_as_in_jax():
    rng = np.random.default_rng(20)
    ties = 0
    for _ in range(20):
        S, N = int(rng.integers(2, 8)), int(rng.integers(2, 50))
        ld, lp, lt = _int_logs(rng, S, N)
        ref = np.asarray(jax_viterbi(jnp.asarray(ld), jnp.asarray(lp), jnp.asarray(lt)))
        np.testing.assert_array_equal(viterbi_track(ld, lp, lt, device="cpu").numpy(), ref)
        scores = ld[:, :1] + lp[:, None] + lt      # the first step's scores
        ties += int((scores == scores.max(axis=0)).sum(axis=0).max() > 1)
    assert ties > 0   # the inputs do tie


def test_batch_with_a_transition_a_sequence_equals_jax():
    """The internal sweep takes one transition matrix a sequence (as the HMM
    separation decodes every source with its own): each row equals the JAX
    tracker run alone with that matrix."""
    rng = np.random.default_rng(30)
    B, S, N = 3, 5, 80
    ld = rng.standard_normal((B, S, N)).astype(np.float32)
    lp = np.log(rng.dirichlet(np.ones(S), size=B)).astype(np.float32)
    lt = np.log(rng.dirichlet(np.ones(S), size=(B, S))).astype(np.float32)
    got = viterbi_paths(torch.from_numpy(ld), torch.from_numpy(lp), torch.from_numpy(lt))
    assert got.shape == (B, N)
    for b in range(B):
        ref = np.asarray(jax_viterbi(jnp.asarray(ld[b]), jnp.asarray(lp[b]),
                                     jnp.asarray(lt[b])))
        np.testing.assert_array_equal(got[b].numpy(), ref)


@pytest.mark.parametrize("fn", [viterbi_track, viterbi_track_batch])
def test_defaults_to_the_card(fn):
    import inspect

    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fn(np.zeros((1, 2, 3)), np.zeros(2), np.zeros((2, 2)))
