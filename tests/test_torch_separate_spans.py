"""The separation's spans and counter (``separate/multichannel.py``), beside
the conversion's in ``tests/test_torch_spans.py``: under a profiler one
``separate_signal`` records ``separate`` over ``separate.stft``,
``separate.em`` and ``separate.images``, the fit one ``separate.estep`` and
one ``separate.nmf`` an EM iteration, each with the attributes its
docstring names; ``separate_signal.em_iters`` advances by n_em a fit, with
a profiler or without; without one nothing is recorded; the images are
bit-equal either way. On the CPU: no device times."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu_torch.io.standin import speech_mixture
from exemplars_vc_tpu_torch.obs.profiling import cursor, spans
from exemplars_vc_tpu_torch.prng import PRNGKey
from exemplars_vc_tpu_torch.separate import separate_signal

N_EM = 3


@pytest.fixture(scope="module")
def mixture():
    x, _, _ = speech_mixture(seconds=1.0)
    return x


def _separate(x, spectral_model="nmf"):
    return separate_signal(x, n_sources=2, n_components=4, n_em=N_EM, n_fft=400, hop_length=80,
                           key=PRNGKey(0), spectral_model=spectral_model, device="cpu")


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        before = cursor()
        out = fn()
        after = cursor()
    return out, spans(before, after)


def _children(recs, parent):
    return sorted((s for s in recs if s["parent"] == parent["id"]), key=lambda s: s["start_ns"])


@pytest.mark.parametrize("spectral_model", ["nmf", "hmm"])
def test_separation_records_its_spans(mixture, spectral_model):
    (images, model), recs = _traced(lambda: _separate(mixture, spectral_model))
    roots = [s for s in recs if s["parent"] is None]
    assert [r["name"] for r in roots] == ["separate"]
    root = roots[0]
    assert recs[-1]["id"] == root["id"] and all(s["root"] == root["id"] for s in recs)
    assert all(s["device_ms"] is None for s in recs)     # off the card
    assert root["attrs"] == {"C": 2, "T": mixture.shape[-1], "J": 2, "K": 4, "n_em": N_EM,
                             "spectral_model": spectral_model}
    stages = _children(recs, root)
    assert [s["name"] for s in stages] == ["separate.stft", "separate.em", "separate.images"]
    stft, em, _ = stages
    assert stft["attrs"] == {} and all(s["host_ms"] <= root["host_ms"] for s in stages)
    F, N = model.W.shape[1], model.H.shape[-1]
    assert (F, N) == (201, 1 + mixture.shape[-1] // 80)
    hmm = spectral_model == "hmm"
    assert em["attrs"] == {"F": F, "N": N, "C": 2, "J": 2, "K": 4, "n_em": N_EM,
                           "n_inner": 0 if hmm else 1}
    steps = [s["name"] for s in _children(recs, em)]
    assert steps == (["separate.estep"] * N_EM if hmm
                     else ["separate.estep", "separate.nmf"] * N_EM)
    assert all(s["attrs"] == {} for s in _children(recs, em))


@pytest.mark.parametrize("spectral_model", ["nmf", "hmm"])
def test_em_iters_counts_every_fit(mixture, spectral_model):
    before = separate_signal.em_iters
    _separate(mixture, spectral_model)
    assert separate_signal.em_iters == before + N_EM
    _traced(lambda: _separate(mixture, spectral_model))
    assert separate_signal.em_iters == before + 2 * N_EM


def test_nothing_is_recorded_without_a_profiler_and_the_images_are_unchanged(mixture):
    before = cursor()
    images, model = _separate(mixture)
    assert cursor() == before
    (traced, traced_model), recs = _traced(lambda: _separate(mixture))
    assert recs and torch.equal(images, traced)
    assert torch.equal(model.neg_log_like, traced_model.neg_log_like)
