"""The program's spans (``exemplars_vc_tpu_torch/obs/profiling.py``): a named
``Timer`` is a span only while a ``torch.profiler`` records. Checked on the
CPU, on the synthetic corpus of ``torch_corpus``: nothing is recorded
without a profiler; ``Converter.convert`` (STFT and WORLD),
``StreamingConverter.push``, ``analyze`` and ``convert_utterance`` record
the spans their docstrings name, with their parent and root ids; the
``nmf`` spans' steps sum to the conversion's, and each names the loss it
solved (``beta``); the quality preset's ``h_smooth`` span sits in its
``solve``, and a dictionary's preparation records ``dict.augment``; the
exported Chrome trace
holds one ``user_annotation`` per span with the same names and nesting;
the audio is bit-equal with and without the profiler; threads keep their
own trees; the log keeps its bound. The device times are checked on the
card (``tests/test_torch_kernels_cuda.py``)."""

import glob
import json
import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from exemplars_vc_tpu_torch.config import load_config
from exemplars_vc_tpu_torch.dsp.stft import stft
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.io.wav import read_wav
from exemplars_vc_tpu_torch.obs import profiling
from exemplars_vc_tpu_torch.obs.profiling import SpanLog, Timer, cursor, spans, trace_to
from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance
from exemplars_vc_tpu_torch.pipelines.serve import Converter
from exemplars_vc_tpu_torch.pipelines.stream import StreamingConverter
from exemplars_vc_tpu_torch.world.analysis import analyze
from torch_corpus import OVERRIDES, write_synthetic_corpus

KINDS = {"stft": OVERRIDES, "world": OVERRIDES + ["data.use_stft=false"]}
SYNTH_ITERS = 3
CHUNK = 16


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_synthetic_corpus(tmp_path_factory.mktemp("synthetic_corpus"))


@pytest.fixture(scope="module")
def converters(corpus, tmp_path_factory):
    """{kind: Converter}, prepared on first use."""
    store = ArtifactStore(str(tmp_path_factory.mktemp("store")))
    made = {}

    def get(kind):
        if kind not in made:
            made[kind] = Converter(load_config(overrides=KINDS[kind]), store, corpus[0],
                                   nb_file=3, device="cpu")
        return made[kind]
    return get


def _chunks(corpus):
    """The held-out source's magnitude and complex STFT in 16-frame chunks."""
    x, _ = read_wav(corpus[1])
    S = stft(torch.as_tensor(x), n_fft=400, hop_length=80)
    n = S.shape[0] // CHUNK * CHUNK
    return [(torch.abs(S[k: k + CHUNK]), S[k: k + CHUNK]) for k in range(0, n, CHUNK)][:3]


def _call(kind, converters, corpus):
    """The call of one case: its audio (one array)."""
    if kind == "stream":
        A, B = converters("stft").dicts["stft"]
        sc = StreamingConverter(load_config(overrides=OVERRIDES), A, B, context_frames=32,
                                synth_iters=SYNTH_ITERS, device="cpu")
        return np.concatenate([sc.push(*c) for c in _chunks(corpus)])
    return converters(kind).convert(corpus[1], synth_iters=SYNTH_ITERS)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        before = cursor()
        out = fn()
        after = cursor()
    return out, spans(before, after)


def _children(recs, parent):
    return sorted((s for s in recs if s["parent"] == parent["id"]), key=lambda s: s["start_ns"])


@pytest.mark.parametrize("kind", ["stft", "world", "stream"])
def test_nothing_is_recorded_without_a_profiler(kind, converters, corpus):
    before = cursor()
    _call(kind, converters, corpus)
    with Timer("cpu", name="convert", residual=False) as t:
        pass
    assert cursor() == before and t.elapsed >= 0.0 and t._span is None


@pytest.mark.parametrize("kind", ["stft", "world"])
def test_conversion_records_its_spans(kind, converters, corpus):
    conv = converters(kind)
    out, recs = _traced(lambda: conv.convert(corpus[1], synth_iters=SYNTH_ITERS))
    roots = [s for s in recs if s["parent"] is None]
    assert [r["name"] for r in roots] == ["convert"]
    root = roots[0]
    assert recs[-1]["id"] == root["id"]                 # a child closes before its root
    assert all(s["root"] == root["id"] for s in recs)
    assert all(s["device_ms"] is None for s in recs)     # off the card
    stages = _children(recs, root)
    assert [s["name"] for s in stages] == ["features", "solve", "synthesis"]
    features, solve, synthesis = stages
    assert solve["attrs"] == {"residual": kind == "world"}
    assert all(s["host_ms"] <= root["host_ms"] for s in stages)
    nmf = [s for s in recs if s["name"] == "nmf"]
    assert nmf and all(s["parent"] == solve["id"] for s in nmf)
    assert sum(s["attrs"]["n_iter"] for s in nmf) == out.nmf_iters
    dicts = conv.dicts["stft"] if kind == "stft" else conv.dicts["sp"]
    assert {s["attrs"]["K"] for s in nmf} == {dicts[0].shape[0]}
    assert {s["attrs"]["D"] for s in nmf} == {dicts[0].shape[1]}
    world = [s["name"] for s in _children(recs, features)]
    assert world == (["world.f0", "world.cheaptrick", "world.d4c"] if kind == "world" else [])
    assert len(nmf) == (2 if kind == "world" else 1)
    assert _children(recs, synthesis) == []


def test_push_records_its_spans(converters, corpus):
    pushes, recs = _traced(lambda: _call("stream", converters, corpus))
    roots = [s for s in recs if s["parent"] is None]
    assert [r["name"] for r in roots] == ["push"] * 3
    for root in roots:
        solve, synth = _children(recs, root)
        assert (solve["name"], synth["name"]) == ("solve", "synthesis")
        (nmf,) = _children(recs, solve)
        assert nmf["name"] == "nmf" and nmf["root"] == root["id"]
        assert nmf["attrs"]["F"] == CHUNK and 1 <= nmf["attrs"]["n_iter"] <= 20
        assert not _children(recs, synth)
    assert len(recs) == 4 * len(roots)


@pytest.mark.parametrize("over,beta", [([], "frobenius"),
                                       (["nmf.beta_loss=kullback-leibler"], "kl"),
                                       (["nmf.beta_loss=kullback-leibler", "nmf.solver=cd"],
                                        "frobenius")], ids=["frobenius", "kl", "kl-asked-of-cd"])
def test_nmf_span_names_the_loss_it_solved(over, beta, corpus, tmp_path):
    conv = Converter(load_config(overrides=OVERRIDES + over), ArtifactStore(str(tmp_path)),
                     corpus[0], nb_file=3, device="cpu")
    _, recs = _traced(lambda: conv.convert(corpus[1], synth_iters=SYNTH_ITERS))
    (nmf,) = [s for s in recs if s["name"] == "nmf"]
    assert nmf["attrs"]["beta"] == beta
    assert set(nmf["attrs"]) == {"F", "K", "D", "n_iter", "beta"}


def test_quality_preset_records_h_smooth_under_solve(corpus, tmp_path):
    conv = Converter(load_config(preset="quality", overrides=OVERRIDES),
                     ArtifactStore(str(tmp_path)), corpus[0], nb_file=3, device="cpu")
    _, recs = _traced(lambda: conv.convert(corpus[1], synth_iters=SYNTH_ITERS))
    (solve,) = [s for s in recs if s["name"] == "solve"]
    nmf, smooth = _children(recs, solve)
    assert (nmf["name"], smooth["name"]) == ("nmf", "h_smooth")
    assert nmf["attrs"]["beta"] == "kl"
    assert smooth["attrs"] == {"F": nmf["attrs"]["F"], "K": nmf["attrs"]["K"], "s": 2}
    assert smooth["root"] == solve["root"] and not _children(recs, smooth)


def test_preparation_records_dict_augment(corpus, tmp_path):
    cfg = load_config(overrides=OVERRIDES + ["data.dict_augment_warps=0.9,1.1"])
    conv, recs = _traced(lambda: Converter(cfg, ArtifactStore(str(tmp_path)), corpus[0],
                                           nb_file=3, device="cpu"))
    (aug,) = [s for s in recs if s["name"] == "dict.augment"]
    assert aug["parent"] is None
    assert aug["attrs"] == {"K": conv.dicts["stft"][0].shape[0], "warps": (0.9, 1.1)}
    assert conv.dicts["stft"][0].shape[0] % (3 * 512) == 0


def test_analyze_records_its_three_spans(corpus):
    x, _ = read_wav(corpus[1])
    _, recs = _traced(lambda: analyze(torch.as_tensor(x), f0_floor=71.0, f0_method="dio"))
    assert [s["name"] for s in recs] == ["world.f0", "world.cheaptrick", "world.d4c"]
    assert all(s["parent"] is None and s["root"] == s["id"] for s in recs)


def test_convert_utterance_stages_carry_the_span_names(corpus, tmp_path):
    cfg = load_config(overrides=KINDS["stft"])
    store = ArtifactStore(str(tmp_path))
    res, recs = _traced(lambda: convert_utterance(cfg, store, corpus[0], corpus[1], nb_file=3,
                                                  synth_iters=SYNTH_ITERS, device="cpu"))
    roots = [s["name"] for s in recs if s["parent"] is None]
    assert roots == ["features", "solve", "synthesis"]
    assert set(res.timings) == {"dicts", "features", "nmf_solve", "synthesis"}


@pytest.mark.parametrize("kind", ["stft", "world", "stream"])
def test_chrome_trace_holds_every_span(kind, converters, corpus, tmp_path):
    converters("stft")                        # prepared outside the trace
    if kind != "stream":
        converters(kind)
    with trace_to(str(tmp_path)):
        before = cursor()
        _call(kind, converters, corpus)
        after = cursor()
    recs = sorted(spans(before, after), key=lambda s: s["start_ns"])
    (path,) = glob.glob(str(tmp_path / "*.pt.trace.json"))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    ann = sorted((e for e in events if e.get("cat") == "user_annotation" and e.get("ph") == "X"),
                 key=lambda e: float(e["ts"]))
    assert [e["name"] for e in ann] == [s["name"] for s in recs]
    by_id = {s["id"]: e for s, e in zip(recs, ann)}
    for s in recs:
        if s["parent"] is not None:
            e, p = by_id[s["id"]], by_id[s["parent"]]
            assert float(p["ts"]) <= float(e["ts"])
            assert float(e["ts"]) + float(e["dur"]) <= float(p["ts"]) + float(p["dur"])


@pytest.mark.parametrize("kind", ["stft", "world", "stream"])
def test_audio_is_bit_equal_with_and_without_the_profiler(kind, converters, corpus):
    plain = _call(kind, converters, corpus)
    traced, recs = _traced(lambda: _call(kind, converters, corpus))
    assert recs
    if kind != "stream":
        assert plain.nmf_iters == traced.nmf_iters
        plain, traced = plain.audio, traced.audio
    np.testing.assert_array_equal(plain, traced)


def test_threads_keep_their_own_trees(monkeypatch):
    """Eight threads open nested spans at once (the profiler's switch held
    on for them, with a short switch interval): every span's parent and
    root are its own thread's."""
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    before = cursor()
    errors = []

    def work(k):
        try:
            for _ in range(50):
                with Timer("cpu", name=f"root{k}"):
                    with Timer("cpu", name=f"child{k}"):
                        with Timer("cpu", name=f"leaf{k}"):
                            pass
        except Exception as e:          # reported by the main thread
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not errors and not any(t.is_alive() for t in threads)
    recs = spans(before, cursor())
    assert len(recs) == 8 * 50 * 3
    by_id = {s["id"]: s for s in recs}
    for s in recs:
        k = s["name"][-1]
        assert by_id[s["root"]]["name"] == f"root{k}"
        if s["parent"] is not None:
            assert by_id[s["parent"]]["name"][-1] == k


def test_the_log_keeps_its_bound(monkeypatch):
    monkeypatch.setattr(profiling, "_log", SpanLog(kept=4))
    with profile(activities=[ProfilerActivity.CPU]):
        for k in range(10):
            with Timer("cpu", name=f"s{k}", k=k):
                pass
    assert cursor() == 10 and len(profiling._log.records) == 4
    assert [s["name"] for s in spans()] == ["s6", "s7", "s8", "s9"]
    assert [s["attrs"]["k"] for s in spans(8, 10)] == [8, 9]
    assert spans(0, 5) == [] and spans(7, 8)[0]["name"] == "s7"
