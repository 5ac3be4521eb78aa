"""The eleven readers of the program's spans (``benchmark/harness/spans.py``)
on hand-made span lists: the values by hand, None where their spans are
absent, off the card (no device times) and on a program that keeps no
spans; and on the spans a real conversion and a real push record on the
CPU, given device times."""

import numpy as np
import pytest
import torch

from benchmark.harness.roofline import least_seconds, solve_work
from benchmark.harness.spec import load_reader
from exemplars_vc_tpu_torch.obs import profiling

NAMES = ["convert.features_ms", "convert.solve_ms", "convert.synthesis_ms",
         "convert.solve_roofline_pct", "world.f0_ms", "world.cheaptrick_ms", "world.d4c_ms",
         "synthesis.capture_ms", "push.solve_ms", "push.synthesis_ms", "push.mu_steps"]


class _Tree:
    """Builds span records as ``obs.profiling.spans`` returns them."""

    def __init__(self):
        self.recs, self.next = [], 1

    def add(self, name, parent=None, device_ms=1.0, host_ms=1.0, **attrs):
        sid, self.next = self.next, self.next + 1
        root = sid if parent is None else parent["root"]
        rec = {"name": name, "id": sid, "parent": None if parent is None else parent["id"],
               "root": root, "attrs": attrs, "start_ns": 0, "end_ns": 0, "host_ms": host_ms,
               "device_ms": device_ms}
        self.recs.append(rec)
        return rec


def _serve(world: bool, device: bool = True):
    """Two requests: features 2 and 4 ms, solve 10 and 30, synthesis 6 and 8
    (device); on WORLD the analysis under features (f0 0.5/1.5, CheapTrick
    1/2, D4C 0.25/0.75) and two nmf spans a solve; one capture span
    (host 12 ms) and a miss (host 3 ms) in the second request's synthesis."""
    t = _Tree()
    d = (lambda v: v) if device else (lambda v: None)
    for k, (fe, so, sy) in enumerate([(2.0, 10.0, 6.0), (4.0, 30.0, 8.0)]):
        root = t.add("convert", device_ms=d(60.0))
        f = t.add("features", root, device_ms=d(fe))
        if world:
            t.add("world.f0", f, device_ms=d([0.5, 1.5][k]))
            t.add("world.cheaptrick", f, device_ms=d([1.0, 2.0][k]))
            t.add("world.d4c", f, device_ms=d([0.25, 0.75][k]))
        s = t.add("solve", root, device_ms=d(so), residual=world)
        for name in (("sp", "ap") if world else ("stft",)):
            t.add("nmf", s, device_ms=d(so / 2), F=100 * (k + 1), K=1024,
                  D=1025 if world else 201, n_iter=50 + 10 * k)
        sy_span = t.add("synthesis", root, device_ms=d(sy))
        if k == 1 and not world:
            t.add("griffin_lim.capture", sy_span, host_ms=3.0)
            t.add("griffin_lim.capture", sy_span, host_ms=12.0)
    return t.recs


def _stream(device: bool = True):
    """Three pushes: solve 4, 5, 6 ms with 10, 20, 60 steps, synthesis 9 ms."""
    t = _Tree()
    d = (lambda v: v) if device else (lambda v: None)
    for so, steps in ((4.0, 10), (5.0, 20), (6.0, 60)):
        root = t.add("push", device_ms=d(20.0))
        s = t.add("solve", root, device_ms=d(so))
        t.add("nmf", s, device_ms=d(so - 1), F=16, K=1024, D=201, n_iter=steps)
        t.add("synthesis", root, device_ms=d(9.0))
    return t.recs


def _read(name, recs, monkeypatch, calls=2):
    monkeypatch.setattr(profiling, "spans", lambda since=0, until=None: recs)
    reader = load_reader(name)
    return reader.read({"snapshot": (reader.snapshot(), reader.snapshot()), "calls": calls})


def _roofline(world):
    least = 0.0
    for k in range(2):
        for _ in range(2 if world else 1):
            least += least_seconds(*solve_work(100 * (k + 1), 1024, 1025 if world else 201,
                                               50 + 10 * k, world))
    return 100.0 * least / 40e-3


SERVE = {"convert.features_ms": 3.0, "convert.solve_ms": 20.0, "convert.synthesis_ms": 7.0}
WORLD = {"world.f0_ms": 1.0, "world.cheaptrick_ms": 1.5, "world.d4c_ms": 0.5}


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_by_hand(name, monkeypatch):
    stft, world, stream = _serve(False), _serve(True), _stream()
    want = {
        "stft": dict(SERVE, **{"convert.solve_roofline_pct": _roofline(False),
                               "synthesis.capture_ms": 7.5}),
        "world": dict(SERVE, **WORLD, **{"convert.solve_roofline_pct": _roofline(True),
                                          "synthesis.capture_ms": 0.0}),
        "stream": {"push.solve_ms": 5.0, "push.synthesis_ms": 9.0, "push.mu_steps": 30.0,
                   "synthesis.capture_ms": 0.0},
    }
    for kind, recs in (("stft", stft), ("world", world), ("stream", stream)):
        got = _read(name, recs, monkeypatch, calls=3 if kind == "stream" else 2)
        if name in want[kind]:
            assert got == pytest.approx(want[kind][name], rel=1e-12), kind
        else:
            assert got is None, kind


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_gives_none_without_its_spans(name, monkeypatch):
    assert _read(name, [], monkeypatch) is None
    assert _read(name, _serve(True, device=False), monkeypatch) is None      # off the card
    assert _read(name, _stream(device=False), monkeypatch) is None
    monkeypatch.delattr(profiling, "cursor")                                # no spans kept
    reader = load_reader(name)
    assert reader.snapshot() is None
    assert reader.read({"snapshot": (None, None), "calls": 2}) is None
    assert reader.read({"calls": 2}) is None


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """The spans of one STFT request, one WORLD request and two pushes on
    the CPU, each span given its host time as its device time."""
    import sys
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "tests"))
    from torch_corpus import OVERRIDES, write_synthetic_corpus

    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.dsp.stft import stft
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.io.wav import read_wav
    from exemplars_vc_tpu_torch.pipelines.serve import Converter
    from exemplars_vc_tpu_torch.pipelines.stream import StreamingConverter

    data, src, _ = write_synthetic_corpus(tmp_path_factory.mktemp("corpus"))
    store = ArtifactStore(str(tmp_path_factory.mktemp("store")))
    out = {}
    for kind, over in (("stft", OVERRIDES), ("world", OVERRIDES + ["data.use_stft=false"])):
        conv = Converter(load_config(overrides=over), store, data, nb_file=3, device="cpu")
        with profile(activities=[ProfilerActivity.CPU]):
            before = profiling.cursor()
            out[kind + "_iters"] = conv.convert(src, synth_iters=2).nmf_iters
            out[kind] = profiling.spans(before, profiling.cursor())
        if kind == "stft":
            A, B = conv.dicts["stft"]
            sc = StreamingConverter(load_config(overrides=OVERRIDES), A, B, synth_iters=2,
                                    device="cpu")
            S = stft(torch.as_tensor(read_wav(src)[0]), n_fft=400, hop_length=80)
            with profile(activities=[ProfilerActivity.CPU]):
                before = profiling.cursor()
                for k in (0, 16):
                    sc.push(torch.abs(S[k: k + 16]), S[k: k + 16])
                out["stream"] = profiling.spans(before, profiling.cursor())
    for recs in (out["stft"], out["world"], out["stream"]):
        assert all(s["device_ms"] is None for s in recs)
        for s in recs:
            s["device_ms"] = s["host_ms"]
    return out


@pytest.mark.parametrize("kind", ["stft", "world", "stream"])
def test_readers_on_the_spans_the_program_records(kind, recorded, monkeypatch):
    recs = recorded[kind]
    got = {n: _read(n, recs, monkeypatch, calls=2 if kind == "stream" else 1) for n in NAMES}
    if kind == "stream":
        seen = {"push.solve_ms", "push.synthesis_ms", "push.mu_steps", "synthesis.capture_ms"}
        assert 1 <= got["push.mu_steps"] <= 20
    else:
        seen = set(SERVE) | {"convert.solve_roofline_pct", "synthesis.capture_ms"}
        seen |= set(WORLD) if kind == "world" else set()
        (root,) = [s for s in recs if s["name"] == "convert"]
        assert sum(got[n] for n in SERVE) <= root["device_ms"]
        if kind == "world":
            assert sum(got[n] for n in WORLD) <= got["convert.features_ms"]
        steps = sum(s["attrs"]["n_iter"] for s in recs if s["name"] == "nmf")
        assert steps == recorded[kind + "_iters"]
        assert 0 < got["convert.solve_roofline_pct"] < 100
    assert {n for n, v in got.items() if v is not None} == seen
    assert got["synthesis.capture_ms"] == 0.0 and np.isfinite(list(filter(None, got.values()))).all()
