"""The check catches a broken timed path: the harness runs on the CPU at a
small size with the program broken underneath, and ``correct`` comes out
false for each fault the cell can have (an answer altered where it is made;
a stream step that leaves its state unchanged; Griffin-Lim's phase broken
while its magnitudes stay: no momentum, a random start in place of the
source phase, the stream's carried context phase dropped), true without
one."""

import time

import pytest
import torch

from benchmark.harness.bench import run_cell
from benchmark.tests.small import small_cell


def _run(name):
    return run_cell(small_cell(name), 2**34 + 11, 0.5, False, torch.device("cpu"),
                    time.perf_counter())


def altered_convert(monkeypatch):
    from exemplars_vc_tpu_torch.pipelines.serve import Converter

    orig = Converter.convert

    def convert(self, *a, **k):
        out = orig(self, *a, **k)
        out.audio = out.audio * 1.02
        return out

    monkeypatch.setattr(Converter, "convert", convert)


def altered_push(monkeypatch):
    from exemplars_vc_tpu_torch.pipelines.stream import StreamingConverter

    orig = StreamingConverter.push
    monkeypatch.setattr(StreamingConverter, "push", lambda self, *a: orig(self, *a) * 1.02)


def stale_stream_state(monkeypatch):
    from exemplars_vc_tpu_torch.pipelines.stream import StreamingConverter

    orig = StreamingConverter.push

    def push(self, *a):
        kept = (self._context_mag, self._context_phase)
        out = orig(self, *a)
        self._context_mag, self._context_phase = kept
        return out

    monkeypatch.setattr(StreamingConverter, "push", push)


def _gl_patched(monkeypatch, **override):
    from exemplars_vc_tpu_torch.pipelines import serve, stream

    for mod in (serve, stream):
        orig = mod.griffin_lim
        monkeypatch.setattr(mod, "griffin_lim",
                            lambda *a, _orig=orig, **k: _orig(*a, **dict(k, **override)))


def gl_without_momentum(monkeypatch):
    _gl_patched(monkeypatch, momentum=0.0)


def gl_random_start(monkeypatch):
    _gl_patched(monkeypatch, init_phase=None)


def dropped_context_phase(monkeypatch):
    from exemplars_vc_tpu_torch.pipelines.stream import StreamingConverter

    orig = StreamingConverter.push

    def push(self, *a):
        out = orig(self, *a)
        self._context_phase = None
        return out

    monkeypatch.setattr(StreamingConverter, "push", push)


PHASE_FAULTS = [("stft.serve", gl_without_momentum), ("stft.serve", gl_random_start),
                ("stft.stream", gl_without_momentum), ("stft.stream", gl_random_start),
                ("stft.stream", dropped_context_phase)]


@pytest.mark.parametrize("name", ["stft.serve", "world.serve", "stft.stream"])
def test_sound_run_is_correct(name):
    assert _run(name)["correct"] is True


@pytest.mark.parametrize("name,fault", [("stft.serve", altered_convert),
                                        ("world.serve", altered_convert),
                                        ("stft.stream", altered_push),
                                        ("stft.stream", stale_stream_state)])
def test_fault_is_caught(name, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(name)
    assert r["correct"] is False
    failing = [k for k, c in r["checks"].items() if k != "problems" and c["value"] > c["limit"]]
    assert failing


@pytest.mark.parametrize("name,fault", PHASE_FAULTS)
def test_phase_fault_is_caught_by_the_waveform(name, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(name)
    assert r["correct"] is False
    held = [c for k, c in r["checks"].items() if k.startswith("audio_rel_l2")]
    assert held and any(c["value"] > c["limit"] for c in held)
