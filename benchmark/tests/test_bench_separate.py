"""The cell ``separate.speech60``: found from its own files, its fit block the
same in the configuration and the traffic file, its requests, its six
readers on hand-made span logs (None where the program records no such
span or counter, as a program before them does) and on the spans a real
separation records on the CPU, a small run of the cell on the CPU that is
correct, and not correct with a fault planted in the program, and on the
card the control failing the cell's limits while the program passes them.

The cell cut for the CPU (:func:`small_cell`): 2 s recordings, 10 EM
iterations, two requests in the pool, two checked."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark.harness import roofline, roofline_sep
from benchmark.harness.bench import run_cell
from benchmark.harness.readings import readings
from benchmark.harness.spec import BENCH_DIR, ROOT, load_cell, load_reader
from benchmark.tests.test_bench_imports import PORT, imported_tops
from exemplars_vc_tpu_torch.obs import profiling
from exemplars_vc_tpu_torch.separate import multichannel

CELL = "separate.speech60"
NAMES = ["separate.em_ms", "separate.estep_ms", "separate.nmf_ms", "separate.images_ms",
         "separate.em_roofline_pct", "separate.launches_per_em"]


def small_cell():
    cell = load_cell(CELL)
    cell.traffic.update(seconds=2.0, pool=2, warmup=1, trace_seconds=0.5, check_sample=2)
    cell.traffic["fit"] = dict(cell.traffic["fit"], n_em=10)
    return cell


def _run(seed=2**34 + 11):
    return run_cell(small_cell(), seed, 0.5, False, torch.device("cpu"), time.perf_counter())


def test_the_cell_is_found_from_its_own_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    assert w["chips"] == 1 and c["reduced"] == [] and len(c["source"]) <= 200
    cell = load_cell(CELL)
    assert cell.config == json.loads((ROOT / c["file"]).read_text())
    assert cell.traffic == json.loads((BENCH_DIR / "traffic/separate_stereo60.json").read_text())
    assert cell.entry.__file__ == str(BENCH_DIR / "entries/separate.py")
    assert cell.limits == json.loads((BENCH_DIR / f"limits/{CELL}.json").read_text())["limits"]
    assert sorted(cell.readers) == sorted(NAMES)
    assert {m["name"] for m in cell.end_to_end} == {"audio_s_per_s", "setup_s"}
    assert cell.entry.LATENCY not in {m["name"] for m in bench["end_to_end"]}
    assert cell.config["corpus"] == []


def test_the_fit_block_is_the_configurations():
    cell = load_cell(CELL)
    assert cell.traffic["fit"] == cell.config["fit"]
    assert cell.config["fit"] == {"n_sources": 2, "n_components": 8, "n_em": 50, "n_fft": 400,
                                  "hop_length": 80, "spectral_model": "nmf",
                                  "spatial_init": "random", "key": 0}


def test_the_reference_imports_nothing_of_the_program():
    path = BENCH_DIR / "reference" / "separate.py"
    assert PORT not in imported_tops(path) and not {"jax", "jaxlib"} & imported_tops(path)


def test_requests_are_seeded_stereo_recordings():
    cell = load_cell(CELL)
    params = dict(cell.traffic, seconds=4.0, pool=3)
    warm, pool = cell.entry.requests(params, {}, 2**33 + 1, "", "cpu")
    again = cell.entry.requests(params, {}, 2**33 + 1, "", "cpu")[1]
    other = cell.entry.requests(params, {}, 2**33 + 2, "", "cpu")[1]
    assert len(warm) == 1 and len(pool) == 3 and all(len(s) == 1 for s in warm + pool)
    for (m,), (a,), (o,) in zip(pool, again, other):
        assert m.samples.dtype == np.float32 and m.samples.shape == (2, 64000)
        assert np.array_equal(m.samples, a.samples) and not np.array_equal(m.samples, o.samples)
        assert np.abs(m.samples).max() == pytest.approx(0.5, rel=1e-6)
        assert cell.entry.Driver.audio_s(m) == 4.0
    assert not np.array_equal(pool[0][0].samples, pool[1][0].samples)


def test_the_mixing_is_the_stated_one():
    """A mixture is 0.9·A + 0.35·B on the left and 0.35·A + 0.9·B′ on the
    right, B′ being B three samples late: the talkers are recovered exactly
    from the two channels."""
    cell = load_cell(CELL)
    params = dict(cell.traffic, seconds=3.0)
    (m,) = cell.entry.mixtures(params, 1, 7, 2)
    rng = np.random.default_rng([7, 2])
    speech = np.concatenate([cell.entry.traffic.read_pcm16(p)
                             for p in cell.entry.traffic.speech_files()]) / 32768.0
    L, T, apart = len(speech), 48000, 30 * 16000
    a0 = int(rng.integers(L))
    b0 = (a0 + apart + int(rng.integers(L - 2 * apart + 1))) % L
    a, b = (speech[(o + np.arange(T)) % L] for o in (a0, b0))
    x = np.stack([0.9 * a + 0.35 * b, 0.35 * a + 0.9 * np.concatenate([[0, 0, 0], b[:-3]])])
    np.testing.assert_allclose(m.samples, 0.5 / np.abs(x).max() * x, rtol=1e-6, atol=1e-7)
    assert min((b0 - a0) % L, (a0 - b0) % L) >= apart


class _Tree:
    """Span records as ``obs.profiling.spans`` returns them."""

    def __init__(self):
        self.recs, self.next = [], 1

    def add(self, name, parent=None, device_ms=1.0, **attrs):
        sid, self.next = self.next, self.next + 1
        self.recs.append({"name": name, "id": sid,
                          "parent": None if parent is None else parent["id"],
                          "root": sid if parent is None else parent["root"], "attrs": attrs,
                          "start_ns": 0, "end_ns": 0, "host_ms": 1.0, "device_ms": device_ms})
        return self.recs[-1]


SHAPES = [(201, 12001, 50), (201, 6001, 3)]      # (F, N, n_em) of the two fits


def _fits(device=True, model="nmf"):
    """Two separations: the fit 3000 and 1000 ms (device), its E-steps 40
    and 30 ms each, its IS-NMF steps 10 and 5 ms each, the images 50 and
    30 ms."""
    t = _Tree()
    d = (lambda v: v) if device else (lambda v: None)
    for (F, N, n_em), em_ms, e_ms, n_ms, im_ms in zip(SHAPES, (3000.0, 1000.0), (40.0, 30.0),
                                                      (10.0, 5.0), (50.0, 30.0)):
        root = t.add("separate", device_ms=d(em_ms + 100.0), C=2, T=80 * (N - 1), J=2, K=8,
                     n_em=n_em, spectral_model=model)
        t.add("separate.stft", root, device_ms=d(2.0))
        em = t.add("separate.em", root, device_ms=d(em_ms), F=F, N=N, C=2, J=2, K=8,
                   n_em=n_em, n_inner=1)
        for _ in range(n_em):
            t.add("separate.estep", em, device_ms=d(e_ms))
            t.add("separate.nmf", em, device_ms=d(n_ms))
        t.add("separate.images", root, device_ms=d(im_ms))
    return t.recs


def _read(name, recs, monkeypatch, em_iters=(100, 153), kernels=13_000):
    monkeypatch.setattr(profiling, "spans", lambda since=0, until=None: recs)
    monkeypatch.setattr(multichannel.separate_signal, "em_iters", em_iters[0])
    reader = load_reader(name)
    before = reader.snapshot()
    monkeypatch.setattr(multichannel.separate_signal, "em_iters", em_iters[1])
    trace = {"kernels": kernels, "busy_s": 1.0, "window_s": 1.0}
    return reader.read({"snapshot": (before, reader.snapshot()), "calls": 2, "trace": trace,
                        "entry": "separate"})


def test_each_reader_by_hand(monkeypatch):
    least = sum(roofline.least_seconds(*roofline_sep.em_work(F, N, 2, 2, 8, n, 1))
                for F, N, n in SHAPES)
    want = {"separate.em_ms": 2000.0, "separate.estep_ms": (50 * 40 + 3 * 30) / 2,
            "separate.nmf_ms": (50 * 10 + 3 * 5) / 2, "separate.images_ms": 40.0,
            "separate.em_roofline_pct": 100.0 * least / 4.0,
            "separate.launches_per_em": 13_000 / 53}
    for name in NAMES:
        assert _read(name, _fits(), monkeypatch) == pytest.approx(want[name], rel=1e-12), name


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_gives_none_without_what_it_reads(name, monkeypatch):
    assert _read(name, [], monkeypatch, em_iters=(7, 7), kernels=0) is None
    assert _read(name, _fits(device=False), monkeypatch, em_iters=(7, 7)) is None  # off the card
    monkeypatch.delattr(profiling, "cursor")                        # a program without spans
    monkeypatch.delattr(multichannel.separate_signal, "em_iters")   # nor the counter
    reader = load_reader(name)
    assert reader.snapshot() is None and reader.read({"snapshot": (None, None)}) is None


def test_the_roofline_reads_nmf_fits_only(monkeypatch):
    assert _read("separate.em_roofline_pct", _fits(model="hmm"), monkeypatch) is None


def test_readers_on_the_spans_a_separation_records(monkeypatch):
    """One separation of a 1 s recording on the CPU, each span given its
    host time as its device time."""
    from torch.profiler import ProfilerActivity, profile

    from exemplars_vc_tpu_torch.io.standin import speech_mixture
    from exemplars_vc_tpu_torch.prng import PRNGKey

    x, _, _ = speech_mixture(seconds=1.0)
    with profile(activities=[ProfilerActivity.CPU]):
        before = profiling.cursor()
        multichannel.separate_signal(x, n_sources=2, n_components=8, n_em=4, key=PRNGKey(0),
                                     device="cpu")
        recs = profiling.spans(before, profiling.cursor())
    for s in recs:
        s["device_ms"] = s["host_ms"]
    got = {n: _read(n, recs, monkeypatch, em_iters=(0, 4), kernels=400) for n in NAMES}
    assert 0.0 < got["separate.estep_ms"] + got["separate.nmf_ms"] < got["separate.em_ms"]
    assert got["separate.images_ms"] > 0.0 and got["separate.launches_per_em"] == 100.0
    assert 0.0 < got["separate.em_roofline_pct"] < 100.0


def test_the_cell_runs_small_on_the_cpu():
    cell = small_cell()
    r = run_cell(cell, 2**35 + 17, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(r["checks"]) == set(cell.limits) | {"problems"} and cell.limits


def images_altered(monkeypatch):
    orig = multichannel.separate_signal

    def separate_signal(*a, **k):
        images, model = orig(*a, **k)
        return images * 1.02, model

    monkeypatch.setattr("exemplars_vc_tpu_torch.separate.separate_signal", separate_signal)


class _WithoutPosteriorCovariance:
    """``torch`` for the E-step, whose G·(v R) product hands back v R, so
    R̂ = ŷŷᴴ + v R − v R loses its (I − G)·v R term."""

    def __getattr__(self, name):
        return getattr(torch, name)

    @staticmethod
    def einsum(eq, *ops):
        return ops[1] if eq == "jfncd,jfnde->jfnce" else torch.einsum(eq, *ops)


def estep_without_its_posterior_covariance(monkeypatch):
    monkeypatch.setattr(multichannel, "torch", _WithoutPosteriorCovariance())


def h_not_updated(monkeypatch):
    orig = multichannel._nmf_inner
    monkeypatch.setattr(multichannel, "_nmf_inner", lambda z, W, H: (orig(z, W, H)[0], H))


@pytest.mark.parametrize("fault", [images_altered, estep_without_its_posterior_covariance,
                                   h_not_updated])
def test_fault_is_caught(fault, monkeypatch):
    fault(monkeypatch)
    r = _run()
    assert r["correct"] is False and r["failed"] == 0
    assert any(c["value"] > c["limit"] for k, c in r["checks"].items() if k != "problems")


@pytest.mark.card
def test_control_fails_and_program_passes(card):
    cell = load_cell(CELL)
    for row in readings(cell, [2**31 + 101, 2**32 + 5, 3 * 2**31 + 9], 4.0, card):
        assert not row["problems"]
        assert all(row["program"][k] <= lim for k, lim in cell.limits.items())
        assert any(row["control"][k] > lim for k, lim in cell.limits.items())
