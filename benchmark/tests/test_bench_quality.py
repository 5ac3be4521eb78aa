"""The cell ``stft-quality.serve``: found from its own files, its KL work
count by hand, its four readers on hand-made span logs (and None where the
program records no such span, as a program before the ``beta`` attribute
and the ``h_smooth`` span does) and on the spans a real conversion records
on the CPU, one small run of the cell on the CPU, and on the card the
control failing the cell's limits while the program passes them."""

import json
import time

import pytest
import torch

from benchmark.harness import roofline, roofline_kl
from benchmark.harness.bench import run_cell
from benchmark.harness.readings import readings
from benchmark.harness.spec import BENCH_DIR, ROOT, load_cell, load_reader
from benchmark.tests.small import small_cell
from exemplars_vc_tpu_torch.obs import profiling

CELL = "stft-quality.serve"
NAMES = ["quality.solve_ms", "quality.kl_roofline_pct", "quality.mu_steps", "quality.smooth_ms"]


def test_the_cell_is_found_from_its_own_files():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    (w,) = [w for w in bench["workloads"] if w["name"] == CELL]
    (c,) = [c for c in bench["configs"] if c["name"] == w["config"]]
    assert w["chips"] == 1 and c["reduced"] == []
    cell = load_cell(CELL)
    assert cell.config == json.loads((ROOT / c["file"]).read_text())
    assert cell.traffic == json.loads((BENCH_DIR / "traffic/serve_quality.json").read_text())
    assert cell.entry.__file__ == str(BENCH_DIR / "entries/serve_quality.py")
    assert cell.limits == json.loads((BENCH_DIR / f"limits/{CELL}.json").read_text())["limits"]
    assert sorted(cell.readers) == sorted(NAMES)
    assert {m["name"] for m in cell.end_to_end} == {"audio_s_per_s", "setup_s"}
    s = cell.settings
    assert (s["nmf.beta_loss"], s["data.dict_augment_warps"], s["nmf.h_smooth"]) == \
        ("kullback-leibler", "0.9,0.95,1.05,1.1", 2)
    stft = json.loads((BENCH_DIR / "configs/vcc2016-sf1-tf1-stft.json").read_text())
    changed = {k for k in s if s[k] != stft["settings"].get(k)}
    assert changed == {"nmf.beta_loss", "data.dict_augment_warps", "nmf.h_smooth"}
    assert cell.config["corpus"] == stft["corpus"]
    serve = json.loads((BENCH_DIR / "traffic/serve.json").read_text())
    assert {k: v for k, v in cell.traffic.items() if k not in ("entry", "why")} == \
        {k: v for k, v in serve.items() if k not in ("entry", "why")}


@pytest.mark.parametrize("F,K,D,n,s", [(600, 71680, 201, 130, 2), (1361, 71680, 201, 150, 0),
                                       (16, 71680, 201, 25, 2)])
def test_kl_work_by_hand(F, K, D, n, s):
    fkd = F * K * D
    checks = 1 + (n + 9) // 10
    # n + 1 reconstructions, n products with Aᵀ, the conversion; the ratio,
    # the update, the error checks and the box filter
    flops = ((n + 1) * 2 * fkd + n * 2 * fkd + 2 * fkd + n * 2 * F * D + n * 2 * F * K
             + checks * 6 * F * D + (2 * s + 1) * F * K)
    assert roofline_kl.kl_solve_work(F, K, D, n, s) == (flops, 4 * (2 * F * D + 2 * K * D))
    assert roofline.least_seconds(flops, 0) == flops / 67e12


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


def _requests(kl=True, smooth=True, device=True):
    """Two requests: solve 200 and 100 ms (device), nmf over F = 600 and 300
    frames at K = 71,680 in 120 and 90 steps, the box filter 1.5 and 0.5 ms;
    ``kl=False`` leaves out ``beta``, ``smooth=False`` the ``h_smooth`` span,
    as a program without them records."""
    t = _Tree()
    d = (lambda v: v) if device else (lambda v: None)
    for F, n, so, sm in ((600, 120, 200.0, 1.5), (300, 90, 100.0, 0.5)):
        root = t.add("convert", device_ms=d(400.0))
        t.add("features", root, device_ms=d(2.0))
        solve = t.add("solve", root, device_ms=d(so), residual=False)
        attrs = dict(F=F, K=71680, D=201, n_iter=n, **({"beta": "kl"} if kl else {}))
        t.add("nmf", solve, device_ms=d(so - 10), **attrs)
        if smooth:
            t.add("h_smooth", solve, device_ms=d(sm), F=F, K=71680, s=2)
        t.add("synthesis", root, device_ms=d(150.0))
    return t.recs


def _read(name, recs, monkeypatch):
    monkeypatch.setattr(profiling, "spans", lambda since=0, until=None: recs)
    reader = load_reader(name)
    return reader.read({"snapshot": (reader.snapshot(), reader.snapshot()), "calls": 2})


def test_each_reader_by_hand(monkeypatch):
    least = sum(roofline.least_seconds(*roofline_kl.kl_solve_work(F, 71680, 201, n, 2))
                for F, n in ((600, 120), (300, 90)))
    want = {"quality.solve_ms": 150.0, "quality.kl_roofline_pct": 100.0 * least / 0.3,
            "quality.mu_steps": 105.0, "quality.smooth_ms": 1.0}
    for name in NAMES:
        assert _read(name, _requests(), monkeypatch) == pytest.approx(want[name], rel=1e-12)
    # a program whose spans lack beta and h_smooth: the solve's time and steps only
    older = {n: _read(n, _requests(kl=False, smooth=False), monkeypatch) for n in NAMES}
    assert older == {"quality.solve_ms": 150.0, "quality.kl_roofline_pct": None,
                     "quality.mu_steps": 105.0, "quality.smooth_ms": None}


@pytest.mark.parametrize("name", NAMES)
def test_each_reader_gives_none_without_its_spans(name, monkeypatch):
    assert _read(name, [], monkeypatch) is None
    assert _read(name, _requests(device=False), monkeypatch) is None     # off the card
    monkeypatch.delattr(profiling, "cursor")                            # no spans kept
    reader = load_reader(name)
    assert reader.snapshot() is None and reader.read({"snapshot": (None, None)}) is None


def test_readers_on_the_spans_a_conversion_records(tmp_path, monkeypatch):
    """One quality conversion on the CPU, each span given its host time as
    its device time."""
    import sys

    from torch.profiler import ProfilerActivity, profile

    sys.path.insert(0, str(ROOT / "tests"))
    from torch_corpus import OVERRIDES, write_synthetic_corpus

    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.pipelines.serve import Converter

    data, src, _ = write_synthetic_corpus(tmp_path / "corpus")
    conv = Converter(load_config(preset="quality", overrides=OVERRIDES),
                     ArtifactStore(str(tmp_path / "store")), data, nb_file=3, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]):
        before = profiling.cursor()
        out = conv.convert(src, synth_iters=2)
        recs = profiling.spans(before, profiling.cursor())
    for s in recs:
        s["device_ms"] = s["host_ms"]
    got = {n: _read(n, recs, monkeypatch) for n in NAMES}
    assert got["quality.mu_steps"] == out.nmf_iters
    assert 0.0 < got["quality.smooth_ms"] < got["quality.solve_ms"]
    assert 0.0 < got["quality.kl_roofline_pct"] < 100.0


def test_the_cell_runs_small_on_the_cpu():
    cell = small_cell(CELL)
    r = run_cell(cell, 2**35 + 17, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(r["checks"]) == set(cell.limits) | {"problems"} and cell.limits


@pytest.mark.card
def test_control_fails_and_program_passes(card):
    cell = load_cell(CELL)
    for row in readings(cell, [2**31 + 101, 2**32 + 5, 3 * 2**31 + 9], 4.0, card):
        assert not row["problems"]
        assert all(row["program"][k] <= lim for k, lim in cell.limits.items())
        assert any(row["control"][k] > lim for k, lim in cell.limits.items())
