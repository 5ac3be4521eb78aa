"""A cell, a configuration, a traffic mix, an entry and a per-layer metric
are added as files and BENCHMARK.json entries, with no edit to a file that
is there."""

import json
import shutil
import time

import torch

from benchmark.harness.bench import run_cell
from benchmark.harness.spec import BENCH_DIR, ROOT, load_cell
from benchmark.tests.small import SMALL, small_cell

# a new kind of call: the research entry point, convert_utterance, on one
# wav a request; it reuses the serve entry's requests and reference
RESEARCH_ENTRY = '''
from benchmark.entries.serve import reference, requests  # noqa: F401

LATENCY = "utterance_p95_ms"


class Driver:
    def __init__(self, cfg, store, data_path, params, device):
        from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance

        self.run = lambda path: convert_utterance(cfg, store, data_path, path, device=device)
        self.prepare_s = 0.0

    def start(self):
        return lambda clip: (self.run(clip.path).audio, None)

    @staticmethod
    def audio_s(clip):
        return clip.seconds
'''


def test_every_cell_of_the_benchmark_loads():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = load_cell(w["name"])
        assert cell.settings and cell.entry.__file__.endswith(f"{cell.traffic['entry']}.py")
        e2e = {m["name"] for m in cell.end_to_end}
        assert {"audio_s_per_s", "setup_s"} <= e2e
        assert e2e <= {"audio_s_per_s", "setup_s", cell.entry.LATENCY}
        assert {m["name"] for m in cell.per_layer} == set(cell.readers)
        moved = {m["moves"] for m in cell.per_layer}
        assert moved <= {m["name"] for m in cell.end_to_end}


def _checkout(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH_DIR, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "speech"))
    before = {p.relative_to(root): p.read_bytes() for p in (root / "benchmark").rglob("*")
              if p.is_file()}
    return root, before


def test_a_new_cell_is_found_from_its_files_alone(tmp_path):
    root, before = _checkout(tmp_path)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((BENCH_DIR / "configs" / "vcc2016-sf1-tf1-stft.json").read_text())
    cfg["name"] = "vcc2016-sf1-tf1-stft-mel"
    cfg["settings"]["nmf.solve_domain"] = "mel"
    (root / "benchmark/configs/vcc2016-sf1-tf1-stft-mel.json").write_text(json.dumps(cfg))
    (root / "benchmark/traffic/short.json").write_text(json.dumps(
        dict(json.loads((BENCH_DIR / "traffic/serve.json").read_text()), max_seconds=2.0)))
    (root / "benchmark/metrics/stage.total_ms.py").write_text(
        "def read(obs):\n    rows = obs.get('stages') or []\n"
        "    return sum(sum(r['timings'].values()) for r in rows) * 1e3 or None\n")
    (root / "benchmark/limits/mel.short.json").write_text(json.dumps(
        {"limits": {"audio_rel_l2": 1e-2, "spec_rel_l2": 1e-3}}))
    bench["configs"].append({"name": cfg["name"], "source": "x", "reduced": [], "why": "x",
                             "file": "benchmark/configs/vcc2016-sf1-tf1-stft-mel.json"})
    bench["workloads"].append({"name": "mel.short", "config": cfg["name"], "traffic": "short",
                               "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "stage.total_ms", "unit": "ms", "better": "lower",
                               "source": "program_span", "layer": "entry",
                               "moves": "audio_s_per_s", "workloads": ["mel.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = load_cell("mel.short", root)
    assert cell.settings["nmf.solve_domain"] == "mel"
    assert cell.traffic["max_seconds"] == 2.0
    assert cell.limits == {"audio_rel_l2": 1e-2, "spec_rel_l2": 1e-3}
    assert "stage.total_ms" in cell.readers and "device.idle_pct" not in cell.readers
    assert cell.readers["stage.total_ms"].read({"stages": [{"timings": {"a": 0.5}}]}) == 500.0
    after = {p: (root / p).read_bytes() for p in before}
    assert after == before


def test_a_new_entry_runs_from_its_files_alone(tmp_path):
    """A new kind of call (an entry file, a traffic file that names it, its
    own latency metric) runs end to end on the CPU and is checked against
    the reference, while every file that was there stays as it was."""
    root, before = _checkout(tmp_path)
    (root / "benchmark/entries/research.py").write_text(RESEARCH_ENTRY)
    (root / "benchmark/traffic/research.json").write_text(json.dumps(
        dict(json.loads((BENCH_DIR / "traffic/serve.json").read_text()), entry="research")))
    (root / "benchmark/limits/stft.research.json").write_text(
        (BENCH_DIR / "limits/stft.serve.json").read_text())
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "stft.research", "config": "vcc2016-sf1-tf1-stft",
                               "traffic": "research", "chips": 1, "why": "x"})
    bench["end_to_end"].append({"name": "utterance_p95_ms", "unit": "ms", "better": "lower",
                                "bound": 0.1, "source": "host_clock",
                                "workloads": ["stft.research"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = small_cell("stft.research", root)
    assert cell.entry.LATENCY == "utterance_p95_ms"
    assert cell.settings["misc.nb_file"] == SMALL["misc.nb_file"]
    r = run_cell(cell, 2**36 + 5, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert r["correct"] is True and r["failed"] == 0
    assert set(r["metrics"]) == {"audio_s_per_s", "utterance_p95_ms", "setup_s"}
    assert set(r["checks"]) == set(cell.limits) | {"problems"} and cell.limits
    after = {p: (root / p).read_bytes() for p in before}
    assert after == before
