"""A cell of ``BENCHMARK.json`` and the data files it names.

Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file of its own, found by the name ``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the settings as they run, the corpus recipe,
  ``source``, ``assumed`` and ``reduced`` (the entry's ``file``);
- ``traffic/<traffic>.json``: the parameters of the general generator
  (:mod:`benchmark.harness.traffic`) and the ``entry`` it drives;
- ``entries/<entry>.py``: one kind of call, its driver, requests and
  reference answers (:mod:`benchmark.entries`);
- ``metrics/<metric>.py``: a ``read(obs)`` that returns the metric's value
  from a traced run's observations, or None where it finds nothing, and
  optionally a ``snapshot()`` of a program counter, which the harness takes
  before and after the traced window and hands to ``read`` as
  ``obs["snapshot"]`` = (before, after);
- ``limits/<cell>.json``: the limit of each number the correctness check
  compares, with the readings it was set from.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict            # the configuration file's contents
    traffic: dict           # the traffic file's parameters
    entry: object           # the entries/<entry>.py module the traffic drives
    end_to_end: list        # this cell's end-to-end metric entries
    per_layer: list         # this cell's per-layer metric entries
    limits: dict            # {number: limit}
    readers: dict = field(default_factory=dict)   # per-layer name -> metrics/<name>.py

    @property
    def settings(self) -> dict:
        return self.config["settings"]


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def _load(kind: str, name: str, bench_dir: Path):
    path = bench_dir / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``metrics/<name>.py``: its ``read``, and its ``snapshot`` where it has one."""
    return _load("metrics", name, bench_dir)


def load_entry(name: str, bench_dir: Path = BENCH_DIR):
    """The module ``entries/<name>.py`` (see :mod:`benchmark.entries`)."""
    return _load("entries", name, bench_dir)


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` with its files, from ``root/BENCHMARK.json``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; have {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    bench_dir = root / bench["paths"][0]
    traffic = json.loads((bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
    limits_path = bench_dir / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text())["limits"] if limits_path.is_file() else {}
    per_layer = [m for m in bench["per_layer"] if _applies(m, workload)]
    return Cell(name=workload, chips=int(w["chips"]), config=config, traffic=traffic,
                entry=load_entry(traffic["entry"], bench_dir),
                end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
                per_layer=per_layer, limits=limits,
                readers={m["name"]: load_reader(m["name"], bench_dir) for m in per_layer})
