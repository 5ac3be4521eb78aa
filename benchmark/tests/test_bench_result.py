"""The result line, and a run on the CPU at a small size through every
entry: the keys the contract names, the metrics of the cell, and the run
refused without a card."""

import json
import time

import pytest
import torch

from benchmark.harness.bench import main, run_cell
from benchmark.tests.small import small_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name,trace", [("stft.serve", False), ("stft.serve", True),
                                        ("stft.stream", False), ("stft.stream", True)])
def test_a_small_run_prints_the_contract_keys(name, trace):
    cell = small_cell(name)
    r = run_cell(cell, 2**35 + 3, 0.5, trace, torch.device("cpu"), time.perf_counter())
    assert list(r) == KEYS + (["breakdown"] if "breakdown" in r else []) + ["checks"]
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] >= 1
    want = {m["name"] for m in (cell.per_layer if trace else cell.end_to_end)}
    assert set(r["metrics"]) <= want
    if not trace:
        assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for k, v in r["metrics"].items() if k != "synthesis.captures_per_request")
    assert set(r["checks"]) == set(cell.limits) | {"problems"}
    json.dumps(r)


def test_without_a_card_it_exits_nonzero_and_prints_nothing(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["--workload", "stft.serve", "--seed", str(2**33), "--seconds", "1"], 0.0) != 0
    assert capsys.readouterr().out == ""
