"""The port's command line (``exemplars_vc_tpu_torch/pipelines/cli.py``) on the
stand-in corpus (3 pairs) with ``--device cpu``: each subcommand runs
in-process and prints one JSON object with the JAX CLI's keys
(``exemplars_vc_tpu/pipelines/cli.py``); the numbers behind them are held to
the JAX package by the module tests (``test_torch_{lpc,freq_warp,warping,
train,evaluate,convert}.py``)."""

import json
import os

import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu_torch.io.standin import build_standin_corpus
from exemplars_vc_tpu_torch.pipelines.cli import main

# the keys of each JAX CLI command's JSON line
JAX_KEYS = {
    "make-dict": {"pairs", "total_exemplars", "mean_distance"},
    "freq-warp": {"variant", "artifacts"},
    "warp-train": {"epochs_run", "best_epoch", "best_test_loss", "final_test_l1_per_frame",
                   "train_seconds", "steps_run", "steps_per_s", "epochs_per_s",
                   "seconds_to_best", "minibatch_utterances", "checkpoint", "run_dir",
                   "history"},
    "warp-eval": {"test_utterances", "l1_per_coeff", "identity_baseline_l1", "improvement"},
    "convert": {"out", "sr", "samples", "nmf_iters", "nmf_error", "mcd_vs_reference",
                "timings"},
    "eval-heldout": {"utterance", "no_conversion_mcd_db", "scores"},
}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data, src, tar = build_standin_corpus(str(root / "corpus"), n_pairs=3)
    return dict(data=data, src=src, tar=tar, store=str(root / "store"), root=root)


def run(capsys, *argv) -> dict:
    main(list(argv))
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1])


def common(c, *extra):
    return ["--data", c["data"], "--store", c["store"], "--nb-file", "3", "--tar", "TF1",
            "--device", "cpu", "-o", "nmf.max_iter=20", *extra]


@pytest.mark.parametrize("feat", ["mfcc", "mcep"])
def test_make_dict(corpus, capsys, feat):
    out = run(capsys, "make-dict", *common(corpus, "--feat", feat))
    assert set(out) == JAX_KEYS["make-dict"]
    assert out["pairs"] == 3 and out["total_exemplars"] > 0 and out["mean_distance"] > 0


@pytest.mark.parametrize("variant", ["amf", "dfw"])
def test_freq_warp(corpus, capsys, variant):
    out = run(capsys, "freq-warp", *common(corpus, "--variant", variant))
    assert set(out) == JAX_KEYS["freq-warp"] and out["variant"] == variant
    want = ({"anchors": [512, 2, 22], "mean_anchors": [2, 22]} if variant == "amf"
            else {"curves": [512, 201], "mean_curve": [201]})
    assert out["artifacts"] == want


def test_warp_train_then_eval(corpus, capsys):
    runs = str(corpus["root"] / "runs")
    out = run(capsys, "warp-train", *common(corpus, "-o", "net.nb_epoch=2", "--runs", runs))
    assert set(out) == JAX_KEYS["warp-train"]
    assert out["epochs_run"] == 2 and len(out["history"]) == 2
    assert os.path.isfile(os.path.join(out["run_dir"], "scalars.jsonl"))
    out = run(capsys, "warp-eval", *common(corpus))
    assert set(out) == JAX_KEYS["warp-eval"] and out["test_utterances"] == 1


def test_convert_and_eval_heldout(corpus, capsys):
    wav_out = str(corpus["root"] / "out.wav")
    out = run(capsys, "convert", *common(corpus, "--wav", corpus["src"], "--out", wav_out,
                                         "--synth-iters", "5", "--ref-wav", corpus["tar"]))
    assert set(out) == JAX_KEYS["convert"] and os.path.isfile(wav_out)
    assert set(out["timings"]) == {"dicts", "features", "nmf_solve", "synthesis"}
    out = run(capsys, "eval-heldout", *common(corpus, "--configs", "stft_parity",
                                              "--synth-iters", "5"))
    assert set(out) == JAX_KEYS["eval-heldout"]
    assert set(out["scores"]) == {"stft_parity"} and set(out["scores"]["stft_parity"]) == \
        {"mcd_db"}


@pytest.mark.parametrize("cmd", ["separate", "separate-lead"])
def test_separation_is_not_ported(cmd, tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1 item 13"):
        main([cmd, "--wav", "x.wav", "--out-dir", str(tmp_path), "--device", "cpu"])


def test_default_device_is_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["make-dict", "--data", corpus["data"], "--store", corpus["store"], "--nb-file", "3",
              "--tar", "TF1"])
