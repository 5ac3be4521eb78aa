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
    "separate": {"out", "sr", "nll_first", "nll_last"},
    "separate-lead": {"lead", "accomp", "sr", "channels", "voiced_frames", "f0_median"},
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
def test_separation_is_not_ported(cmd, tmp_path, capsys):
    """Both separation commands run (the name is kept from when
    ``separate-lead`` refused): ``separate`` and ``separate-lead`` with each
    ``--model`` on a short stereo wav print the JAX CLI's keys and write
    their wavs."""
    from exemplars_vc_tpu_torch.io.standin import synthetic_mixture
    from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav

    wav = str(tmp_path / "mix.wav")
    write_wav(wav, synthetic_mixture()[:, :8000], 16000)
    if cmd == "separate-lead":
        for model in ("mono", "stereo", "multichannel"):
            out_dir = tmp_path / model
            out = run(capsys, cmd, "--wav", wav, "--out-dir", str(out_dir), "--model", model,
                      "--iters", "3", "--em-iters", "2", "--components", "4",
                      "--device", "cpu")
            assert set(out) == JAX_KEYS["separate-lead"] and out["sr"] == 16000, model
            assert out["lead"] == str(out_dir / "mix_lead.wav")
            assert out["accomp"] == str(out_dir / "mix_accomp.wav")
            assert out["channels"] == 2 and out["voiced_frames"] >= 0
            for p in (out["lead"], out["accomp"]):
                y, sr = read_wav(p, mono=False)
                assert sr == 16000 and y.shape == (2, 8000), (model, p)
        return
    out = run(capsys, cmd, "--wav", wav, "--out-dir", str(tmp_path / "sep"), "--em-iters", "3",
              "--components", "4", "--device", "cpu")
    assert set(out) == JAX_KEYS["separate"] and out["sr"] == 16000
    assert [os.path.basename(p) for p in out["out"]] == ["mix_source0.wav", "mix_source1.wav"]
    assert all(os.path.isfile(p) for p in out["out"])
    assert out["nll_last"] <= out["nll_first"]


@pytest.mark.parametrize("channels", ["mono", "stereo"])
def test_separate_matches_the_jax_cli_on_a_mono_wav(tmp_path, capsys, channels):
    """Both commands separate the same duplicated two-channel mixture: the
    wav downmixed to mono, taken twice. The mono case is a one-channel wav;
    the stereo case a wav with distinct channels, which the JAX command
    averages before it duplicates them. Both draw their inits from
    ``PRNGKey(3)`` (``--seed 3``). The NLLs agree to 1e-5 relative and the wavs to
    1e-3 of their peak plus one PCM16 step.

    That is ten times the 1e-4 that ``separate_signal`` is held to on a
    mixture with distinct channels (``test_torch_separate.py``): with equal
    channels nothing spatial tells the two sources apart, and the EM
    amplifies roundoff. The
    JAX package alone, given the same input times (1 + 2e-7·noise), moves
    its images by 2.3e-5, 2.1e-4 and 6.9e-4 of their peak after 1, 3 and 5
    EM iterations (4.8e-6 after 5 on the stereo mixture); the port against
    it measured 4.4e-5, 2.1e-4 and 6.4e-4."""
    import numpy as np

    from exemplars_vc_tpu.pipelines.cli import main as jax_main
    from exemplars_vc_tpu_torch.io.standin import synthetic_mixture
    from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav

    wav = str(tmp_path / f"{channels}.wav")
    mix = synthetic_mixture()[:, :8000]
    write_wav(wav, mix[0] if channels == "mono" else mix, 16000)
    if channels == "stereo":
        assert read_wav(wav, mono=False)[0].shape == (2, 8000)
    args = ["--wav", wav, "--em-iters", "3", "--components", "4", "--n-fft", "256",
            "--hop", "64", "--seed", "3"]
    jax_main(["separate", *args, "--out-dir", str(tmp_path / "jax")])
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = run(capsys, "separate", *args, "--out-dir", str(tmp_path / "port"), "--device", "cpu")
    assert set(out) == set(ref) == JAX_KEYS["separate"] and out["sr"] == ref["sr"]
    for p, q in zip(out["out"], ref["out"], strict=True):
        assert os.path.basename(p) == os.path.basename(q)
        got, want = read_wav(p)[0], read_wav(q)[0]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-3 * np.abs(want).max() + 2 ** -15)
    for k in ("nll_first", "nll_last"):
        np.testing.assert_allclose(out[k], ref[k], rtol=1e-5)


# ``separate --seed 0`` on the 2 s mixture at 20 EM iterations: the duplicated
# channels leave nothing spatial between the sources and the EM turns float32
# roundoff into per-cent differences. The JAX package against itself, its
# input times (1 + 2e-7·noise) over 8 noise seeds, moves the source energies
# by up to 2.9e-2 relative and the last NLL by up to 7.3e-4 (the first NLL by
# roundoff); the port against it measured 8.3e-3 and 6.2e-4. ``chip_smoke.py``
# phase 13 holds the card's run to the JAX numbers with these tolerances.
SEPARATE_20EM_RTOL = {"nll_first": 1e-5, "nll_last": 2e-3, "energy": 5e-2}


def _wav_energies(paths) -> list[float]:
    import numpy as np

    from exemplars_vc_tpu_torch.io.wav import read_wav

    return [float((read_wav(p, mono=False)[0].astype(np.float64) ** 2).sum()) for p in paths]


@pytest.mark.parametrize("cmd", ["separate", "separate-lead", "warp-train"])
def test_seeded_commands_match_the_jax_cli(cmd, corpus, tmp_path, capsys):
    """The seeded commands, each package's CLI from its own draws of the same
    seed: ``separate --seed 0`` (2 s mixture, 20 EM; tolerances above),
    ``separate-lead --model stereo --seed 1`` (2 s mixture, 15 iterations,
    20 components: the same melody, the wavs within 1e-4 of the mixture's
    peak plus one PCM16 step, as the in-process stereo pipeline is held) and
    ``warp-train`` (seed 0, which neither CLI exposes; 3 epochs: the
    history's losses within 1e-3, as ``test_torch_train.py`` holds them).
    The stereo split read back from PCM16 lands at a lead share of 0.132 in
    both packages, not at the 0.676 of the float mixture."""
    import numpy as np

    from exemplars_vc_tpu.pipelines.cli import main as jax_main
    from exemplars_vc_tpu_torch.io.standin import synthetic_mixture
    from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav

    wav = str(tmp_path / "mix.wav")
    x = synthetic_mixture()
    write_wav(wav, x, 16000)
    if cmd == "separate":
        args = ["separate", "--wav", wav, "--seed", "0", "--em-iters", "20"]
    elif cmd == "separate-lead":
        args = ["separate-lead", "--wav", wav, "--model", "stereo", "--seed", "1",
                "--iters", "15", "--components", "20"]
    else:
        args = ["warp-train", "--data", corpus["data"], "--nb-file", "3", "--tar", "TF1",
                "-o", "nmf.max_iter=20", "-o", "net.nb_epoch=3"]
    jax_main(args + (["--store", str(tmp_path / "js"), "--runs", str(tmp_path / "jr")]
                     if cmd == "warp-train" else ["--out-dir", str(tmp_path / "jax")]))
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = run(capsys, *args, *(["--store", str(tmp_path / "ts"), "--runs", str(tmp_path / "tr")]
                               if cmd == "warp-train" else ["--out-dir", str(tmp_path / "port")]),
              "--device", "cpu")
    assert set(out) == set(ref) == JAX_KEYS[cmd]
    if cmd == "separate":
        for k in ("nll_first", "nll_last"):
            np.testing.assert_allclose(out[k], ref[k], rtol=SEPARATE_20EM_RTOL[k])
        np.testing.assert_allclose(_wav_energies(out["out"]), _wav_energies(ref["out"]),
                                   rtol=SEPARATE_20EM_RTOL["energy"])
    elif cmd == "separate-lead":
        assert (out["voiced_frames"], out["f0_median"]) == (ref["voiced_frames"],
                                                            ref["f0_median"])
        for k in ("lead", "accomp"):
            got, want = read_wav(out[k], mono=False)[0], read_wav(ref[k], mono=False)[0]
            assert np.abs(got - want).max() <= 1e-4 * np.abs(x).max() + 2 ** -15, k
    else:
        assert (out["epochs_run"], out["best_epoch"]) == (ref["epochs_run"], ref["best_epoch"])
        for h_t, h_j in zip(out["history"], ref["history"], strict=True):
            for k in ("train_loss", "test_loss", "test_l1_per_frame"):
                np.testing.assert_allclose(h_t[k], h_j[k], rtol=1e-3)


def test_default_device_is_the_card(corpus):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        main(["make-dict", "--data", corpus["data"], "--store", corpus["store"], "--nb-file", "3",
              "--tar", "TF1"])
