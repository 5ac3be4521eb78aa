"""A stand-in corpus built from the 16 kHz speech committed under
``artifacts/audio/``, and the separation inputs: the benchmark's fixed
synthetic stereo mixture, a two-talker mixture of that speech, and the
JAX package's random inits of the lead-separation benchmark.

The reference corpus (VCC SF1/TF1) is not in the repository. These files are
earlier conversions of its utterances and keep their lengths, so a corpus
made of them reproduces the main path's shapes: 8 pairs in the 1408-frame
bucket and a 688-frame held-out input. Its K is 6144 exemplars, not the
real corpus's ≈ 7680: each pair is two conversions of one utterance, so its
DTW path stays near the diagonal. Its MCD is not comparable to the real
corpus's.

Layout written under ``root`` (what ``load_speaker`` and the held-out pair
convention ``<root>/wav/<spk>_100162.wav`` expect)::

    data/SF1/10000{1..8}.wav   <- artifacts/audio/loo/stft_parity_10000{1..8}.wav
    data/TF1/10000{1..8}.wav   <- artifacts/audio/loo/stft_quality_10000{1..8}.wav
    wav/SF1_100162.wav         <- artifacts/audio/heldout_100162_stft_parity.wav
    wav/TF1_100162.wav         <- artifacts/audio/heldout_100162_stft_quality.wav
"""

from __future__ import annotations

import os
import shutil
from pathlib import Path

import numpy as np

from exemplars_vc_tpu_torch.io.wav import read_wav
from exemplars_vc_tpu_torch.pipelines.evaluate import HELD_OUT_UTT

AUDIO_DIR = Path(__file__).resolve().parents[2] / "artifacts" / "audio"


def build_standin_corpus(root: str, n_pairs: int = 8) -> tuple[str, str, str]:
    """Write the stand-in corpus under ``root``; returns (data_path,
    held-out source wav, held-out target wav)."""
    root_p = Path(root)
    data = root_p / "data"
    for spk, kind in (("SF1", "parity"), ("TF1", "quality")):
        (data / spk).mkdir(parents=True, exist_ok=True)
        for k in range(1, n_pairs + 1):
            src = AUDIO_DIR / "loo" / f"stft_{kind}_10000{k}.wav"
            shutil.copyfile(src, data / spk / f"10000{k}.wav")
    wav = root_p / "wav"
    wav.mkdir(parents=True, exist_ok=True)
    held = {}
    for spk, kind in (("SF1", "parity"), ("TF1", "quality")):
        dst = wav / f"{spk}_{HELD_OUT_UTT}.wav"
        shutil.copyfile(AUDIO_DIR / f"heldout_{HELD_OUT_UTT}_stft_{kind}.wav", dst)
        held[spk] = os.fspath(dst)
    return os.fspath(data), held["SF1"], held["TF1"]


def synthetic_mixture(return_components: bool = False):
    """The fixed 2 s stereo mixture of the separation benchmark (a copy of
    ``bench_separate.py:synthetic_mixture``): a vibrato harmonic lead panned
    left plus a two-chord + filtered-noise accompaniment panned right. With
    ``return_components`` also the true stereo lead and accompaniment
    images."""
    sr, dur_s = 16000, 2.0
    t = np.arange(int(sr * dur_s)) / sr
    rng = np.random.default_rng(1234)
    f0 = 220.0 * (1 + 0.01 * np.sin(2 * np.pi * 5.0 * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    lead = sum((0.6 / h) * np.sin(h * phase) for h in range(1, 6))
    env = np.minimum(1.0, 10 * t) * np.minimum(1.0, 10 * (dur_s - t))
    lead = lead * env
    chord = sum(0.3 * np.sin(2 * np.pi * f * t) for f in (130.8, 164.8, 196.0))
    noise = rng.standard_normal(len(t))
    k = np.hanning(65)
    noise = np.convolve(noise, k / k.sum(), mode="same")
    accomp = (chord + 0.5 * noise) * env
    left = 0.9 * lead + 0.35 * accomp
    right = 0.35 * lead + 0.9 * accomp
    x = np.stack([left, right]).astype(np.float32)
    s = 0.5 / np.abs(x).max()
    if return_components:
        lead_img = (s * np.stack([0.9 * lead, 0.35 * lead])).astype(np.float32)
        acc_img = (s * np.stack([0.35 * accomp, 0.9 * accomp])).astype(np.float32)
        return s * x, lead_img, acc_img
    return s * x


def speech_mixture(seconds: float = 60.0):
    """A two-talker stereo recording made of the in-repo speech (44 files,
    148 s at 16 kHz): stream A is the files in sorted order, stream B the
    same list rotated by half, so the two always speak different
    utterances; each cut to ``seconds``. A is panned left (gains 0.9 / 0.35),
    B right (0.35 / 0.9) and 3 samples late on the right channel.
    Returns (x (2, T) float32 at peak 0.5, (2, 2, T) true images, sr)."""
    files = sorted(AUDIO_DIR.rglob("*.wav"))
    sigs = [read_wav(os.fspath(p)) for p in files]
    sr = sigs[0][1]
    n = int(seconds * sr)
    half = len(sigs) // 2

    def stream(order):
        s = np.concatenate([sigs[i][0] for i in order]).astype(np.float64)
        if len(s) < n:
            raise ValueError(f"the in-repo speech holds {len(s) / sr:.1f} s, "
                             f"{seconds} s asked for")
        return s[:n]

    a = stream(range(len(sigs)))
    b = stream([(i + half) % len(sigs) for i in range(len(sigs))])
    b_late = np.concatenate([np.zeros(3), b[:n - 3]])
    img_a = np.stack([0.9 * a, 0.35 * a])
    img_b = np.stack([0.35 * b, 0.9 * b_late])
    x = img_a + img_b
    s = 0.5 / np.abs(x).max()
    return ((s * x).astype(np.float32),
            np.stack([s * img_a, s * img_b]).astype(np.float32), sr)


def jax_simm_draws() -> tuple[dict, dict]:
    """The random inits that the JAX package's ``separate_lead_stereo(x,
    key=jax.random.PRNGKey(1))`` draws on :func:`synthetic_mixture` at
    ``bench_separate.py``'s settings (n_fft 1024, hop 256, f0 100-800 Hz, 20
    accompaniment components): (round 1, round 2) dicts keyed as
    ``stereo_simm``'s ``*_init`` arguments, float32 numpy. Written by
    ``tools/jax_simm_draws.py``; the port's own draws of ``PRNGKey(1)``
    (``separate_lead_stereo(..., key=prng.PRNGKey(1))``) are these, which a
    run without JAX checks against this record."""
    path = Path(__file__).parent / "data" / "jax_simm_draws_key1.npz"
    with np.load(path) as f:
        return tuple({k[len(f"round{i}_"):]: f[k] for k in f.files if k.startswith(f"round{i}_")}
                     for i in (1, 2))


def jax_prng_golden() -> dict:
    """What ``jax.random`` and the JAX package's seeded sites and CLI
    commands give on the CPU, for a run without JAX to hold ``prng`` to:
    written by ``tools/jax_prng_golden.py`` (its docstring lists the
    entries), numpy arrays by name."""
    with np.load(Path(__file__).parent / "data" / "jax_prng_golden.npz") as f:
        return {k: f[k] for k in f.files}
