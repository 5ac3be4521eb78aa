"""The tiny synthetic corpus of the port's conversion tests: 3 seeded
vowel-sequence pairs of ≤ 0.6 s and a held-out pair, written as wavs in the
layout ``load_speaker`` and ``heldout_pair`` expect. Imports no jax, so a
test of the port alone can use it."""

import os

import numpy as np
import torch

from exemplars_vc_tpu_torch.io.wav import write_wav

# The suite runs several worker processes on one host. At these sizes torch
# gains nothing from many threads, and a full OpenMP pool a worker spins
# against the other workers' (measured: 9× the time of a file run alone).
torch.set_num_threads(min(torch.get_num_threads(), 2))

SR = 16000
VOWELS = [(730, 1090), (270, 2290), (300, 870), (530, 1840), (640, 1190)]
OVERRIDES = ["data.tar=TF1", "misc.nb_file=3", "nmf.max_iter=20"]


def utterance(rng, order, f0, formant_scale, seg_s):
    """A sequence of vowels: harmonics of f0 weighted by two resonances."""
    out = []
    for v, dur in zip(order, seg_s):
        n = int(dur * SR)
        t = np.arange(n) / SR
        f1, f2 = (f * formant_scale for f in VOWELS[v])
        x = np.zeros(n)
        for k in range(1, int(4000 / f0)):
            fk = k * f0
            amp = 1.0 / (1 + ((fk - f1) / 90.0) ** 2) + 0.6 / (1 + ((fk - f2) / 120.0) ** 2)
            x += amp * np.sin(2 * np.pi * fk * t + rng.uniform(0, 2 * np.pi))
        out.append(x * np.hanning(n))
    x = np.concatenate(out)
    return (0.3 * x / np.abs(x).max() + 0.002 * rng.standard_normal(len(x))).astype(np.float32)


def write_synthetic_corpus(root) -> tuple[str, str, str]:
    """Write the corpus under ``root``; returns (data path, held-out source
    wav, held-out target wav)."""
    root = str(root)
    rng = np.random.default_rng(0)
    for spk in ("SF1", "TF1"):
        os.makedirs(os.path.join(root, "data", spk))
    os.makedirs(os.path.join(root, "wav"))
    for k in range(4):
        order = rng.permutation(5)[:4]
        seg = rng.uniform(0.09, 0.14, 4)
        src = utterance(rng, order, 120.0, 1.0, seg)
        tar = utterance(rng, order, 210.0, 1.15, seg * rng.uniform(0.85, 1.15, 4))
        if k < 3:
            write_wav(os.path.join(root, "data", "SF1", f"10000{k + 1}.wav"), src, SR)
            write_wav(os.path.join(root, "data", "TF1", f"10000{k + 1}.wav"), tar, SR)
        else:
            write_wav(os.path.join(root, "wav", "SF1_100162.wav"), src, SR)
            write_wav(os.path.join(root, "wav", "TF1_100162.wav"), tar, SR)
    return (os.path.join(root, "data"), os.path.join(root, "wav", "SF1_100162.wav"),
            os.path.join(root, "wav", "TF1_100162.wav"))


def rel_l2(a, b) -> float:
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


def assert_same_conversion(got, ref):
    """The port's ``ConversionResult`` against the JAX package's: converted
    magnitude and audio within 1e-3 relative L2, equal n_iter, MCD within
    0.05 dB."""
    Y, Yr = got.converted["stft"].numpy(), np.asarray(ref.converted["stft"])
    assert Y.shape == Yr.shape
    assert rel_l2(Y, Yr) < 1e-3
    assert got.audio.shape == ref.audio.shape and np.isfinite(got.audio).all()
    assert rel_l2(got.audio, ref.audio) < 1e-3
    assert got.n_iter == ref.n_iter
    assert abs(got.mcd_vs_reference - ref.mcd_vs_reference) < 0.05
