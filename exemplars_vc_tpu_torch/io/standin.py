"""A stand-in corpus built from the 16 kHz speech committed under
``artifacts/audio/``.

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
