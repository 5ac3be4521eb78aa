"""The one generator of the benchmark's traffic, driven by a traffic file.

Every seed gets the same set of request lengths, in another order: the
lengths are the ``lengths_per_block`` quantiles of a log-uniform law on
[``min_seconds``, ``max_seconds``], and each block of requests holds every
one of them once, as pairs of a short and a long one (quantile i beside
quantile M−1−i) in a seeded order, so any prefix of the run carries about
the mean length. What the seed draws is the order and the speech: each clip
is cut from the in-repo 16 kHz speech at a seeded offset, joined across
files where it runs past one.

What a clip becomes, a wav file a request or a stream's chunks, is the
business of the entry the traffic file names (``benchmark/entries``).
"""

from __future__ import annotations

import math
import os
import wave
from dataclasses import dataclass

import numpy as np

from benchmark.harness.spec import BENCH_DIR

SPEECH_DIR = BENCH_DIR / "speech"
SR = 16000


def read_pcm16(path) -> np.ndarray:
    with wave.open(os.fspath(path), "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1 or w.getframerate() != SR:
            raise ValueError(f"{path}: expected mono 16 kHz PCM16")
        return np.frombuffer(w.readframes(w.getnframes()), dtype="<i2").copy()


def write_pcm16(path, samples: np.ndarray) -> None:
    with wave.open(os.fspath(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes(samples.astype("<i2").tobytes())


def speech_files() -> list:
    """The 44 renderings of VCC utterances under ``benchmark/speech`` (a copy
    of ``artifacts/audio``, kept with the benchmark so that its inputs change
    only with it), in a fixed order."""
    return sorted(SPEECH_DIR.glob("*.wav")) + sorted((SPEECH_DIR / "loo").glob("*.wav"))


def block_lengths(params: dict) -> list[int]:
    """The quantile lengths of one block, in samples, paired short with long."""
    m = int(params["lengths_per_block"])
    lo, hi = math.log(params["min_seconds"]), math.log(params["max_seconds"])
    q = [int(round(SR * math.exp(lo + (i + 0.5) / m * (hi - lo)))) for i in range(m)]
    return [q[i // 2] if i % 2 == 0 else q[m - 1 - i // 2] for i in range(m)]


def request_lengths(params: dict, seed: int, n: int) -> list[int]:
    """n lengths: whole blocks, each its pairs in a seeded order."""
    base = block_lengths(params)
    pairs = [base[k: k + 2] for k in range(0, len(base), 2)]
    rng = np.random.default_rng([seed, 1])
    out = []
    while len(out) < n:
        for p in rng.permutation(len(pairs)):
            out.extend(pairs[p][:: 1 if rng.integers(2) else -1])
    return out[:n]


@dataclass
class Clip:
    samples: np.ndarray     # int16
    path: str | None = None

    @property
    def seconds(self) -> float:
        return len(self.samples) / SR


def cut_clips(lengths: list[int], seed: int, stream: int) -> list[Clip]:
    """One clip a length, from seeded offsets into the joined speech."""
    speech = np.concatenate([read_pcm16(p) for p in speech_files()])
    offsets = np.random.default_rng([seed, stream]).integers(0, len(speech), size=len(lengths))
    clips = []
    for off, n in zip(offsets, lengths):
        idx = (int(off) + np.arange(n)) % len(speech)
        clips.append(Clip(speech[idx]))
    return clips


def clips(params: dict, seed: int) -> tuple[list[Clip], list[Clip]]:
    """(warm-up clips, the pool of timed clips): the pool holds ``pool``
    clips; the warm-up takes the shortest, a middle and the longest length
    of the set, cut from a stream of offsets of their own."""
    pool = cut_clips(request_lengths(params, seed, int(params["pool"])), seed, 2)
    base = sorted(block_lengths(params))
    warm_lengths = [base[0], base[len(base) // 2], base[-1]][: int(params["warmup"])]
    return cut_clips(warm_lengths, seed, 3), pool
