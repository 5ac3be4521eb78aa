"""Entry ``separate``: ``separate_signal`` on one stereo recording a request,
the call the CLI's ``separate`` makes, at the fit settings the traffic
file's ``fit`` block states. A request is a two-talker mixture of the
in-repo speech; the answer is the J source images (J × C × T), flattened
source-major into one float32 array. The reference fits the same mixture
from the same start (:mod:`benchmark.reference.separate`)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from benchmark.harness import traffic
from benchmark.reference import separate as ref

LATENCY = "separate_p95_ms"


@dataclass
class Mixture:
    samples: np.ndarray     # (C, T) float32

    @property
    def seconds(self) -> float:
        return self.samples.shape[-1] / traffic.SR


def mixtures(params: dict, n: int, seed: int, stream: int) -> list[Mixture]:
    """n recordings of ``seconds`` each: talkers A and B cut from the joined
    in-repo speech at seeded offsets at least ``min_apart_seconds`` apart
    (around the joined speech's circle), A panned ``pan_a``, B panned
    ``pan_b`` and ``delay_samples`` late on the right, scaled to ``peak``."""
    speech = np.concatenate([traffic.read_pcm16(p) for p in traffic.speech_files()])
    speech = speech.astype(np.float64) / 32768.0
    T, L = int(params["seconds"] * traffic.SR), len(speech)
    apart = int(params["min_apart_seconds"] * traffic.SR)
    rng = np.random.default_rng([seed, stream])
    out = []
    for _ in range(n):
        a0 = int(rng.integers(L))
        b0 = (a0 + apart + int(rng.integers(L - 2 * apart + 1))) % L
        a, b = (speech[(o + np.arange(T)) % L] for o in (a0, b0))
        d = int(params["delay_samples"])
        b_late = np.concatenate([np.zeros(d), b[: T - d]])
        (al, ar), (bl, br) = params["pan_a"], params["pan_b"]
        x = np.stack([al * a + bl * b, ar * a + br * b_late])
        out.append(Mixture((params["peak"] / np.abs(x).max() * x).astype(np.float32)))
    return out


def requests(params: dict, settings: dict, seed: int, workdir: str, device):
    warm = mixtures(params, int(params["warmup"]), seed, 3)
    pool = mixtures(params, int(params["pool"]), seed, 2)
    return [[m] for m in warm], [[m] for m in pool]


class Driver:
    def __init__(self, cfg, store, data_path: str, params: dict, device):
        from exemplars_vc_tpu_torch.prng import PRNGKey
        from exemplars_vc_tpu_torch.separate import separate_signal

        fit = params["fit"]
        kw = dict(n_sources=fit["n_sources"], n_components=fit["n_components"],
                  n_em=fit["n_em"], n_fft=fit["n_fft"], hop_length=fit["hop_length"],
                  spectral_model=fit["spectral_model"], spatial_init=fit["spatial_init"])
        self.run = lambda x: separate_signal(x, key=PRNGKey(fit["key"]), device=device, **kw)
        self.prepare_s = 0.0

    def start(self):
        return self.call

    def call(self, mix: Mixture):
        images, _ = self.run(mix.samples)
        return images.reshape(-1).cpu().numpy(), None

    @staticmethod
    def audio_s(mix: Mixture) -> float:
        return mix.seconds


def reference(sessions: dict, settings: dict, params: dict, data_path: str, device, tf32: bool,
              built: dict) -> dict:
    with ref.precision(tf32):
        return {k: (ref.separate(mixes[0].samples, params["fit"], device)[0]
                    .reshape(-1).cpu().numpy(), None)
                for k, mixes in sessions.items()}
