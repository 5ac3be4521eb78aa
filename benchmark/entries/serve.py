"""Entry ``serve``: ``Converter.convert`` on one wav a request, on a
``Converter`` prepared in set-up. The requests are clips of the in-repo
speech written as wavs under the run's directory; the answer is the
converted audio. The reference converts the same clip with dictionaries of
its own (:mod:`benchmark.reference.convert`)."""

from __future__ import annotations

import os

import numpy as np

from benchmark.harness import traffic
from benchmark.reference import convert as ref

LATENCY = "convert_p95_ms"


def requests(params: dict, settings: dict, seed: int, workdir: str, device):
    warm, pool = traffic.clips(params, seed)
    os.makedirs(workdir, exist_ok=True)
    for tag, clips in (("warm", warm), ("req", pool)):
        for i, c in enumerate(clips):
            c.path = os.path.join(workdir, f"{tag}{i:05d}.wav")
            traffic.write_pcm16(c.path, c.samples)
    return [[c] for c in warm], [[c] for c in pool]


class Driver:
    def __init__(self, cfg, store, data_path: str, params: dict, device):
        from exemplars_vc_tpu_torch.pipelines.serve import Converter

        self.cfg, self.store, self.data_path, self.device = cfg, store, data_path, device
        self.converter = Converter(cfg, store, data_path, device=device)
        self.prepare_s = self.converter.prepare_seconds

    def start(self):
        return self.call

    def call(self, clip):
        out = self.converter.convert(clip.path)
        return out.audio, out.nmf_iters

    @staticmethod
    def audio_s(clip) -> float:
        return clip.seconds


def observe(driver: Driver, window, pool) -> dict:
    """The window's requests again through ``convert_utterance(...,
    sync_stages=True)`` on the dictionaries the converter prepared (memoised
    in the process): the program's fenced stage seconds and each solve's
    (F, K, D, n_iter)."""
    from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance

    cfg = driver.cfg
    residual = not cfg.data.use_stft and cfg.nmf.use_residual != "off"
    rows = []
    for r in window.records:
        clip = pool[r.index % len(pool)][0]
        out = convert_utterance(cfg, driver.store, driver.data_path, clip.path, sync_stages=True,
                                device=driver.device)
        rows.append({"timings": dict(out.timings), "residual": residual,
                     "solves": {k: list(v) for k, v in out.solves.items()}})
    return {"stages": rows}


def reference(sessions: dict, settings: dict, params: dict, data_path: str, device, tf32: bool,
              built: dict) -> dict:
    with ref.precision(tf32):
        if tf32 not in built:
            built[tf32] = ref.build_dictionaries(settings, data_path, device)
        return {k: ref.convert(clips[0].samples.astype(np.float64) / 32768.0, built[tf32],
                               settings, device)
                for k, clips in sessions.items()}
