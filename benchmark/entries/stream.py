"""Entry ``stream``: live sessions back to back. A session is one clip of
the in-repo speech, cut into ``chunk_frames`` chunks of its magnitude and
complex STFT in set-up, and fed push by push to a fresh
``StreamingConverter`` built from the dictionaries a ``Converter``
prepared; each push is one timed call, its answer the pushed audio. The
reference streams the same chunks with dictionaries of its own
(:func:`benchmark.reference.convert.stream`)."""

from __future__ import annotations

import numpy as np

from benchmark.harness import traffic
from benchmark.reference import convert as ref
from benchmark.reference import dsp

LATENCY = "push_p95_ms"


def session_chunks(clip, params: dict, settings: dict, device) -> list:
    """A clip's magnitude and complex STFT (the signal zero-padded to the
    frame bucket), in whole chunks of ``chunk_frames``, as host arrays."""
    import torch

    hop, n_fft = settings["mcep.hop_length"], settings["mcep.frame_length"]
    step = hop * settings["data.frame_bucket"]
    x = clip.samples.astype(np.float64) / 32768.0
    padded = np.zeros(((len(x) + step - 1) // step) * step, np.float32)
    padded[: len(x)] = x
    S = dsp.stft(torch.as_tensor(padded, device=device), n_fft=n_fft, hop_length=hop)
    c = int(params["chunk_frames"])
    n = (1 + len(x) // hop) // c * c
    S = S[:n].cpu()
    mag = torch.abs(S).numpy()
    S = S.numpy()
    return [(mag[k: k + c], S[k: k + c]) for k in range(0, n, c)]


def requests(params: dict, settings: dict, seed: int, workdir: str, device):
    warm, pool = traffic.clips(params, seed)
    return ([session_chunks(c, params, settings, device) for c in warm],
            [session_chunks(c, params, settings, device) for c in pool])


class Driver:
    def __init__(self, cfg, store, data_path: str, params: dict, device):
        from exemplars_vc_tpu_torch.pipelines.serve import Converter

        converter = Converter(cfg, store, data_path, device=device)
        self.prepare_s = converter.prepare_seconds
        self.A, self.B = converter.dicts["stft"]
        self.cfg, self.params, self.device = cfg, params, device
        self.chunk_s = (params["chunk_frames"] * cfg.mcep.hop_length) / cfg.data.sr

    def start(self):
        from exemplars_vc_tpu_torch.pipelines.stream import StreamingConverter

        sc = StreamingConverter(self.cfg, self.A, self.B,
                                context_frames=int(self.params["context_frames"]),
                                synth_iters=int(self.params["synth_iters"]), device=self.device)
        return lambda chunk: (sc.push(*chunk), None)

    def audio_s(self, chunk) -> float:
        return self.chunk_s


def reference(sessions: dict, settings: dict, params: dict, data_path: str, device, tf32: bool,
              built: dict) -> dict:
    with ref.precision(tf32):
        if tf32 not in built:
            built[tf32] = ref.build_dictionaries(settings, data_path, device)
        out = {}
        for k, chunks in sessions.items():
            ys, steps = ref.stream(chunks, built[tf32], settings, device,
                                   int(params["context_frames"]), int(params["synth_iters"]))
            out[k] = np.concatenate(ys), steps
        return out
