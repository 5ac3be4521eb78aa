"""Streaming conversion in fixed-size frame chunks (port of
``exemplars_vc_tpu/pipelines/stream.py``).

With a fixed dictionary the MU update of activation row f uses only X[f] and
A, so a solve chunk by chunk reaches the batch solve's rows. Only synthesis
needs temporal context: Griffin-Lim runs on the chunk behind a left context
of frames already converted, and only the new region is emitted
(overlap-save), which keeps the phase coherent across seams.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from exemplars_vc_tpu_torch.config import Config
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.dsp.griffin_lim import griffin_lim
from exemplars_vc_tpu_torch.factorize.nmf import convert_features
from exemplars_vc_tpu_torch.obs.profiling import Timer
from exemplars_vc_tpu_torch.pipelines.convert import _solve_activations


class StreamingConverter:
    """Push frame chunks of |STFT| magnitudes, receive audio chunks.

    >>> sc = StreamingConverter(cfg, A, B, context_frames=32)
    >>> audio = sc.push(mag_chunk)       # chunk·hop samples a push
    >>> tail = sc.flush()
    """

    def __init__(self, cfg: Config, A, B, context_frames: int = 32, synth_iters: int = 60,
                 *, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        # chunked ≡ batch needs the deterministic float32 solve and no
        # coupling between frames in it: nmf.context_frames (a chunk's edges
        # would clamp where the batch's do not) and nmf.h_smooth are set to 0.
        # The row-independent levers (prune_topk, activation_power,
        # solve_domain) pass through.
        if (cfg.nmf.work_dtype != "float32" or cfg.nmf.context_frames != 0
                or cfg.nmf.h_smooth != 0):
            cfg = replace(cfg, nmf=replace(cfg.nmf, work_dtype="float32", context_frames=0,
                                           h_smooth=0))
        self.cfg = cfg
        self.A = torch.as_tensor(A, dtype=torch.float32, device=self.device).contiguous()
        self.B = torch.as_tensor(B, dtype=torch.float32, device=self.device).contiguous()
        self.context_frames = context_frames
        self.synth_iters = synth_iters
        self._context_mag: torch.Tensor | None = None     # converted left context
        self._context_phase: torch.Tensor | None = None   # its converged phase

    def _convert_block(self, X) -> torch.Tensor:
        """Converted magnitude of a chunk, on the device: synthesis takes it
        from there, so a push copies only the audio to the host."""
        X = torch.as_tensor(X, dtype=torch.float32, device=self.device)
        st = _solve_activations(X, self.A, self.cfg)
        return convert_features(st.H, self.B)

    def _synthesize(self, mag_new, phase_new=None) -> np.ndarray:
        m = self.cfg.mcep
        hop = m.hop_length
        mag_new = torch.as_tensor(mag_new, dtype=torch.float32, device=self.device)
        if self._context_mag is None:
            full, skip = mag_new, 0
        else:
            full = torch.cat([self._context_mag, mag_new], dim=0)
            skip = self._context_mag.shape[0]
        init_phase = None
        if phase_new is not None:
            # the chunk's own phase seeds its frames; the context frames take
            # the phase the previous push converged to, or unit phase where
            # the context length has changed since (it grows over the first
            # pushes; an unseeded push resets it)
            ph = torch.as_tensor(phase_new, device=self.device).to(torch.complex64)
            if skip:
                ctx_ph = self._context_phase
                if ctx_ph is None or ctx_ph.shape[0] != skip:
                    ctx_ph = torch.ones((skip, ph.shape[1]), dtype=torch.complex64,
                                        device=self.device)
                ph = torch.cat([ctx_ph, ph], dim=0)
            init_phase = ph
        y_full, final_phase = griffin_lim(
            full, n_fft=m.frame_length, hop_length=hop, n_iter=self.synth_iters,
            length=full.shape[0] * hop, init_phase=init_phase,
            return_phase=True)
        y = y_full.cpu().numpy()
        ctx = self.context_frames
        if ctx <= 0:
            self._context_mag = None
            self._context_phase = None
        else:
            self._context_mag = full[-ctx:] if full.shape[0] >= ctx else full
            # a context without a matching phase must not keep a stale seed
            self._context_phase = (final_phase[-self._context_mag.shape[0]:]
                                   if init_phase is not None else None)
        return y[skip * hop: (skip + mag_new.shape[0]) * hop]

    def push(self, mag_chunk, phase_chunk=None) -> np.ndarray:
        """(F_c, n_bins) source magnitudes → the audio samples of those frames.

        ``phase_chunk``: the complex STFT (or unit phases) of the source chunk
        on the same frame grid, which seeds Griffin-Lim instead of random
        phases. While a profiler records, the push is a ``push`` span over
        ``solve`` and ``synthesis`` (``obs.profiling``)."""
        with Timer(self.device, name="push"):
            with Timer(self.device, name="solve"):
                Y = self._convert_block(mag_chunk)
            with Timer(self.device, name="synthesis"):
                return self._synthesize(Y, phase_chunk)

    def flush(self) -> np.ndarray:
        """Nothing is buffered beyond the context; kept for API symmetry."""
        return np.zeros(0, dtype=np.float32)
