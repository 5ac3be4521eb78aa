"""Serving: a prepared converter for many utterances (port of
``exemplars_vc_tpu/pipelines/serve.py``).

The dictionaries (DTW alignment, both speakers' conversion features, the
exemplar gather, the VTLP copies) are prepared once on the device; every
later utterance is features → activation solve → Y = H·B → synthesis
(Griffin-Lim, or the WORLD synthesizer on the WORLD path) on tensors that
are already there.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from exemplars_vc_tpu_torch.config import Config
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.dsp.griffin_lim import griffin_lim
from exemplars_vc_tpu_torch.factorize.nmf import convert_features
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav
from exemplars_vc_tpu_torch.obs.profiling import Timer
from exemplars_vc_tpu_torch.pipelines.conv_dicts import (
    extract_stft_complex,
    extract_world_features,
)
from exemplars_vc_tpu_torch.pipelines.convert import (
    _aligned_dicts,
    _convert_features_of,
    _preprocess_frames,
    _smooth_h,
    _solve_activations,
    world_synthesize,
)

log = logging.getLogger("exemplars_vc_tpu_torch")


@dataclass
class Converted:
    audio: np.ndarray
    sr: int
    nmf_iters: int
    nmf_error: float
    seconds: float


class Converter:
    """Hold the prepared exemplar dictionaries on the device; convert
    utterances.

    >>> conv = Converter(cfg, store, data_path)
    >>> result = conv.convert("utt.wav", out_path="out.wav")
    """

    def __init__(self, cfg: Config, store: ArtifactStore, data_path: str,
                 nb_file: int | None = None, *, device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        with Timer(self.device, fence=True) as t:
            dicts, self.kind = _aligned_dicts(cfg, store, data_path, nb_file, self.device)
            self.dicts = {name: (A.float().contiguous(), B.float().contiguous())
                          for name, (A, B) in dicts.items()}
        self.prepare_seconds = t.elapsed
        log.info("converter ready (%s, %d exemplars) in %.2fs", self.kind,
                 next(iter(self.dicts.values()))[0].shape[0], t.elapsed)

    def _features(self, x: np.ndarray):
        """(|S|, S): the magnitude feeds the solver, the complex STFT seeds
        Griffin-Lim when ``nmf.gl_init`` is "source" (else None)."""
        S = extract_stft_complex(x, self.cfg, self.device)
        return torch.abs(S), (S if self.cfg.nmf.gl_init == "source" else None)

    def _synthesize(self, Y: torch.Tensor, phase, length: int, synth_iters: int | None):
        m = self.cfg.mcep
        iters = synth_iters if synth_iters is not None else self.cfg.nmf.griffin_lim_iters
        return griffin_lim(Y, n_fft=m.frame_length, hop_length=m.hop_length, n_iter=iters,
                           length=length, init_phase=phase)

    def convert(self, wav_path: str, out_path: str | None = None,
                synth_iters: int | None = None) -> Converted:
        """Convert one utterance; ``seconds`` is the wall time from the
        features to the audio on the host. While a profiler records, the
        call is a ``convert`` span over ``features``, ``solve`` and
        ``synthesis`` (``obs.profiling``)."""
        x, sr = read_wav(wav_path)
        if self.kind != "stft":
            return self._convert_world(x, sr, out_path)
        with Timer(self.device, name="convert") as t:
            with Timer(self.device, name="features"):
                X, phase = self._features(x)
            A, B = self.dicts["stft"]
            with Timer(self.device, name="solve", residual=False):
                st = _solve_activations(X, A, self.cfg)
                Y = convert_features(st.H, B)
            with Timer(self.device, name="synthesis"):
                audio = self._synthesize(Y, phase, len(x), synth_iters).cpu().numpy()
            err = float(st.error)
        if out_path is not None:
            write_wav(out_path, audio, sr)
        return Converted(audio=audio, sr=sr, nmf_iters=st.n_iter, nmf_error=err,
                         seconds=t.elapsed)

    def _convert_world(self, x: np.ndarray, sr: int, out_path: str | None) -> Converted:
        """One WORLD conversion: analysis, the sp and ap solves (with the
        residual unless ``nmf.use_residual`` is "off"), the log-MV f0,
        synthesis."""
        residual = self.cfg.nmf.use_residual != "off"
        with Timer(self.device, name="convert") as t:
            with Timer(self.device, name="features"):
                feats = extract_world_features(x, self.cfg, self.device)
            with Timer(self.device, name="solve", residual=residual):
                converted, states = _convert_features_of(feats, self.dicts, self.cfg,
                                                         use_residual=residual)
            with Timer(self.device, name="synthesis"):
                audio = world_synthesize(converted, self.cfg, sr).cpu().numpy()
            err = sum(float(st.error) for st in states.values())
        if out_path is not None:
            write_wav(out_path, audio, sr)
        return Converted(audio=audio, sr=sr, nmf_iters=sum(st.n_iter for st in states.values()),
                         nmf_error=err, seconds=t.elapsed)

    def convert_batch(self, wav_paths: list[str], out_dir: str | None = None,
                      synth_iters: int | None = None) -> list[Converted]:
        """Convert many utterances with one activation solve.

        The fixed-dictionary updates are independent frame by frame, so one
        solve over the stacked (Σ F_i, D) frames equals the solves one by
        one, except that it stops where the stacked error says, at one
        n_iter for the whole batch. The mel projection and context stacking
        run per utterance before stacking, and the temporal box filter
        (``nmf.h_smooth``) per utterance slice after a solve without it, so
        nothing crosses an utterance boundary. Synthesis runs per utterance,
        seeded with its own phase. On the WORLD path the utterances are
        converted one by one, as in the reference."""
        if not wav_paths:
            return []
        if out_dir is not None:
            os.makedirs(out_dir, exist_ok=True)
        if self.kind != "stft":
            return [self.convert(p, out_path=(os.path.join(out_dir, os.path.basename(p))
                                              if out_dir is not None else None),
                                 synth_iters=synth_iters) for p in wav_paths]
        cfg = self.cfg
        sigs, mags, phases = [], [], []
        for p in wav_paths:
            x, sr = read_wav(p)
            sigs.append((x, sr))
            X, phase = self._features(x)
            mags.append(X)
            phases.append(phase)
        pre = cfg.nmf.context_frames > 0 or cfg.nmf.solve_domain == "mel"
        if pre:
            mags = [_preprocess_frames(X, cfg) for X in mags]
        bounds = np.concatenate([[0], np.cumsum([X.shape[0] for X in mags])]).tolist()
        with Timer(self.device) as t:
            A, B = self.dicts["stft"]
            solve_cfg = cfg
            if cfg.nmf.h_smooth > 0:
                solve_cfg = replace(cfg, nmf=replace(cfg.nmf, h_smooth=0))
            st = _solve_activations(torch.cat(mags, dim=0), A, solve_cfg, x_preprocessed=pre)
            H = st.H
            if cfg.nmf.h_smooth > 0:
                H = torch.cat([_smooth_h(H[lo:hi], cfg.nmf.h_smooth)
                               for lo, hi in zip(bounds[:-1], bounds[1:])], dim=0)
            Y_all = convert_features(H, B)
            err = float(st.error)
        solve_share = t.elapsed / len(wav_paths)
        results = []
        for (x, sr), p, phase, lo, hi in zip(sigs, wav_paths, phases, bounds[:-1], bounds[1:]):
            with Timer(self.device) as ts:
                audio = self._synthesize(Y_all[lo:hi], phase, len(x), synth_iters).cpu().numpy()
            if out_dir is not None:
                write_wav(os.path.join(out_dir, os.path.basename(p)), audio, sr)
            results.append(Converted(audio=audio, sr=sr, nmf_iters=st.n_iter, nmf_error=err,
                                     seconds=solve_share + ts.elapsed))
        return results
