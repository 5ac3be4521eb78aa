"""Exemplar conversion of one utterance (port of
``exemplars_vc_tpu/pipelines/convert.py``).

1. build the exemplar dictionaries A (source) / B (target) along the DTW
   paths (:func:`_aligned_dicts`: hop divisor, alignment pruning, VTLP
   augmentation; memoised in the process),
2. solve the activations of each of the input's features over its A
   (:func:`_solve_activations`: mel domain, context stacking, unit-norm
   atoms, the configured solver, top-k refinement, sharpening, the temporal
   box filter): the |STFT| (``data.use_stft``, the default), or WORLD's sp
   and ap, with f0 mapped by :func:`convert_f0_logmv`,
3. convert Y = H·B (on the WORLD path times the residual R by default),
4. resynthesize: Griffin-Lim seeded with the input's own phase, or the
   WORLD synthesizer,
5. optionally score the DTW-aligned MCD against a reference utterance.

Every lever of both paths runs. ``nmf.solver=mu_sharded`` splits the
dictionary over the ranks of the process group (``parallel.sharded_nmf``);
every rank then converts the same utterance and returns the same result.
The entry points run on the card (``device="cuda"``) unless the caller
passes ``device="cpu"``; without a card the default raises.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field, replace

import numpy as np
import torch
import torch.distributed as dist

from exemplars_vc_tpu_torch.align.exemplar import (
    alignment_keep_mask,
    apply_keep_mask,
    build_exemplar_dicts_padded,
)
from exemplars_vc_tpu_torch.config import Config
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.dsp.griffin_lim import griffin_lim
from exemplars_vc_tpu_torch.dsp.mcep import mcep
from exemplars_vc_tpu_torch.dsp.mel import mel_filterbank
from exemplars_vc_tpu_torch.factorize.nmf import (
    NmfState,
    convert_features,
    nmf_activations,
    prune_topk_refine,
    residual_compensation,
    sharpen_activations,
)
from exemplars_vc_tpu_torch.factorize.qrmf import nnls_activations, qr_activations
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav
from exemplars_vc_tpu_torch.obs.metrics import mcd_aligned
from exemplars_vc_tpu_torch.obs.profiling import Timer
from exemplars_vc_tpu_torch.parallel.distributed import world_size
from exemplars_vc_tpu_torch.parallel.mesh import make_mesh
from exemplars_vc_tpu_torch.parallel.sharded_nmf import (
    gather_activations,
    sharded_nmf_activations,
)
from exemplars_vc_tpu_torch.pipelines.conv_dicts import (
    build_conversion_dicts_pair,
    extract_stft_complex,
    extract_world_features,
)
from exemplars_vc_tpu_torch.pipelines.make_dict import make_dictionary
from exemplars_vc_tpu_torch.world.synthesis import synthesize

log = logging.getLogger("exemplars_vc_tpu_torch")


@dataclass
class ConversionResult:
    audio: np.ndarray
    sr: int
    converted: dict[str, torch.Tensor]   # device tensors; .cpu() on demand
    n_iter: int
    nmf_error: float
    timings: dict[str, float] = field(default_factory=dict)
    mcd_vs_reference: float | None = None
    nmf_shape: tuple[int, int, int] = (0, 0, 0)   # (F, K, D) of the first solve
    # each solve by feature name: (F, K, D, n_iter)
    solves: dict[str, tuple[int, int, int, int]] = field(default_factory=dict)


def mcd_between_signals(a: np.ndarray, b: np.ndarray, cfg: Config,
                        device: str | torch.device = "cuda") -> float:
    """DTW-aligned mel-cepstral distortion (dB) between two waveforms."""
    device = resolve_device(device)
    m = cfg.mcep
    ca, cb = (mcep(torch.as_tensor(np.asarray(s, np.float32), device=device),
                   frame_length=m.frame_length, hop_length=m.hop_length,
                   order=m.order, alpha=m.alpha) for s in (a, b))
    return float(mcd_aligned(ca, cb))


def _stack_context(M: torch.Tensor, c: int) -> torch.Tensor:
    """(N, D) → (N, D·(2c+1)): the edge-clamped ±c neighbour rows side by
    side, row n = [M[n−c]; …; M[n]; …; M[n+c]] (multi-frame exemplars)."""
    if c <= 0:
        return M
    N = M.shape[0]
    base = torch.arange(N, device=M.device)
    return torch.cat([M[(base + s).clamp(0, N - 1)] for s in range(-c, c + 1)], dim=1)


def _solve_mel_matrix(d_feat: int, cfg: Config, device: torch.device) -> torch.Tensor:
    """Mel filterbank of the activation solve; the STFT grid follows from
    the bin count (the conversion H·B stays at full resolution)."""
    return torch.as_tensor(mel_filterbank(cfg.data.sr, 2 * (d_feat - 1),
                                          n_mels=cfg.nmf.solve_mels), device=device)


def _preprocess_frames(X: torch.Tensor, cfg: Config) -> torch.Tensor:
    """What :func:`_solve_activations` does to the input's frames before the
    solve: the mel projection (``nmf.solve_domain='mel'``), then context
    stacking (``nmf.context_frames``). ``serve.convert_batch`` runs it per
    utterance before it stacks the frames, so the stacked solve mixes
    nothing across an utterance boundary."""
    if cfg.nmf.solve_domain == "mel" and X.shape[1] > cfg.nmf.solve_mels:
        X = X @ _solve_mel_matrix(X.shape[1], cfg, X.device).T
    return _stack_context(X, cfg.nmf.context_frames)


def _smooth_h(H: torch.Tensor, s: int) -> torch.Tensor:
    """Edge-clamped box filter of width 2s + 1 along time (``nmf.h_smooth``),
    in the ``h_smooth`` span (F, K and s)."""
    if s <= 0:
        return H
    F = H.shape[0]
    with Timer(H.device, name="h_smooth", F=F, K=H.shape[1], s=s):
        # the rows d = -s … s added in that order into one buffer through one
        # more: two F × K allocations, where a sum of gathers makes 2s + 2
        base = torch.arange(F, device=H.device)
        out = H.index_select(0, (base - s).clamp(0, F - 1))
        row = torch.empty_like(H)
        for d in range(-s + 1, s + 1):
            out.add_(torch.index_select(H, 0, (base + d).clamp(0, F - 1), out=row))
        return out.div_(2 * s + 1)


def _solve_activations(X: torch.Tensor, A: torch.Tensor, cfg: Config,
                       x_preprocessed: bool = False) -> NmfState:
    """The activation solve with every lever of ``cfg.nmf``.

    ``nmf.solve_domain='mel'`` and ``nmf.context_frames`` change X and A
    before the solve; H keeps its (frames, K) shape, so Y = H·B is untouched.
    ``x_preprocessed=True``: the caller already ran
    :func:`_preprocess_frames` on X; A still gets both steps here, gated on
    its own width. ``nmf.normalize_exemplars`` solves on unit-L2 atoms and
    returns H in the unnormalised basis. After the solve:
    ``nmf.prune_topk``, ``nmf.activation_power``, ``nmf.h_smooth``. The
    solver runs in the ``nmf`` span (F, K, D and n_iter of the solve, and
    ``beta``, the loss it minimised: "kl" or "frobenius")."""
    n = cfg.nmf
    c = n.context_frames
    if n.solve_domain == "mel" and A.shape[1] > n.solve_mels:
        M = _solve_mel_matrix(A.shape[1], cfg, A.device)
        if not x_preprocessed:
            X = X @ M.T
        A = A @ M.T
    if c > 0:
        if not x_preprocessed:
            X = _stack_context(X, c)
        A = _stack_context(A, c)
    A_solve = A
    if n.normalize_exemplars:
        # X ≈ H'·(A/s) = (H'/s)·A. A zero padding row stays zero in A/s, its
        # numerator column is 0, and its H column is 0 after the first step
        s = torch.clamp(torch.sqrt(torch.sum(A * A, dim=1)), min=1e-12)
        A_solve = A / s[:, None]
    kl = n.solver in ("auto", "mu") and n.beta_loss in ("kullback-leibler", "kl")
    with Timer(X.device, name="nmf", F=X.shape[0], K=A.shape[0], D=A.shape[1],
               beta="kl" if kl else "frobenius") as t:
        st = _dispatch_solver(X, A_solve, cfg)
        t.attrs["n_iter"] = st.n_iter
    if n.normalize_exemplars:
        st = NmfState(st.H / s[None, :], st.n_iter, st.error)
    if n.prune_topk > 0:
        beta = n.beta_loss if n.solver in ("auto", "mu", "mu_pallas") else "frobenius"
        st = prune_topk_refine(X, A, st.H, k=n.prune_topk, beta_loss=beta,
                               n_iter=n.prune_iters)
    if n.activation_power != 1.0:
        # the error stays the solver's: the refit gain keeps the fit comparable
        st = NmfState(sharpen_activations(st.H, A, X, n.activation_power), st.n_iter, st.error)
    if n.h_smooth > 0:
        st = NmfState(_smooth_h(st.H, n.h_smooth), st.n_iter, st.error)
    return st


def _dispatch_solver(X: torch.Tensor, A: torch.Tensor, cfg: Config) -> NmfState:
    """``nmf.solver``: ``auto``/``mu`` the sklearn-parity MU (on the card the
    float32 Frobenius update runs the recon/update kernels; ``work_dtype``
    other than float32 is the plain-torch bfloat16 solve); ``mu_pallas`` the
    same MU as the reference's Pallas solver runs it, which takes neither
    ``beta_loss`` nor ``sparsity_l1``: Frobenius without l1; ``mu_sharded``
    that solve with the dictionary split over the process group's ranks
    (:func:`_sharded_solve`); ``cd``/``nnls`` FISTA NNLS; ``qr``/``qrmf``
    the unconstrained solve clamped at 0."""
    n = cfg.nmf
    solver = "mu" if n.solver == "auto" else n.solver
    if solver == "mu":
        work = None if n.work_dtype == "float32" else getattr(torch, n.work_dtype)
        return nmf_activations(X, A, beta_loss=n.beta_loss, tol=n.tol, max_iter=n.max_iter,
                               l1=n.sparsity_l1, work_dtype=work)
    if solver == "mu_pallas":
        return nmf_activations(X, A, tol=n.tol, max_iter=n.max_iter)
    if solver == "mu_sharded":
        return _sharded_solve(X, A, cfg)
    if solver in ("cd", "nnls"):
        # a sklearn cd "iteration" is a sweep over all K coordinates; its
        # objective takes ~10× as many FISTA steps
        n_iter = n.nnls_iters or 10 * max(n.max_iter, 20)
        H = nnls_activations(X, A, n_iter=n_iter)
        return NmfState(H, n_iter, torch.linalg.norm(X - H @ A))
    if solver in ("qr", "qrmf"):
        H = torch.clamp(qr_activations(X, A), min=0.0)
        return NmfState(H, 1, torch.linalg.norm(X - H @ A))
    raise ValueError(f"unknown nmf solver {solver!r}")


def _sharded_solve(X: torch.Tensor, A: torch.Tensor, cfg: Config) -> NmfState:
    """The Frobenius MU solve (no l1, as in the JAX package) with A and H
    split over a ``dict`` axis of every rank of the default process group
    (one rank without a group), shrunk to a divisor of K. Every rank calls
    it with the same X and A on its own device and gets the whole H, n_iter
    and error: the shards are all-gathered, and a rank outside a shrunk axis
    takes no shard and receives them from rank 0."""
    K = A.shape[0]
    world = world_size()
    n = world
    while K % n:          # the shard count must divide K (padded to 512s,
        n -= 1            # so this is for tiny dictionaries)
    mesh = make_mesh(data=1, dict_=n)
    if mesh.coordinate() is not None:
        st = sharded_nmf_activations(X, A, mesh, tol=cfg.nmf.tol, max_iter=cfg.nmf.max_iter)
        H = gather_activations(st.H, mesh)
        stats = torch.stack([st.error.float(), torch.tensor(float(st.n_iter), device=X.device)])
    else:
        H = torch.empty((X.shape[0], K), dtype=torch.float32, device=X.device)
        stats = torch.empty(2, dtype=torch.float32, device=X.device)
    if n < world:
        dist.broadcast(H, src=0)
        dist.broadcast(stats, src=0)
    return NmfState(H, int(stats[1]), stats[0])


def convert_f0_logmv(f0: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Source f0 (T, 1) → target f0 by a log-domain mean-variance
    transform: lf0_tar = (lf0_src − μ_src)·(σ_tar/σ_src) + μ_tar on voiced
    frames (unvoiced stays exactly 0), μ and σ over the voiced rows of the
    aligned f0 dictionaries A (source) and B (target); their zero padding
    rows are unvoiced, so they drop out."""
    def stats(M):
        v = M[:, 0]
        mask = v > 0
        n = torch.clamp(mask.sum(), min=1)
        lf = torch.where(mask, torch.log(torch.clamp(v, min=1e-6)), torch.zeros_like(v))
        mu = lf.sum() / n
        var = torch.where(mask, (lf - mu) ** 2, torch.zeros_like(v)).sum() / n
        return mu, torch.sqrt(torch.clamp(var, min=1e-12))

    mu_s, sd_s = stats(A)
    mu_t, sd_t = stats(B)
    out = torch.exp((torch.log(torch.clamp(f0, min=1e-6)) - mu_s) * (sd_t / sd_s) + mu_t)
    return torch.where(f0 > 0, out, torch.zeros_like(out))


def _convert_features_of(X: dict, dicts: dict, cfg: Config, use_residual: bool):
    """Solve and convert each input feature {name: (F, D)} over its
    dictionary pair: f0 by :func:`convert_f0_logmv` (``world.f0_transform``
    "logmv"), sp in the magnitude domain where ``world.sp_domain`` says so
    (solved on √sp, the conversion squared back), the residual R on where
    ``use_residual``. Returns ({name: Y}, {name: NmfState})."""
    converted, states = {}, {}
    for name, Xn in X.items():
        A, B = dicts[name]
        if name == "f0" and cfg.world.f0_transform == "logmv":
            converted[name] = convert_f0_logmv(Xn, A, B)
            continue
        sp_mag = name == "sp" and cfg.world.sp_domain == "magnitude"
        if sp_mag:
            Xn, A, B = torch.sqrt(Xn), torch.sqrt(A), torch.sqrt(B)
        st = _solve_activations(Xn, A, cfg)
        R = (residual_compensation(Xn, st.H, A, mode=cfg.nmf.residual_mode)
             if use_residual else None)
        Y = convert_features(st.H, B, R)
        converted[name] = Y * Y if sp_mag else Y
        states[name] = st
    return converted, states


def world_synthesize(converted: dict, cfg: Config, sr: int) -> torch.Tensor:
    """The WORLD synthesizer on converted {"f0": (F, 1), "sp", "ap"}."""
    return synthesize(converted["f0"][:, 0], converted["sp"], converted["ap"], sr=sr,
                      frame_period_ms=cfg.world.frame_period_ms, fft_size=cfg.world.fft_size)


def _vtlp_matrix(D: int, alpha: float, dtype: torch.dtype, device: torch.device):
    """Source bins lo, hi and weight w of the linear warp f → α·f on D bins
    (edges clamped), and the (D, D) interpolation operator P with
    M·P = warp_α(M); lo and hi coincide at the clamped top edge, where their
    weights add."""
    cols = torch.arange(D, device=device)
    src = torch.clamp(cols.to(torch.float32) / alpha, 0.0, D - 1.0)
    lo = torch.floor(src).long()
    hi = torch.clamp(lo + 1, max=D - 1)
    w = (src - lo).to(dtype)
    P = torch.zeros((D, D), dtype=dtype, device=device)
    P.index_put_((lo, cols), 1.0 - w, accumulate=True)
    P.index_put_((hi, cols), w, accumulate=True)
    return lo, hi, w, P


def _vtlp_warp(M: torch.Tensor, alpha: float) -> torch.Tensor:
    """VTLP warp of magnitude rows (N, D): bin content moves from f to α·f
    by linear interpolation (α < 1 a longer vocal tract, α > 1 a shorter)."""
    lo, hi, w, _ = _vtlp_matrix(M.shape[1], alpha, M.dtype, M.device)
    return M[:, lo] * (1.0 - w) + M[:, hi] * w


def _vtlp_expand_pair(A: torch.Tensor, B: torch.Tensor, warps: tuple[float, ...]):
    """[A; warp_α1(A); …] and the same for B: each warp is a (D, D) operator,
    so the expansion is one batched product over the stacked pair."""
    K, D = A.shape
    mats = [torch.eye(D, dtype=A.dtype, device=A.device)]
    mats += [_vtlp_matrix(D, a, A.dtype, A.device)[3] for a in warps]
    out = torch.einsum("skd,wde->swke", torch.stack([A, B]), torch.stack(mats))
    return out[0].reshape((1 + len(warps)) * K, D), out[1].reshape((1 + len(warps)) * K, D)


def _tile_pair(A: torch.Tensor, B: torch.Tensor, n: int):
    return torch.cat([A] * n), torch.cat([B] * n)


def _augment_dicts(dicts: dict, warps: tuple[float, ...]) -> dict:
    """Append frequency-warped copies of every spectral exemplar pair, source
    and target warped by the same α. f0 rows (and any feature narrower than
    8 bins) are tiled unwarped, so every feature keeps the same row count."""
    out = {}
    for name, (A, B) in dicts.items():
        if name == "f0" or A.shape[1] < 8:
            out[name] = _tile_pair(A, B, 1 + len(warps))
        else:
            out[name] = _vtlp_expand_pair(A, B, warps)
    return out


def _parse_warps(spec: str) -> tuple[float, ...]:
    if not spec:
        return ()
    return tuple(float(w) for w in spec.split(",") if w.strip())


# Prepared dictionaries of this process, on their device: repeated
# conversions would otherwise load the stored paths, recompute both |STFT|
# batches and gather the same matrices on every call. Keyed by everything
# that determines the dictionaries, and the device; bounded, first in first
# out.
_DICTS_MEMO: dict = {}
_DICTS_MEMO_MAX = 8


def _aligned_dicts(cfg: Config, store: ArtifactStore, data_path: str,
                   nb_file: int | None, device: torch.device):
    """Exemplar dictionaries {name: (A, B)} gathered along the DTW paths, K
    padded with zero rows to a multiple of 512, and the feature kind.

    ``data.dict_hop_divisor > 1`` builds only the dictionary side (alignment
    and features) at hop ÷ divisor; ``data.dict_prune_frac`` zeroes the
    worst-aligned pairs; ``data.dict_augment_warps`` appends VTLP-warped
    copies (in the ``dict.augment`` span: the K they make, the warps). A
    repeated call with the same arguments returns the memoised
    tensors; ``_aligned_dicts.builds`` counts the calls that built."""
    # cfg.misc is part of the key: with nb_file=None the file count comes
    # from cfg.misc.nb_file, and misc.cpu_rate changes the loaded audio
    device = torch.device(device)
    memo_key = (store.root, data_path, nb_file, repr(cfg.data), repr(cfg.mcep),
                repr(cfg.world), repr(cfg.misc), str(device))
    hit = _DICTS_MEMO.get(memo_key)
    if hit is not None:
        return hit

    div = cfg.data.dict_hop_divisor
    dcfg = cfg
    if div > 1:
        dcfg = replace(cfg,
                       mcep=replace(cfg.mcep, hop_length=max(cfg.mcep.hop_length // div, 1)),
                       world=replace(cfg.world,
                                     frame_period_ms=cfg.world.frame_period_ms / div))
    art = make_dictionary(dcfg, store, data_path, nb_file=nb_file, device=device)
    src_feats, tar_feats = build_conversion_dicts_pair(
        dcfg, store, data_path, cfg.data.src, cfg.data.tar, nb_file=nb_file, device=device)
    k_true = int(art.path_len.sum())        # on the host already
    k_pad = ((k_true + 511) // 512) * 512
    keep = None
    if cfg.data.dict_prune_frac > 0:
        keep = alignment_keep_mask(art.feat_a, art.feat_b, art.path_i, art.path_j,
                                   k_pad=k_pad, k_true=k_true,
                                   prune_frac=float(cfg.data.dict_prune_frac))
    dicts = {}
    for name in src_feats.feats:
        A, B = build_exemplar_dicts_padded(src_feats.feats[name], tar_feats.feats[name],
                                           art.path_i, art.path_j, k_pad=k_pad)
        if keep is not None:
            A, B = apply_keep_mask(A, keep), apply_keep_mask(B, keep)
        dicts[name] = (A, B)
    warps = _parse_warps(cfg.data.dict_augment_warps)
    if warps:
        with Timer(device, name="dict.augment", K=(1 + len(warps)) * k_pad, warps=warps):
            dicts = _augment_dicts(dicts, warps)
    if len(_DICTS_MEMO) >= _DICTS_MEMO_MAX:
        _DICTS_MEMO.pop(next(iter(_DICTS_MEMO)))
    _DICTS_MEMO[memo_key] = (dicts, src_feats.kind)
    _aligned_dicts.builds += 1
    return dicts, src_feats.kind


_aligned_dicts.builds = 0


def convert_utterance(cfg: Config, store: ArtifactStore, data_path: str, wav_path: str,
                      out_path: str | None = None, nb_file: int | None = None,
                      use_residual: bool | None = None, synth_iters: int | None = None,
                      reference_wav: str | None = None, sync_stages: bool = False,
                      *, device: str | torch.device = "cuda") -> ConversionResult:
    """Convert one utterance on ``device`` (see the module docstring).

    ``use_residual`` defaults to the reference's rule: the residual
    compensation on the WORLD path unless ``nmf.use_residual`` is "off",
    never on the STFT path. ``sync_stages=True`` fences the device around
    each stage so the timings ("dicts", "features", "nmf_solve",
    "synthesis") are device times; otherwise a stage's queued work may
    drain inside a later one. While a profiler records, the last three are
    the spans ``features``, ``solve`` and ``synthesis`` (``obs.profiling``)."""
    device = resolve_device(device)
    timings: dict[str, float] = {}
    m = cfg.mcep

    with Timer(device, sync_stages) as t:
        dicts, kind = _aligned_dicts(cfg, store, data_path, nb_file, device)
    timings["dicts"] = t.elapsed

    x, sr = read_wav(wav_path)
    if use_residual is None:
        use_residual = kind == "world" and cfg.nmf.use_residual != "off"
    with Timer(device, sync_stages, name="features") as t:
        if kind == "stft":
            S_in = extract_stft_complex(x, cfg, device)
            feats = {"stft": torch.abs(S_in)}
        else:
            feats = extract_world_features(x, cfg, device)
    timings["features"] = t.elapsed

    with Timer(device, sync_stages, name="solve", residual=use_residual) as t:
        converted, states = _convert_features_of(feats, dicts, cfg, use_residual)
    timings["nmf_solve"] = t.elapsed
    solves = {}
    for name, st in states.items():
        F, D = feats[name].shape
        K = dicts[name][0].shape[0]
        solves[name] = (F, K, D, st.n_iter)
        log.info("NMF[%s]: F=%d K=%d D=%d iters=%d err=%.3g", name, F, K, D, st.n_iter,
                 float(st.error))

    with Timer(device, sync_stages, name="synthesis") as t:
        if kind == "stft":
            Y = converted["stft"]
            iters = synth_iters if synth_iters is not None else cfg.nmf.griffin_lim_iters
            if cfg.nmf.gl_init == "source":
                y = griffin_lim(Y, n_fft=m.frame_length, hop_length=m.hop_length,
                                n_iter=iters, length=len(x), init_phase=S_in)
            else:
                y = griffin_lim(Y, n_fft=m.frame_length, hop_length=m.hop_length,
                                n_iter=iters, length=len(x))
        else:
            y = world_synthesize(converted, cfg, sr)
        audio = y.cpu().numpy()
    timings["synthesis"] = t.elapsed

    if out_path is not None:
        write_wav(out_path, audio, sr)
    mcd_val = None
    if reference_wav is not None:
        ref_sig, _ = read_wav(reference_wav)
        mcd_val = mcd_between_signals(audio, ref_sig, cfg, device)
        log.info("MCD vs %s: %.2f dB", reference_wav, mcd_val)

    return ConversionResult(audio=audio, sr=sr, converted=converted,
                            n_iter=sum(st.n_iter for st in states.values()),
                            nmf_error=sum(float(st.error) for st in states.values()),
                            timings=timings, mcd_vs_reference=mcd_val,
                            nmf_shape=next(iter(solves.values()))[:3], solves=solves)
