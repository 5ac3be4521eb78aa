"""The plain reference of one exemplar conversion, written for the benchmark.

It follows the published method (Wu et al.'s exemplar NMF, as the upstream
scripts run it) with the settings of a configuration file under
``benchmark/configs/`` and nothing else:

1. the parallel dictionary: MFCC of both speakers' utterances, a DTW of each
   pair (the classic recurrence, ties to the diagonal, then up, then left),
   the exemplar rows gathered along the paths, zero rows up to a multiple of
   512;
2. the conversion features: |STFT| (``data.use_stft``), or WORLD's sp, ap and
   f0 (DIO, StoneMask, CheapTrick, D4C on a frozen copy of the port's plain
   WORLD code under ``reference/world``);
3. the fixed-dictionary MU solve of sklearn's ``non_negative_factorization``
   (Frobenius, H0 = sqrt(mean(X)/K), the error checked every 10 iterations,
   stop when the drop is under tol times the first error);
4. Y = H·B, on the WORLD path times the residual X / (H·A), f0 by the
   log-domain mean-variance transform;
5. fast Griffin-Lim (momentum 0.9) seeded with the source phase, or the WORLD
   synthesizer; for a stream, Griffin-Lim over each chunk behind the
   converted left context, emitting the chunk's samples (overlap-save).

Everything is float32 torch on the given device, with TF32 off unless the
caller asks for it (:func:`precision`): the control of the benchmark's
comparison. It reads the wavs itself and takes nothing the program made.
"""

from __future__ import annotations

import contextlib
import os
import wave

import numpy as np
import torch

from benchmark.reference import dsp
from benchmark.reference.world.analysis import analyze
from benchmark.reference.world.synthesis import synthesize

EPS = 2.220446049250313e-16          # sklearn's guard on a zero denominator
BIG = np.float32(1e30)
CHECK_EVERY = 10

# the settings this reference implements; any other value of these keys is
# a path it does not have, and it refuses the configuration
PLAIN = {"nmf.solver": "auto", "nmf.beta_loss": "frobenius", "nmf.sparsity_l1": 0.0,
         "nmf.work_dtype": "float32", "nmf.prune_topk": 0, "nmf.activation_power": 1.0,
         "nmf.h_smooth": 0, "nmf.solve_domain": "linear", "nmf.context_frames": 0,
         "nmf.normalize_exemplars": False, "nmf.gl_init": "source",
         "nmf.residual_mode": "correct", "data.dict_hop_divisor": 1,
         "data.dict_augment_warps": "", "data.dict_prune_frac": 0.0,
         "world.f0_transform": "logmv", "world.sp_domain": "power", "world.f0_method": "dio",
         "mcep.window": "hann"}


def check_plain(settings: dict) -> None:
    for key, want in PLAIN.items():
        if key in settings and settings[key] != want:
            raise ValueError(f"the reference has no path for {key}={settings[key]!r}")


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls and convolutions, in TF32 where ``tf32`` (the control)."""
    keep = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = keep


def read_wav(path: str) -> np.ndarray:
    """A mono PCM16 wav as float64 samples in [-1, 1)."""
    with wave.open(path, "rb") as w:
        if w.getsampwidth() != 2 or w.getnchannels() != 1:
            raise ValueError(f"{path}: the reference reads mono PCM16 only")
        raw = w.readframes(w.getnframes())
    return np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0


def speaker_wavs(data_path: str, speaker: str, nb: int) -> list[np.ndarray]:
    d = os.path.join(data_path, speaker)
    names = sorted(n for n in os.listdir(d) if n.lower().endswith(".wav"))[:nb]
    return [read_wav(os.path.join(d, n)) for n in names]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def pad_batch(sigs: list[np.ndarray], step: int) -> np.ndarray:
    """Zero-padded (N, T) float32, T the longest length rounded up to ``step``."""
    out = np.zeros((len(sigs), _round_up(max(len(s) for s in sigs), step)), np.float32)
    for i, s in enumerate(sigs):
        out[i, : len(s)] = s
    return out


def fit_frames(feats: torch.Tensor, t_pad: int, lens) -> torch.Tensor:
    """(N, T, D) cut or zero-padded to t_pad frames, rows at and past each length zeroed."""
    if feats.shape[1] >= t_pad:
        feats = feats[:, :t_pad]
    else:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, t_pad - feats.shape[1]))
    lens = torch.as_tensor(np.asarray(lens), device=feats.device)
    keep = torch.arange(t_pad, device=feats.device)[None, :] < lens[:, None]
    return feats * keep[..., None]


# ---------------------------------------------------------------------------
# the dictionary
# ---------------------------------------------------------------------------

def alignment_mfcc(src, tar, s: dict, device):
    """Both speakers' MFCC from one batch padded to a common length; each cut
    to its own frame bucket and masked. Returns (FA, la), (FB, lb)."""
    hop, bucket = s["mcep.hop_length"], s["data.frame_bucket"]
    A, B = pad_batch(src, hop * bucket), pad_batch(tar, hop * bucket)
    n = min(len(src), len(tar))
    la = np.asarray([1 + len(x) // hop for x in src[:n]], np.int64)
    lb = np.asarray([1 + len(x) // hop for x in tar[:n]], np.int64)
    x = np.zeros((2 * n, max(A.shape[1], B.shape[1])), np.float32)
    x[:n, : A.shape[1]] = A[:n]
    x[n:, : B.shape[1]] = B[:n]
    out = dsp.mfcc(torch.as_tensor(x, device=device), sr=s["data.sr"],
                   n_fft=s["mcep.frame_length"], hop_length=hop, n_mfcc=s["mcep.n_mfcc"],
                   n_mels=s["mcep.n_mels"])
    FA = fit_frames(out[:n], _round_up(int(la.max()), bucket), la)
    FB = fit_frames(out[n:], _round_up(int(lb.max()), bucket), lb)
    return (FA, la), (FB, lb)


def dtw_paths(FA: torch.Tensor, FB: torch.Tensor, la, lb) -> list[tuple[np.ndarray, np.ndarray]]:
    """Each pair's DTW path (ascending frame indices of both sides).

    Cost ‖a‖² + ‖b‖² − 2·a·bᵀ clamped at 0 (one batched matmul), then the
    float32 recurrence D[i, j] = C[i, j] + min(D[i−1, j−1], D[i−1, j],
    D[i, j−1]) swept along anti-diagonals for all pairs at once; a tie goes
    to the diagonal, then to the step from above. The walk back starts at
    (la−1, lb−1) and ends at the origin."""
    a2 = torch.sum(FA * FA, dim=-1, keepdim=True)
    b2 = torch.sum(FB * FB, dim=-1, keepdim=True)
    C = torch.clamp(a2 + b2.transpose(-1, -2) - 2.0 * torch.matmul(FA, FB.transpose(-1, -2)),
                    min=0.0).cpu().numpy()
    n, ta, tb = C.shape
    la, lb = np.asarray(la), np.asarray(lb)
    rows = np.arange(ta)
    inside_rows = rows[None, :] < la[:, None]
    prev = np.full((n, ta), BIG, np.float32)        # diagonal d−1, by row
    prev2 = np.full((n, ta), BIG, np.float32)       # diagonal d−2
    codes = np.zeros((n, ta + tb - 1, ta), np.int8)
    for d in range(ta + tb - 1):
        j = d - rows
        ok = (j >= 0) & (j < tb)
        cost = np.where(ok[None, :] & (j[None, :] < lb[:, None]) & inside_rows,
                        C[:, rows, np.clip(j, 0, tb - 1)], BIG)
        left = np.where((j >= 1)[None, :], prev, BIG)
        up = np.concatenate([np.full((n, 1), BIG, np.float32), prev[:, :-1]], axis=1)
        diag = np.where((j >= 1)[None, :],
                        np.concatenate([np.full((n, 1), BIG, np.float32), prev2[:, :-1]],
                                       axis=1), BIG)
        if d == 0:
            diag[:, 0] = 0.0                          # the origin
        best = np.minimum(np.minimum(diag, up), left)
        codes[:, d] = np.where(best == diag, 0, np.where(best == up, 1, 2))
        new = np.minimum(cost + np.minimum(best, BIG), BIG).astype(np.float32)
        prev2, prev = prev, np.where(ok[None, :], new, BIG)
    paths = []
    for k in range(n):
        i, jj = int(la[k]) - 1, int(lb[k]) - 1
        pi, pj = [i], [jj]
        while i > 0 or jj > 0:
            c = codes[k, i + jj, i]
            ni = i if c == 2 else i - 1
            nj = jj if c == 1 else jj - 1
            if ni < 0 or nj < 0:
                break
            i, jj = ni, nj
            pi.append(i)
            pj.append(jj)
        paths.append((np.asarray(pi[::-1]), np.asarray(pj[::-1])))
    return paths


def stft_dict_features(src, tar, s: dict, device):
    """Both speakers' |STFT| from one batch padded to a common length."""
    hop, bucket = s["mcep.hop_length"], s["data.frame_bucket"]
    A, B = pad_batch(src, hop * bucket), pad_batch(tar, hop * bucket)
    x = np.zeros((len(src) + len(tar), max(A.shape[1], B.shape[1])), np.float32)
    x[: len(src), : A.shape[1]] = A
    x[len(src):, : B.shape[1]] = B
    mags = torch.abs(dsp.stft(torch.as_tensor(x, device=device), n_fft=s["mcep.frame_length"],
                              hop_length=hop))
    la = [1 + len(v) // hop for v in src]
    lb = [1 + len(v) // hop for v in tar]
    return ({"stft": fit_frames(mags[: len(src)], 1 + A.shape[1] // hop, la)},
            {"stft": fit_frames(mags[len(src):], 1 + B.shape[1] // hop, lb)})


def world_hop(s: dict) -> int:
    return int(round(s["data.sr"] * s["world.frame_period_ms"] / 1000.0))


def world_features(sigs, s: dict, device, bucket: int) -> dict:
    """WORLD sp, ap and f0 (N, T_pad, ·) of a batch padded to hop × bucket samples."""
    hop = world_hop(s)
    batch = pad_batch(sigs, hop * bucket)
    lens = [len(v) // hop + 1 for v in sigs]
    t_pad = _round_up(max(lens), bucket)
    r = analyze(torch.as_tensor(batch, device=device), sr=s["data.sr"],
                frame_period_ms=s["world.frame_period_ms"], f0_floor=s["world.f0_floor"],
                f0_ceil=s["world.f0_ceil"], fft_size=s["world.fft_size"],
                refine_f0=s["world.f0_is_refined"])
    return {"sp": fit_frames(r.sp, t_pad, lens), "ap": fit_frames(r.ap, t_pad, lens),
            "f0": fit_frames(r.f0[..., None], t_pad, lens)}


def build_dictionaries(s: dict, data_path: str, device) -> dict:
    """{feature: (A, B)}, each (K_pad, D) float32 on ``device``."""
    check_plain(s)
    nb = s["misc.nb_file"]
    src = speaker_wavs(data_path, s["data.src"], nb)
    tar = speaker_wavs(data_path, s["data.tar"], nb)
    (FA, la), (FB, lb) = alignment_mfcc(src, tar, s, device)
    paths = dtw_paths(FA.float(), FB.float(), la, lb)
    if s["data.use_stft"]:
        fa, fb = stft_dict_features(src, tar, s, device)
    else:
        fa = world_features(src, s, device, s["data.frame_bucket"])
        fb = world_features(tar, s, device, s["data.frame_bucket"])
    k_true = sum(len(p) for p, _ in paths)
    k_pad = _round_up(k_true, 512)
    out = {}
    for name in fa:
        rows_a = [fa[name][k, torch.as_tensor(pi, device=device)] for k, (pi, _) in enumerate(paths)]
        rows_b = [fb[name][k, torch.as_tensor(pj, device=device)] for k, (_, pj) in enumerate(paths)]
        A, B = torch.cat(rows_a).float(), torch.cat(rows_b).float()
        pad = (0, 0, 0, k_pad - k_true)
        out[name] = (torch.nn.functional.pad(A, pad), torch.nn.functional.pad(B, pad))
    return out


# ---------------------------------------------------------------------------
# one conversion
# ---------------------------------------------------------------------------

def mu_solve(X: torch.Tensor, A: torch.Tensor, tol: float, max_iter: int):
    """(H ≥ 0 with X ≈ H·A, the steps run) by sklearn's multiplicative
    updates (A fixed)."""
    F, K = X.shape[0], A.shape[0]
    H = torch.sqrt(torch.clamp(X.mean(), min=0.0) / K).expand(F, K).contiguous()
    At = A.T
    num = X @ At

    def err(H):
        return torch.linalg.norm(X - H @ A)

    first = prev = err(H)
    blocks = max_iter // CHECK_EVERY
    steps = 0
    for _ in range(blocks):
        for _ in range(CHECK_EVERY):
            den = (H @ A) @ At
            H = H * (num / torch.where(den == 0.0, EPS, den))
        steps += CHECK_EVERY
        e = err(H)
        if tol > 0 and bool(prev - e < tol * first):
            break
        prev = e
    else:
        for _ in range(max_iter - blocks * CHECK_EVERY):
            den = (H @ A) @ At
            H = H * (num / torch.where(den == 0.0, EPS, den))
            steps += 1
    return H, steps


def griffin_lim(mag: torch.Tensor, phase: torch.Tensor, s: dict, n_iter: int, length: int,
                momentum: float = 0.9):
    """Fast Griffin-Lim from the angles of ``phase``; returns (audio, final angles)."""
    n_fft, hop = s["mcep.frame_length"], s["mcep.hop_length"]
    mag = torch.clamp(mag, min=0.0).float()
    a = torch.abs(phase)
    angles = torch.where(a > 0, phase / torch.clamp(a, min=1e-16),
                         torch.ones((), dtype=torch.complex64, device=mag.device))
    alpha = momentum / (1.0 + momentum)
    prev = torch.zeros_like(angles)
    for _ in range(n_iter):
        rebuilt = dsp.stft(dsp.istft(mag * angles, n_fft=n_fft, hop_length=hop),
                           n_fft=n_fft, hop_length=hop)[: mag.shape[0]]
        t = rebuilt - alpha * prev
        angles = t / torch.clamp(torch.abs(t), min=1e-16)
        prev = rebuilt
    return dsp.istft(mag * angles, n_fft=n_fft, hop_length=hop, length=length), angles


def source_stft(x: np.ndarray, s: dict, device) -> torch.Tensor:
    """The input's complex STFT, the signal zero-padded to the frame bucket."""
    hop = s["mcep.hop_length"]
    padded = pad_batch([x], hop * s["data.frame_bucket"])[0]
    S = dsp.stft(torch.as_tensor(padded, device=device), n_fft=s["mcep.frame_length"],
                 hop_length=hop)
    return S[: 1 + len(x) // hop]


def logmv_f0(f0: torch.Tensor, A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Log-f0 mean-variance transform over the voiced rows of the f0 dictionaries."""
    def stats(M):
        v = M[:, 0]
        voiced = v > 0
        n = torch.clamp(voiced.sum(), min=1)
        lf = torch.where(voiced, torch.log(torch.clamp(v, min=1e-6)), 0.0)
        mu = lf.sum() / n
        var = torch.where(voiced, (lf - mu) ** 2, 0.0).sum() / n
        return mu, torch.sqrt(torch.clamp(var, min=1e-12))

    mu_s, sd_s = stats(A)
    mu_t, sd_t = stats(B)
    out = torch.exp((torch.log(torch.clamp(f0, min=1e-6)) - mu_s) * (sd_t / sd_s) + mu_t)
    return torch.where(f0 > 0, out, torch.zeros_like(out))


def convert(x: np.ndarray, dicts: dict, s: dict, device) -> tuple[np.ndarray, int]:
    """The converted audio of one utterance, and the MU steps its solves ran."""
    tol, max_iter = s["nmf.tol"], s["nmf.max_iter"]
    if s["data.use_stft"]:
        S = source_stft(x, s, device)
        A, B = dicts["stft"]
        H, steps = mu_solve(torch.abs(S), A, tol, max_iter)
        y, _ = griffin_lim(H @ B, S, s, s["nmf.griffin_lim_iters"], len(x))
        return y.cpu().numpy(), steps
    n = len(x) // world_hop(s) + 1
    feats = {k: v[0, :n] for k, v in
             world_features([x], s, device, s["data.frame_bucket"] * 8).items()}
    out = {"f0": logmv_f0(feats["f0"], *dicts["f0"])}
    residual = s["nmf.use_residual"] != "off"
    steps = 0
    for name in ("sp", "ap"):
        A, B = dicts[name]
        H, n = mu_solve(feats[name], A, tol, max_iter)
        steps += n
        Y = H @ B
        out[name] = Y * (feats[name] / torch.clamp(H @ A, min=EPS)) if residual else Y
    y = synthesize(out["f0"][:, 0], out["sp"], out["ap"], sr=s["data.sr"],
                   frame_period_ms=s["world.frame_period_ms"], fft_size=s["world.fft_size"])
    return y.cpu().numpy(), steps


def stream(chunks, dicts: dict, s: dict, device, context: int, n_iter: int):
    """The audio of each pushed (magnitude, complex STFT) chunk of one stream
    (the chunk's solve, then Griffin-Lim over the converted left context and
    the chunk, the context seeded with the phase it converged to), and the
    MU steps of all its solves."""
    hop = s["mcep.hop_length"]
    A, B = dicts["stft"]
    ctx_mag = ctx_phase = None
    out, steps = [], 0
    for mag, S in chunks:
        mag = torch.as_tensor(mag, dtype=torch.float32, device=device)
        S = torch.as_tensor(S, device=device).to(torch.complex64)
        H, n = mu_solve(mag, A, s["nmf.tol"], s["nmf.max_iter"])
        Y = H @ B
        steps += n
        skip = 0 if ctx_mag is None else ctx_mag.shape[0]
        full = Y if ctx_mag is None else torch.cat([ctx_mag, Y])
        if skip:
            seed = (ctx_phase if ctx_phase is not None and ctx_phase.shape[0] == skip else
                    torch.ones((skip, S.shape[1]), dtype=torch.complex64, device=device))
            S = torch.cat([seed, S])
        y, angles = griffin_lim(full, S, s, n_iter, full.shape[0] * hop)
        ctx_mag = full[-context:]
        ctx_phase = angles[-ctx_mag.shape[0]:]
        out.append(y[skip * hop: (skip + Y.shape[0]) * hop].cpu().numpy())
    return out, steps
