"""The comparison that decides ``correct``.

After the window, a sample of the sessions that finished, drawn from the
seed and always holding the one of most input audio (the longest request,
or the stream session with the most pushes), is answered again by the
plain reference through the cell's entry (``entries/<entry>.py``'s
``reference``), from the same inputs; the reference builds its own
dictionaries. Each sampled session's answer (its calls' answers joined)
gives its numbers. Of each number the run reports the worst of the sample
(``<number>``) and its median (``<number>.median``), and holds to its limit
each of these that the cell's limits file names. For audio
(:func:`audio_numbers`):

- ``audio_rel_l2``: ‖y − y_ref‖ / ‖y_ref‖ of the audio, which a phase fault
  moves;
- ``spec_rel_l2``: the same of the |STFT| of the audio (n_fft 400, hop 80),
  which no phase drift moves.

The worst judges every sampled answer; the median is the steady reading
where sound answers have a heavy tail (Griffin-Lim's momentum iterations
and a stream's carried phase amplify the kernels' summation order in a few
answers) while a fault moves them all. A failed call, or an answer of the
wrong length or not finite, makes the run not correct by itself.
"""

from __future__ import annotations

import statistics

import numpy as np
import torch

from benchmark.reference import dsp


def sample(size: dict, n: int, seed: int) -> list:
    """Up to n keys of ``size``: the one of largest size and a seeded draw
    of the rest."""
    keys = sorted(size)
    if not keys:
        return []
    longest = max(keys, key=lambda k: (size[k], -k))
    rest = [k for k in keys if k != longest]
    rng = np.random.default_rng([seed, 4])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + sorted(rest[i] for i in pick)


def audio_numbers(y: np.ndarray, y_ref: np.ndarray, device) -> dict:
    y = torch.as_tensor(np.asarray(y, np.float32), device=device)
    r = torch.as_tensor(np.asarray(y_ref, np.float32), device=device)
    S, R = (torch.abs(dsp.stft(v, n_fft=400, hop_length=80)) for v in (y, r))
    return {"audio_rel_l2": float(torch.linalg.norm(y - r) / torch.linalg.norm(r)),
            "spec_rel_l2": float(torch.linalg.norm(S - R) / torch.linalg.norm(R))}


def finished(window) -> dict:
    """{session: its records} of the sessions whose every call succeeded."""
    groups = {}
    for r in window.records:
        groups.setdefault(r.index, []).append(r)
    return {s: rs for s, rs in groups.items() if all(r.ok for r in rs)}


def compare(entry, window, pool, settings: dict, params: dict, data_path: str, seed: int,
            device, control: bool = False, built: dict | None = None):
    """(numbers, problems, rows) of the window's sample against the reference:
    the worst and the median of each number, what makes the run wrong by
    itself, and each sampled session's numbers with the MU steps of both
    sides (the program's where it reports them). With ``control`` the reference
    computed in TF32 stands in the program's place: the control, which the
    limits have to fail."""
    built = {} if built is None else built
    groups = finished(window)
    problems = [f"{window.failed} failed calls"] if window.failed else []
    picked = sample({s: sum(r.audio_s for r in rs) for s, rs in groups.items()},
                    int(params["check_sample"]), seed)
    if not picked:
        return {}, problems + ["nothing finished to compare"], []
    sessions = {s: pool[s % len(pool)][: len(groups[s])] for s in picked}
    refs = entry.reference(sessions, settings, params, data_path, device, False, built)
    if control:
        answers = entry.reference(sessions, settings, params, data_path, device, True, built)
    else:
        answers = {}
        for s in picked:
            rs = groups[s]
            steps = [r.steps for r in rs]
            answers[s] = (np.concatenate([np.asarray(r.output) for r in rs]),
                          None if None in steps else sum(steps))
    rows = []
    for k in picked:
        (y, steps), (y_ref, ref_steps) = answers[k], refs[k]
        if y is None or len(y) != len(y_ref) or not np.all(np.isfinite(y)):
            problems.append(f"answer {k}: wrong length or not finite")
            continue
        rows.append(dict(audio_numbers(y, y_ref, device), key=k, steps=steps, ref_steps=ref_steps))
    names = sorted({n for r in rows for n in r} - {"key", "steps", "ref_steps"})
    summary = {}
    for n in names:
        summary[n] = max(r[n] for r in rows)
        summary[f"{n}.median"] = statistics.median(r[n] for r in rows)
    return summary, problems, rows
