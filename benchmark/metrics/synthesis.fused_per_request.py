"""Griffin-Lim calls that took the fused kernel (the change of the
program's ``griffin_lim.fused`` counter over the traced window) per call:
per request when serving, per push when streaming. None where the counter
is absent or did not move: a program without the fused route, or a run on
the CPU, where ``griffin_lim`` always runs its eager loop."""

import importlib


def snapshot():
    gl = importlib.import_module("exemplars_vc_tpu_torch.dsp.griffin_lim")
    return getattr(getattr(gl, "griffin_lim", None), "fused", None)


def read(obs):
    before, after = obs.get("snapshot") or (None, None)
    if before is None or after is None or after == before or not obs.get("calls"):
        return None
    return (after - before) / obs["calls"]
