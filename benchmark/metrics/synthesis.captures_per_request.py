"""Griffin-Lim CUDA graph captures (the change of the program's
``griffin_lim.captures`` counter over the traced window) per call: per
request when serving, per push when streaming."""

import importlib


def snapshot():
    gl = importlib.import_module("exemplars_vc_tpu_torch.dsp.griffin_lim")
    return getattr(getattr(gl, "griffin_lim", None), "captures", None)


def read(obs):
    before, after = obs.get("snapshot") or (None, None)
    if before is None or after is None or not obs.get("calls"):
        return None
    return (after - before) / obs["calls"]
