"""Device kernels per EM iteration: the kernels in the profiler's trace of
the traced window over the change of the program's ``separate.em_iters``
counter (``separate_signal.em_iters``, one an E-step) across it. None where
the counter is absent or did not move, or the trace holds no kernel."""

import importlib


def snapshot():
    mc = importlib.import_module("exemplars_vc_tpu_torch.separate.multichannel")
    return getattr(getattr(mc, "separate_signal", None), "em_iters", None)


def read(obs):
    before, after = obs.get("snapshot") or (None, None)
    t = obs.get("trace")
    if before is None or after is None or after == before or not t or not t["kernels"]:
        return None
    return t["kernels"] / (after - before)
