"""Device kernels per push: the kernels in the profiler's trace of the
traced window over the pushes in it (streaming cells only)."""


def read(obs):
    t = obs.get("trace")
    if obs.get("entry") != "stream" or not t or not obs.get("calls"):
        return None
    return t["kernels"] / obs["calls"]
