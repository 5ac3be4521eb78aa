"""Host time in ``cudaFree`` per call over the traced window (the
profiler's CUDA runtime events), in ms: what the program pays when
Griffin-Lim's graph cache evicts a shape and its memory pool is given
back, a call that waits for the device and stalls the host."""


def read(obs):
    t = obs.get("trace")
    if not t or not obs.get("calls") or "runtime_s" not in t:
        return None
    return 1e3 * t["runtime_s"].get("cudaFree", 0.0) / obs["calls"]
