"""Host time in the program's ``griffin_lim.capture`` spans (each miss of
Griffin-Lim's graph cache: a new shape's buffers and the eviction of the
least recent, and each graph capture with the synchronize, ``cudaFree`` and
instantiation it brings) over the traced window's calls, in ms: per request
when serving, per push when streaming. Read on the card only, where the
graphs are."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    recs = spans.window(obs)
    calls = obs.get("calls")
    if not calls or not (spans.roots(recs or [], "convert") or spans.roots(recs or [], "push")):
        return None
    return sum(s["host_ms"] for s in recs if s["name"] == "griffin_lim.capture") / calls
