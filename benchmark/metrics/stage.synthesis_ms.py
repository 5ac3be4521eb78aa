"""Mean over the traced window's requests of the program's fenced
``synthesis`` stage (``convert_utterance(..., sync_stages=True).timings``), in ms."""


def read(obs):
    rows = [r["timings"]["synthesis"] for r in obs.get("stages") or [] if "synthesis" in r["timings"]]
    return sum(rows) / len(rows) * 1e3 if rows else None
