"""Mean over the traced window's requests of the program's fenced
``nmf_solve`` stage (``convert_utterance(..., sync_stages=True).timings``), in ms."""


def read(obs):
    rows = [r["timings"]["nmf_solve"] for r in obs.get("stages") or [] if "nmf_solve" in r["timings"]]
    return sum(rows) / len(rows) * 1e3 if rows else None
