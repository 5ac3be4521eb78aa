"""The served solves' share of their roofline: the least time of each
``nmf`` span under a request's ``solve`` span (``benchmark.harness.roofline``,
from its F, K, D and n_iter and the ``solve`` span's ``residual``) summed,
over the summed device time of those ``solve`` spans, in %."""

from benchmark.harness import spans
from benchmark.harness.roofline import least_seconds, solve_work

snapshot = spans.cursor


def read(obs):
    recs = spans.window(obs)
    top = {r["id"] for r in spans.roots(recs or [], "convert")}
    solves = {s["id"]: s for s in recs or [] if s["name"] == "solve" and s["parent"] in top}
    least = 0.0
    for s in recs or []:
        if s["name"] == "nmf" and s["parent"] in solves:
            a = s["attrs"]
            work = solve_work(a["F"], a["K"], a["D"], a["n_iter"],
                              bool(solves[s["parent"]]["attrs"].get("residual")))
            least += least_seconds(*work)
    spent = sum(s["device_ms"] for s in solves.values()) * 1e-3
    return 100.0 * least / spent if spent > 0 and least > 0 else None
