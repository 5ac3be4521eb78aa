"""The served KL solves' share of their roofline: the least time of each
``nmf`` span whose ``beta`` is "kl" under a request's ``solve`` span
(:mod:`benchmark.harness.roofline_kl`, from its F, K, D and n_iter and the
s of the ``h_smooth`` span beside it, 0 without one) summed, over the
summed device time of those ``solve`` spans, in %. None where no span says
it solved KL."""

from benchmark.harness import spans
from benchmark.harness.roofline import least_seconds
from benchmark.harness.roofline_kl import kl_solve_work

snapshot = spans.cursor


def read(obs):
    recs = spans.window(obs) or []
    top = {r["id"] for r in spans.roots(recs, "convert")}
    solves = {s["id"]: s for s in recs if s["name"] == "solve" and s["parent"] in top}
    smooth = {s["parent"]: s["attrs"]["s"] for s in recs
              if s["name"] == "h_smooth" and s["parent"] in solves}
    least, held = 0.0, set()
    for s in recs:
        a = s["attrs"]
        if s["name"] == "nmf" and s["parent"] in solves and a.get("beta") == "kl":
            least += least_seconds(*kl_solve_work(a["F"], a["K"], a["D"], a["n_iter"],
                                                  smooth.get(s["parent"], 0)))
            held.add(s["parent"])
    spent = sum(solves[i]["device_ms"] for i in held) * 1e-3
    return 100.0 * least / spent if spent > 0 and least > 0 else None
