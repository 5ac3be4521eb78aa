"""Mean over the traced window's requests of the MU steps their solves ran:
``n_iter`` of the ``nmf`` spans under each ``convert`` span."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    recs = spans.window(obs)
    top = {r["id"] for r in spans.roots(recs or [], "convert")}
    steps = [s["attrs"]["n_iter"] for s in recs or [] if s["name"] == "nmf" and s["root"] in top]
    return sum(steps) / len(top) if steps else None
