"""The fits' share of their roofline: the least time of each ``separate.em``
span under a ``separate`` span whose ``spectral_model`` is "nmf"
(:mod:`benchmark.harness.roofline_sep`, from its F, N, C, J, K, n_em and
n_inner) summed, over the summed device time of those spans, in %. None
where no such span was recorded."""

from benchmark.harness import spans
from benchmark.harness.roofline import least_seconds
from benchmark.harness.roofline_sep import em_work

snapshot = spans.cursor

SHAPE = ("F", "N", "C", "J", "K", "n_em", "n_inner")


def read(obs):
    recs = spans.window(obs) or []
    top = {r["id"] for r in spans.roots(recs, "separate")
           if r["attrs"].get("spectral_model") == "nmf"}
    fits = [s for s in recs if s["name"] == "separate.em" and s["parent"] in top]
    least = sum(least_seconds(*em_work(*(s["attrs"][k] for k in SHAPE))) for s in fits)
    spent = sum(s["device_ms"] for s in fits) * 1e-3
    return 100.0 * least / spent if spent > 0 and least > 0 else None
