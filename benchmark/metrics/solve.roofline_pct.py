"""The activation solve's share of its roofline: the least time of each
request's solves (``benchmark.harness.roofline``, from F, K, D and n_iter
alone) summed, over the summed fenced ``nmf_solve`` seconds, in %."""

from benchmark.harness.roofline import least_seconds, solve_work


def read(obs):
    least = spent = 0.0
    for r in obs.get("stages") or []:
        if "nmf_solve" not in r["timings"] or not r["solves"]:
            continue
        for F, K, D, n_iter in r["solves"].values():
            least += least_seconds(*solve_work(F, K, D, n_iter, r["residual"]))
        spent += r["timings"]["nmf_solve"]
    return 100.0 * least / spent if spent > 0 and least > 0 else None
