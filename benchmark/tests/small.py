"""A cell of BENCHMARK.json cut to a size the CPU tests hold: three
dictionary pairs, 20 MU steps, 5 Griffin-Lim iterations, short clips. The
program and the reference both take the cut settings."""

from benchmark.harness.spec import ROOT, load_cell

SMALL = {"misc.nb_file": 3, "nmf.max_iter": 20, "nmf.griffin_lim_iters": 5}


def small_cell(name: str, root=ROOT):
    cell = load_cell(name, root)
    cell.config["settings"].update(SMALL)
    cell.traffic.update(pool=4, warmup=1, trace_seconds=0.5, check_sample=2, max_seconds=2.0)
    if cell.traffic["entry"] == "stream":
        cell.traffic.update(synth_iters=5)
    return cell
