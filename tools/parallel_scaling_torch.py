#!/usr/bin/env python3
"""Run ``chip_smoke.py``'s phase-9 rank worker over several cards, one rank
a card on NCCL, against one card.

    python3 tools/parallel_scaling_torch.py [--ranks 4] [--out FILE]

Each rank (``chip_smoke.parallel_rank``) drives the sharded NMF at F = 688,
K = 115,200, D = 201, the ``mu_sharded`` conversion, ``sharded_dtw_batch``,
``sharded_dtw_long`` of one 32,768 x 2000 pair and data-parallel warp-train,
gates each and times it (median of 3) against its single-device
counterpart; warp-train takes one utterance a rank a step, and the parent
times it on one card at the same minibatch first. Needs ``--ranks`` cards.
Prints the cards' names and power limits (``nvidia-smi``), every rank's
measurements, and one JSON line; ``--out`` writes that too.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--out")
    args = ap.parse_args()
    import torch

    from exemplars_vc_tpu_torch.io.standin import build_standin_corpus
    from exemplars_vc_tpu_torch.kernels import build

    if torch.cuda.device_count() < args.ranks:
        sys.exit(f"{args.ranks} ranks need as many cards, found {torch.cuda.device_count()}")
    cards = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True, text=True,
                           timeout=60, check=True).stdout.strip().splitlines()
    print(cards, flush=True)
    for src in ("dtw_wavefront", "nmf_mu"):      # built once, before the ranks load them
        build.load_library(src)
    with tempfile.TemporaryDirectory(prefix="evc_scaling_") as root:
        corpus = build_standin_corpus(os.path.join(root, "corpus"))
        single = chip_smoke.single_train(torch.device("cuda:0"), root, corpus[0], args.ranks)
        ranks = chip_smoke.run_world(args.ranks, "nccl", root, corpus)
    out = {"cards": cards, "ranks": args.ranks, "single_train": single, "per_rank": ranks}
    print(json.dumps(out), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
