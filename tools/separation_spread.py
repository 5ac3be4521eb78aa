"""How far the port's HMM separation fits move under roundoff, on one device
and between two: the readings that set ``chip_smoke.py`` phase 10's
image-energy limits for the ``hmm`` and ``shmm`` configurations.

Each fit is ``separate_signal`` on the 2 s benchmark mixture
(``io.standin.synthetic_mixture``) at phase 10's settings (2 sources, 8
states, n_fft 400, hop 80, 20 EM) from ``PRNGKey(k)``. For every
configuration and key it reports, as the largest relative change of a
source image's energy:

- ``spread[dev]``: the fit on ``dev`` against the same device's fit of the
  input times (1 + 2e-7·noise), over ``--seeds`` noise draws (the
  perturbation of ``tools/jax_separation_spread.py``);
- ``gap``: the first device's fit against the second's from the same key,
  as phase 10 reads it (with ``--devices cuda cpu``);
- ``control``: the first device's fit against the second device's fit from
  the next key, a start drawn otherwise: what a fault of the draws or of
  the fit looks like at this distance;
- ``paths_equal``: the share of frames whose HMM state is the same in the
  ``gap`` pair.

Prints one JSON line (and writes it to ``--out`` when given).

    python tools/separation_spread.py --devices cuda cpu [--keys 0 1 2 3] [--seeds 4]
    python tools/separation_spread.py --devices cpu          # the CPU alone
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", nargs="+", default=["cuda", "cpu"])
    ap.add_argument("--configs", nargs="+", default=["hmm", "shmm"])
    ap.add_argument("--keys", nargs="+", type=int, default=[0, 1, 2, 3])
    ap.add_argument("--seeds", type=int, default=4)
    ap.add_argument("--n-em", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    from exemplars_vc_tpu_torch.io.standin import synthetic_mixture
    from exemplars_vc_tpu_torch.prng import PRNGKey
    from exemplars_vc_tpu_torch.separate import separate_signal

    torch.backends.cuda.matmul.allow_tf32 = False
    x = synthetic_mixture()
    noisy = [x * (1 + 2e-7 * np.random.default_rng(s).standard_normal(x.shape)
                  .astype(np.float32)) for s in range(args.seeds)]
    base = dict(n_sources=2, n_components=8, n_em=args.n_em, n_fft=400, hop_length=80)

    def fit(inp, key, dev, spectral):
        img, model = separate_signal(inp, key=PRNGKey(key), device=dev,
                                     spectral_model=spectral, **base)
        img = img.cpu().numpy().astype(np.float64)
        return (img ** 2).sum(axis=(1, 2)), model.H.argmax(dim=1).cpu().numpy()

    def rel(a, b) -> float:
        return float((np.abs(a - b) / b).max())

    t0 = time.perf_counter()
    out = {"n_em": args.n_em, "keys": args.keys, "seeds": args.seeds,
           "devices": args.devices}
    for spectral in args.configs:
        rows = {}
        for k in args.keys:
            fits = {d: fit(x, k, d, spectral) for d in args.devices}
            row = {"spread": {d: max((rel(fit(xn, k, d, spectral)[0], fits[d][0])
                                      for xn in noisy), default=0.0)
                              for d in args.devices}}
            a, b = args.devices[0], args.devices[-1]
            if a != b:
                row["gap"] = rel(fits[a][0], fits[b][0])
                row["paths_equal"] = float((fits[a][1] == fits[b][1]).mean())
            row["control"] = rel(fits[a][0], fit(x, k + 1, b, spectral)[0])
            rows[str(k)] = row
        out[spectral] = {
            "per_key": rows,
            "spread_max": max(max(r["spread"].values()) for r in rows.values()),
            "gap_max": max((r.get("gap", 0.0) for r in rows.values()), default=0.0),
            "control_min": min(r["control"] for r in rows.values())}
    out["seconds"] = time.perf_counter() - t0
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    sys.exit(main())
