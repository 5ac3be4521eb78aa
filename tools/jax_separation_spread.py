"""How far the JAX package's own separation fits move when their input is
multiplied by (1 + 2e-7·noise), on the CPU: the spread any second
implementation (the port, the card) must be allowed after n EM iterations.

Cases, each from ``PRNGKey(0)`` on the 2 s benchmark mixture
(``io.standin.synthetic_mixture``):

- ``cli_separate``: the ``separate`` CLI's fit (the wav read back from
  PCM16, downmixed and duplicated; 8 components, n_fft 400, hop 80), 20 EM;
- ``hmm``, ``shmm``: ``chip_smoke.py`` phase 10's HMM configurations (the
  stereo mixture, 8 states, n_fft 400, hop 80) at 5 and 20 EM.

Prints one JSON line: for each case and iteration count, the largest
relative change of a source image's energy and of the last NLL over the
noise seeds.

    python tools/jax_separation_spread.py [--seeds 8]
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from exemplars_vc_tpu.separate import separate_signal
    from exemplars_vc_tpu_torch.io.standin import synthetic_mixture
    from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav

    x = synthetic_mixture()
    with tempfile.TemporaryDirectory() as d:
        wav = os.path.join(d, "mix.wav")
        write_wav(wav, x, 16000)
        mono = read_wav(wav)[0]
    base = dict(n_sources=2, n_components=8, n_fft=400, hop_length=80)
    cases = {"cli_separate": (np.stack([mono, mono]).astype(np.float32), {}, (20,)),
             "hmm": (x, {"spectral_model": "hmm"}, (5, 20)),
             "shmm": (x, {"spectral_model": "shmm"}, (5, 20))}

    def fit(inp, kw, n_em):
        img, model = separate_signal(jnp.asarray(inp), key=jax.random.PRNGKey(0), n_em=n_em,
                                     **base, **kw)
        img = np.asarray(img, np.float64)
        return (img ** 2).sum(axis=tuple(range(1, img.ndim))), float(model.neg_log_like[-1])

    out = {}
    for name, (inp, kw, ems) in cases.items():
        for n_em in ems:
            e0, nll0 = fit(inp, kw, n_em)
            de, dn = 0.0, 0.0
            for s in range(args.seeds):
                noise = np.random.default_rng(s).standard_normal(inp.shape).astype(np.float32)
                e, nll = fit(inp * (1 + 2e-7 * noise), kw, n_em)
                de = max(de, float((np.abs(e - e0) / e0).max()))
                dn = max(dn, abs(nll / nll0 - 1))
            out[f"{name}_{n_em}em"] = {"energy_rel_max": de, "nll_last_rel_max": dn}
    print(json.dumps({"seeds": args.seeds, "jax": jax.__version__, **out}))


if __name__ == "__main__":
    sys.exit(main())
