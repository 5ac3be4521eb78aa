"""The stereo SIMM's operating point over random starts, in the JAX package
and in the port, each from its own draws of ``PRNGKey(s)``, on the CPU:
the 2 s separation benchmark mixture at ``bench_separate.py``'s settings
(n_fft 1024, hop 256, f0 100-800 Hz, 20 accompaniment components, 15
iterations a round). Prints one line a seed (lead energy share, median
voiced f0, lead SDR in dB for each package) and a summary of the shares.

    python tools/simm_seed_sweep.py [--seeds 32]
"""

import argparse
import os
import sys

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=32)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import torch

    from exemplars_vc_tpu.separate import separate_lead_stereo as jax_separate_lead_stereo
    from exemplars_vc_tpu_torch.io.standin import synthetic_mixture
    from exemplars_vc_tpu_torch.prng import PRNGKey
    from exemplars_vc_tpu_torch.separate import separate_lead_stereo

    torch.set_num_threads(2)
    x, lead_img, _ = synthetic_mixture(return_components=True)
    kw = dict(sample_rate=16000.0, n_fft=1024, hop_length=256, f0_min=100.0, f0_max=800.0,
              n_accomp=20, n_iter=15)

    def point(res):
        lead, acc = (np.asarray(a, np.float64) for a in (res.lead, res.accomp))
        f0 = res.f0[res.f0 > 0]
        sdr = 10 * np.log10((lead_img ** 2).sum() / ((lead - lead_img) ** 2).sum())
        return ((lead ** 2).sum() / ((lead ** 2).sum() + (acc ** 2).sum()),
                float(np.median(f0)), float(sdr))

    shares = {"jax": [], "port": []}
    for s in range(args.seeds):
        j = point(jax_separate_lead_stereo(jnp.asarray(x), key=jax.random.PRNGKey(s), **kw))
        p = point(separate_lead_stereo(x, key=PRNGKey(s), device="cpu", **kw))
        shares["jax"].append(j[0])
        shares["port"].append(p[0])
        print(f"seed {s}: jax share {j[0]:.4f} f0 {j[1]:.1f} sdr {j[2]:.2f} | "
              f"port share {p[0]:.4f} f0 {p[1]:.1f} sdr {p[2]:.2f}", flush=True)
    for name, a in shares.items():
        a = np.asarray(a)
        print(f"{name}: {len(a)} seeds, share min {a.min():.4f} median {np.median(a):.4f} "
              f"max {a.max():.4f}; within 0.05 of 0.6757: {(abs(a - 0.6757) < 0.05).sum()}; "
              f"below 0.35: {(a < 0.35).sum()}")


if __name__ == "__main__":
    main()
