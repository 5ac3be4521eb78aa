"""Write the random inits that the JAX package's ``separate_lead_stereo``
draws from ``jax.random.PRNGKey(1)`` on the 2 s separation benchmark mixture
(``bench_separate.py``'s settings: n_fft 1024, hop 256, f0 100-800 Hz at 4
steps a semitone, 20 filter atoms, 4 filters, 20 accompaniment components),
one set a round, to ``exemplars_vc_tpu_torch/io/data/jax_simm_draws_key1.npz``.

The port's own ``separate_lead_stereo(..., key=prng.PRNGKey(1))`` draws
the same inits (``tests/test_torch_prng.py`` and ``chip_smoke.py`` phase 11
hold its draws to the file, without JAX, on the card too), so it starts
where the JAX package's operating-point test starts
(``tests/test_separation_platform_parity.py::TestOperatingPoint``).
``tests/test_torch_stereo_simm.py`` holds the file equal to a fresh draw.

    python tools/jax_simm_draws.py
"""

import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "exemplars_vc_tpu_torch", "io", "data", "jax_simm_draws_key1.npz")


def round_draws(key, F, N, NF0, P, n_filters, n_accomp) -> dict:
    """The inits JAX ``stereo_simm(..., key=key)`` draws, keyed as its
    ``*_init`` arguments."""
    import jax
    import jax.numpy as jnp

    ks = jax.random.split(key, 6)

    def absn(k, shape):
        return np.array(jnp.abs(jax.random.normal(k, shape)).astype(jnp.float32))

    bR = np.array(jax.random.uniform(ks[5], (n_accomp,), dtype=jnp.float32))
    return dict(HGAMMA_init=absn(ks[0], (P, n_filters)), HPHI_init=absn(ks[1], (n_filters, N)),
                HF0_init=absn(ks[2], (NF0, N)), WM_init=absn(ks[3], (F, n_accomp)),
                HM_init=absn(ks[4], (n_accomp, N)), beta_init=np.stack([bR, 1.0 - bR]))


def benchmark_draws(seed: int = 1) -> tuple[dict, dict]:
    """(round 1, round 2) inits of ``separate_lead_stereo`` on the 2 s
    benchmark mixture (32,000 samples: 126 frames) for ``PRNGKey(seed)``."""
    import jax

    F, N = 513, 1 + 32_000 // 256
    n_steps = int(np.ceil(12 * 4 * np.log2(800.0 / 100.0))) + 1
    return tuple(round_draws(k, F, N, n_steps, 20, 4, 20)
                 for k in jax.random.split(jax.random.PRNGKey(seed)))


def main() -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    r1, r2 = benchmark_draws(1)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **{f"round{i}_{k}": v for i, r in ((1, r1), (2, r2))
                                for k, v in r.items()})
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes)")


if __name__ == "__main__":
    sys.exit(main())
