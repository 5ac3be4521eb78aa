"""Write ``exemplars_vc_tpu_torch/io/data/jax_prng_golden.npz``: what
``jax.random`` (threefry2x32, partitionable, 64-bit types off) and the JAX
package's seeded sites and CLI commands give, on the CPU, for a run without
JAX (the card's) to hold the port's ``prng`` and seeded commands to.

The file holds, with the JAX version under ``jax_version``:

- ``key_S``, ``split2_S``, ``split6_S`` for the seeds S of :data:`SEEDS`;
- ``{bits,uniform,uniformb,normal,randint}_S_NAME`` at the shapes of
  :data:`SHAPES` (``uniformb`` in ±:data:`WARP_BOUND`, the warping net's
  LSTM bound; ``randint`` in [0, 8), the HMM's states);
- the draws of the JAX package's sites at the 2 s mixture's shapes
  (:func:`site_draws`; the stereo SIMM's are ``jax_simm_draws_key1.npz``);
- ``world_noise``: ``normal(PRNGKey(0), (WORLD_NOISE_SAMPLES,))``. An
  element's draw depends on its index only, so ``normal(key, (n,))`` is the
  first n of it for every shorter n;
- ``cli_*``: the JAX CLI's ``separate --seed 0`` (20 EM) and
  ``separate-lead --model stereo --seed 1`` (15 iterations, 20 components)
  on the 2 s mixture written as a wav.

    python tools/jax_prng_golden.py
"""

import contextlib
import io
import json
import os
import sys
import tempfile

import numpy as np

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT = os.path.join(ROOT, "exemplars_vc_tpu_torch", "io", "data", "jax_prng_golden.npz")

SEEDS = (0, 1, 42, 2 ** 31 - 1)
SHAPES = {"scalar": (), "odd": (7,), "empty": (0,), "jfk": (2, 201, 8)}
WARP_BOUND = float(np.float32(1.0) / np.sqrt(np.float32(20)))
WORLD_NOISE_SAMPLES = 80_000
# the separate CLI's defaults on the 2 s mixture: J 2, K 8, n_fft 400, hop 80
SEP = dict(J=2, K=8, F=201, N=401, C=2)
# separate_lead's subkeys on the 2 s mixture (n_fft 1024, hop 256, f0
# 100-800 Hz at 4 steps a semitone, 20 filter atoms, 20 accompaniment
# components)
LEAD = dict(F=513, N=126, NF0=145, P=20, R=20)


def primitive_draws(jax, jnp) -> dict:
    out = {}
    for s in SEEDS:
        k = jax.random.PRNGKey(s)
        out[f"key_{s}"] = np.asarray(k)
        out[f"split2_{s}"] = np.asarray(jax.random.split(k))
        out[f"split6_{s}"] = np.asarray(jax.random.split(k, 6))
        for name, shape in SHAPES.items():
            out[f"bits_{s}_{name}"] = np.asarray(jax.random.bits(k, shape))
            out[f"uniform_{s}_{name}"] = np.asarray(jax.random.uniform(k, shape))
            out[f"uniformb_{s}_{name}"] = np.asarray(
                jax.random.uniform(k, shape, minval=-WARP_BOUND, maxval=WARP_BOUND))
            out[f"normal_{s}_{name}"] = np.asarray(jax.random.normal(k, shape))
            out[f"randint_{s}_{name}"] = np.asarray(jax.random.randint(k, shape, 0, 8))
    return out


def site_draws(jax, jnp) -> dict:
    """The inits the JAX package's seeded sites draw at the 2 s mixture's
    shapes, each as its source lines compute it."""
    from exemplars_vc_tpu.models.warping import WarpingNetConfig, init_warping_params
    from exemplars_vc_tpu.separate.multichannel import random_spatial_init

    J, K, F, N, C = (SEP[k] for k in ("J", "K", "F", "N", "C"))
    out = {}
    # separate/multichannel.py:242-247 (fit_multichannel_nmf, PRNGKey(0))
    kw, kh, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    out["separate_W"] = np.asarray(jax.random.normal(kw, (J, F, K)) ** 2)
    out["separate_H"] = np.asarray(jax.random.normal(kh, (J, K, N)) ** 2)
    out["separate_R"] = np.asarray(random_spatial_init(kr, J, F, C))
    # separate/hmm.py:215-225 (fit_multichannel_hmm, PRNGKey(0), 8 states)
    kw, kr, kp = jax.random.split(jax.random.PRNGKey(0), 3)
    out["hmm_W"] = np.asarray(jax.random.normal(kw, (J, F, K)) ** 2)
    out["hmm_paths"] = np.asarray(jax.random.randint(kp, (J, N), 0, K))
    out["hmm_a_re"] = np.asarray(jax.random.normal(kr, (J, C)))
    # separate/lead.py:232 → isnmf.py:234-240 (sf_nmf's subkeys 1, 3, 4, 5, PRNGKey(1))
    ks = jax.random.split(jax.random.PRNGKey(1), 6)
    out["lead_H"] = np.asarray(jax.random.normal(ks[1], (LEAD["NF0"], LEAD["N"])) ** 2)
    out["lead_HF"] = np.asarray(jax.random.normal(ks[3], (LEAD["P"], LEAD["N"])) ** 2)
    out["lead_WR"] = np.asarray((1.0 + jax.random.normal(ks[4], (LEAD["F"], LEAD["R"]))) ** 2)
    out["lead_HR"] = np.asarray((1.0 + jax.random.normal(ks[5], (LEAD["R"], LEAD["N"]))) ** 2)
    # parallel/sharded_separate.py:57-67 (separate_batch, two mixtures, PRNGKey(0))
    kw, kh, kr = jax.random.split(jax.random.PRNGKey(0), 3)
    out["batch_W"] = np.asarray(jax.random.normal(kw, (2, J, F, K)) ** 2)
    out["batch_H"] = np.asarray(jax.random.normal(kh, (2, J, K, N)) ** 2)
    out["batch_R"] = np.stack([np.asarray(random_spatial_init(k, J, F, C))
                               for k in jax.random.split(kr, 2)])
    # models/train.py:180 (init_warping_params(PRNGKey(0)), default net)
    leaves = jax.tree_util.tree_leaves(init_warping_params(jax.random.PRNGKey(0),
                                                           WarpingNetConfig()))
    out.update({f"warp_leaf_{i}": np.asarray(v) for i, v in enumerate(leaves)})
    # world/synthesis.py:59, :112
    out["world_noise"] = np.asarray(
        jax.random.normal(jax.random.PRNGKey(0), (WORLD_NOISE_SAMPLES,), jnp.float32))
    return out


def cli_numbers() -> dict:
    """The JAX CLI's summary numbers on the 2 s mixture written as a wav."""
    from exemplars_vc_tpu.pipelines.cli import main as jax_main
    from exemplars_vc_tpu_torch.io.standin import synthetic_mixture
    from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav

    def run(argv) -> dict:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            jax_main(argv)
        return json.loads(buf.getvalue().strip().splitlines()[-1])

    def energy(path) -> float:
        return float((read_wav(path, mono=False)[0].astype(np.float64) ** 2).sum())

    with tempfile.TemporaryDirectory() as d:
        wav = os.path.join(d, "mix.wav")
        write_wav(wav, synthetic_mixture(), 16000)
        sep = run(["separate", "--wav", wav, "--seed", "0", "--em-iters", "20",
                   "--out-dir", os.path.join(d, "sep")])
        lead = run(["separate-lead", "--wav", wav, "--model", "stereo", "--seed", "1",
                    "--iters", "15", "--components", "20", "--out-dir", os.path.join(d, "lead")])
        e_lead, e_acc = energy(lead["lead"]), energy(lead["accomp"])
        return {"cli_separate_nll_first": np.float64(sep["nll_first"]),
                "cli_separate_nll_last": np.float64(sep["nll_last"]),
                "cli_separate_energies": np.array([energy(p) for p in sep["out"]]),
                "cli_lead_share": np.float64(e_lead / (e_lead + e_acc)),
                "cli_lead_voiced_frames": np.int64(lead["voiced_frames"]),
                "cli_lead_f0_median": np.float64(lead["f0_median"])}


def main() -> None:
    import jax
    import jax.numpy as jnp

    if not jax.config.jax_threefry_partitionable:
        raise SystemExit("jax_threefry_partitionable is off: the port follows the "
                         "partitionable threefry")
    out = {"jax_version": np.array(jax.__version__), **primitive_draws(jax, jnp),
           **site_draws(jax, jnp), **cli_numbers()}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes, {len(out)} arrays)")


if __name__ == "__main__":
    sys.exit(main())
