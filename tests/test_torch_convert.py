"""The port's whole STFT conversion slice against the JAX reference on a
tiny synthetic corpus (3 seeded vowel-sequence pairs of ≤ 0.6 s, written as
wavs), with the NMF and Griffin-Lim budgets cut small.

Tolerances: the DTW paths are integer and equal; the converted magnitude
agrees within 1e-3 relative L2 and the audio within 1e-3 relative L2 (float32
rounding through 20 MU steps and 5 Griffin-Lim iterations; measured ~1e-6);
the MCD within 0.05 dB."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from exemplars_vc_tpu.config import load_config as jload_config
from exemplars_vc_tpu.io.store import ArtifactStore as JArtifactStore
from exemplars_vc_tpu.pipelines import convert as jconvert
from exemplars_vc_tpu.pipelines.make_dict import make_dictionary as jmake_dictionary
from exemplars_vc_tpu_torch.config import load_config
from exemplars_vc_tpu_torch.io.standin import build_standin_corpus
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.io.wav import write_wav
from exemplars_vc_tpu_torch.pipelines import convert as tconvert
from exemplars_vc_tpu_torch.pipelines.make_dict import from_jax_artifacts, make_dictionary

SR = 16000
VOWELS = [(730, 1090), (270, 2290), (300, 870), (530, 1840), (640, 1190)]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _utterance(rng, order, f0, formant_scale, seg_s):
    """A sequence of vowels: harmonics of f0 weighted by two resonances."""
    out = []
    for v, dur in zip(order, seg_s):
        n = int(dur * SR)
        t = np.arange(n) / SR
        f1, f2 = (f * formant_scale for f in VOWELS[v])
        x = np.zeros(n)
        for k in range(1, int(4000 / f0)):
            fk = k * f0
            amp = 1.0 / (1 + ((fk - f1) / 90.0) ** 2) + 0.6 / (1 + ((fk - f2) / 120.0) ** 2)
            x += amp * np.sin(2 * np.pi * fk * t + rng.uniform(0, 2 * np.pi))
        out.append(x * np.hanning(n))
    x = np.concatenate(out)
    return (0.3 * x / np.abs(x).max() + 0.002 * rng.standard_normal(len(x))).astype(np.float32)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("synthetic_corpus")
    rng = np.random.default_rng(0)
    for spk in ("SF1", "TF1"):
        os.makedirs(root / "data" / spk)
    os.makedirs(root / "wav")
    for k in range(4):
        order = rng.permutation(5)[:4]
        seg = rng.uniform(0.09, 0.14, 4)
        src = _utterance(rng, order, 120.0, 1.0, seg)
        tar = _utterance(rng, order, 210.0, 1.15, seg * rng.uniform(0.85, 1.15, 4))
        if k < 3:
            write_wav(str(root / "data" / "SF1" / f"10000{k + 1}.wav"), src, SR)
            write_wav(str(root / "data" / "TF1" / f"10000{k + 1}.wav"), tar, SR)
        else:
            write_wav(str(root / "wav" / "SF1_100162.wav"), src, SR)
            write_wav(str(root / "wav" / "TF1_100162.wav"), tar, SR)
    return str(root / "data"), str(root / "wav" / "SF1_100162.wav"), \
        str(root / "wav" / "TF1_100162.wav")


OVERRIDES = ["data.tar=TF1", "misc.nb_file=3", "nmf.max_iter=20"]


@pytest.fixture(scope="module")
def cfg():
    """The port's config; ``jcfg`` is the JAX package's, from the same overrides."""
    return load_config(overrides=OVERRIDES)


@pytest.fixture(scope="module")
def jcfg():
    return jload_config(overrides=OVERRIDES)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _assert_same_conversion(got, ref):
    Y, Yr = got.converted["stft"].numpy(), np.asarray(ref.converted["stft"])
    assert Y.shape == Yr.shape
    assert _rel_l2(Y, Yr) < 1e-3
    assert got.audio.shape == ref.audio.shape and np.isfinite(got.audio).all()
    assert _rel_l2(got.audio, ref.audio) < 1e-3
    assert got.n_iter == ref.n_iter
    assert abs(got.mcd_vs_reference - ref.mcd_vs_reference) < 0.05


def test_convert_utterance_matches_jax(corpus, cfg, jcfg, tmp_path):
    data, src, tar = corpus
    ref = jconvert.convert_utterance(jcfg, JArtifactStore(str(tmp_path / "j")), data, src,
                                     nb_file=3, synth_iters=5, reference_wav=tar)
    got = tconvert.convert_utterance(cfg, ArtifactStore(str(tmp_path / "t")), data, src,
                                     nb_file=3, synth_iters=5, reference_wav=tar,
                                     device="cpu")
    _assert_same_conversion(got, ref)
    assert got.nmf_shape == (ref.audio.shape[0] // 80 + 1, 512, 201)
    assert set(got.timings) == {"dicts", "features", "nmf_solve", "synthesis"}

    # the dictionary: the same DTW paths as the JAX package's
    jart = jmake_dictionary(jcfg, JArtifactStore(str(tmp_path / "j")), data, nb_file=3)
    tart = make_dictionary(cfg, ArtifactStore(str(tmp_path / "t")), data, nb_file=3,
                           device="cpu")          # a store hit: the saved artifact
    for name in ("path_i", "path_j", "path_len", "len_a", "len_b"):
        np.testing.assert_array_equal(getattr(tart, name).numpy(),
                                      np.asarray(getattr(jart, name)))
    np.testing.assert_allclose(tart.feat_a.numpy(), np.asarray(jart.feat_a),
                               rtol=1e-5, atol=1e-4)


def test_convert_with_jax_dictionary(corpus, cfg, jcfg, tmp_path):
    """A dictionary built by the JAX package, carried over with
    ``from_jax_artifacts``, holds NMF + Griffin-Lim + synthesis parity apart
    from any DTW difference."""
    data, src, tar = corpus
    jstore = JArtifactStore(str(tmp_path / "j"))
    jmake_dictionary(jcfg, jstore, data, nb_file=3)
    arrays = jstore.load("exemplar_dict_SF12TF1_mfcc_3")
    art = from_jax_artifacts(arrays, "cpu")
    assert art.path_i.dtype == torch.int32 and art.feat_a.dtype == torch.float32
    np.testing.assert_array_equal(art.path_i.numpy(), arrays["path_i"])
    tstore = ArtifactStore(str(tmp_path / "t"))
    tstore.save("exemplar_dict_SF12TF1_mfcc_3_torch", **art.to_numpy())
    ref = jconvert.convert_utterance(jcfg, jstore, data, src, nb_file=3, synth_iters=5,
                                     reference_wav=tar)
    got = tconvert.convert_utterance(cfg, tstore, data, src, nb_file=3, synth_iters=5,
                                     reference_wav=tar, device="cpu")
    _assert_same_conversion(got, ref)


def test_fused_path_matches_jax(corpus, cfg, jcfg, tmp_path):
    """The opt-in fused path as a whole: the single-kernel MU solve, Y = H·B
    and the fused (center=False) Griffin-Lim, then the centered ISTFT, JAX
    (Pallas kernels in interpret mode) against the port (the twins on the
    CPU), on the same X, A, B and seed phases; the dictionary is the JAX
    package's, carried over with ``from_jax_artifacts``. Tolerance: 1e-3
    relative L2 on the converted magnitude and the audio, float32 rounding
    through 20 MU steps and 5 GL iterations (as the default path's test)."""
    import jax.numpy as jnp

    from exemplars_vc_tpu.dsp.griffin_lim_pallas import gl_angles_fused as jgl_fused
    from exemplars_vc_tpu.dsp.stft import istft as jistft
    from exemplars_vc_tpu.factorize.nmf import convert_features as jconvert_features
    from exemplars_vc_tpu.factorize.nmf_pallas import nmf_activations_pallas
    from exemplars_vc_tpu_torch.dsp.griffin_lim_cuda import gl_angles_fused
    from exemplars_vc_tpu_torch.dsp.stft import istft
    from exemplars_vc_tpu_torch.factorize.nmf import convert_features, nmf_activations
    from exemplars_vc_tpu_torch.io.wav import read_wav
    from exemplars_vc_tpu_torch.pipelines.conv_dicts import extract_stft_complex

    data, src, _ = corpus
    jstore = JArtifactStore(str(tmp_path / "j"))
    jmake_dictionary(jcfg, jstore, data, nb_file=3)
    tstore = ArtifactStore(str(tmp_path / "t"))
    art = from_jax_artifacts(jstore.load("exemplar_dict_SF12TF1_mfcc_3"), "cpu")
    tstore.save("exemplar_dict_SF12TF1_mfcc_3_torch", **art.to_numpy())
    dicts, _ = tconvert._aligned_dicts(cfg, tstore, data, 3, torch.device("cpu"))
    A, B = dicts["stft"]
    x, _ = read_wav(src)
    S = extract_stft_complex(x, cfg, "cpu")
    X = torch.abs(S)
    ang0 = torch.where(X > 0, S / torch.clamp(X, min=1e-16),
                       torch.ones((), dtype=torch.complex64))
    n_fft, hop, iters = cfg.mcep.frame_length, cfg.mcep.hop_length, 5

    ref = nmf_activations_pallas(jnp.asarray(X.numpy()), jnp.asarray(A.numpy()),
                                 tol=cfg.nmf.tol, max_iter=cfg.nmf.max_iter, tile_f=8,
                                 tile_k=128, interpret=True, fused=True)
    Yj = jconvert_features(ref.H, jnp.asarray(B.numpy()))
    angj = jgl_fused(Yj, jnp.asarray(ang0.numpy()), n_fft, hop, iters, 0.9, interpret=True)
    yj = np.asarray(jistft(Yj * angj, n_fft=n_fft, hop_length=hop, length=len(x)))

    st = nmf_activations(X, A, tol=cfg.nmf.tol, max_iter=cfg.nmf.max_iter, fused=True)
    Y = convert_features(st.H, B)
    ang = gl_angles_fused(Y, ang0, n_fft, hop, iters, 0.9)
    y = istft(Y * ang, n_fft=n_fft, hop_length=hop, length=len(x)).numpy()

    assert st.n_iter == int(ref.n_iter)
    assert _rel_l2(Y.numpy(), np.asarray(Yj)) < 1e-3
    assert y.shape == x.shape and np.isfinite(y).all()
    assert _rel_l2(y, yj) < 1e-3


@pytest.mark.parametrize("override", [
    "nmf.context_frames=2", "nmf.h_smooth=1", "nmf.solve_domain=mel",
    "nmf.normalize_exemplars=true", "nmf.prune_topk=4", "nmf.activation_power=1.5",
    "data.dict_augment_warps=0.9", "data.dict_prune_frac=0.1",
    "data.dict_hop_divisor=2", "data.use_stft=false", "nmf.solver=qr",
])
def test_unported_levers_raise(override, corpus, tmp_path):
    data, src, _ = corpus
    c = load_config(overrides=["misc.nb_file=3", override])
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        tconvert.convert_utterance(c, ArtifactStore(str(tmp_path)), data, src, device="cpu")


def test_standin_corpus_layout(tmp_path):
    from exemplars_vc_tpu_torch.io.store import load_speaker

    data, src, tar = build_standin_corpus(str(tmp_path), n_pairs=8)
    for spk in ("SF1", "TF1"):
        sigs, sr = load_speaker(data, spk, use_native=False)
        assert len(sigs) == 8 and sr == SR
        assert max(1 + len(s) // 80 for s in sigs) == 1370    # the 1408-frame bucket
    assert os.path.basename(src) == "SF1_100162.wav" and os.path.isfile(tar)


def test_port_imports_no_jax():
    code = ("import exemplars_vc_tpu_torch.pipelines.convert, chip_smoke, sys; "
            "assert 'jax' not in sys.modules, 'jax imported'")
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
