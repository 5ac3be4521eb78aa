"""The port's beamforming (``exemplars_vc_tpu_torch/separate/beamform.py``) on
the CPU: counterparts of ``tests/test_beamform.py`` (distortionless response,
nulls, diagram geometry) and every function against the JAX package on the
same inputs (complex64 closed forms: 1e-5 relative; the MVDR solve κ(R)
times float32's unit roundoff; the diagram 1e-5 of its peak in linear
power)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus  # noqa: F401  (caps torch's threads)
from exemplars_vc_tpu.separate import beamform as jbf
from exemplars_vc_tpu_torch.separate.beamform import (
    apply_beamformer,
    directivity_diagram,
    mvdr_filter,
    ula_steering,
)

FREQS = np.linspace(100.0, 7900.0, 64)
CPU = "cpu"


def rel(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def steer(theta, n_sensors=2):
    return ula_steering([theta], FREQS, n_sensors=n_sensors, device=CPU)


def test_steering_vector_geometry():
    a = ula_steering([0.0, np.pi / 4], FREQS, n_sensors=3, device=CPU).numpy()
    assert a.shape == (2, 64, 3)
    np.testing.assert_allclose(a[0], np.ones_like(a[0]), atol=1e-6)   # broadside
    np.testing.assert_allclose(np.abs(a[1]), 1.0, atol=1e-6)


def test_mvdr_distortionless_and_nulls():
    at, ai = steer(0.3)[0], steer(-0.7)
    w = mvdr_filter(at, ai, diag_load=1e-6, device=CPU)
    g_t = torch.einsum("fc,fc->f", w.conj(), at).numpy()
    np.testing.assert_allclose(g_t.real, 1.0, atol=1e-4)
    np.testing.assert_allclose(g_t.imag, 0.0, atol=1e-4)
    g_i = torch.einsum("fc,tfc->tf", w.conj(), ai).abs().numpy()[0]
    assert np.median(g_i[8:]) < 1e-2


def test_directivity_diagram_peaks_at_target():
    th_t = 0.5
    w = mvdr_filter(steer(th_t)[0], device=CPU)
    thetas, diag = directivity_diagram(w, FREQS, n_thetas=181, device=CPU)
    diag = diag.numpy()
    assert diag.shape == (181, len(FREQS))
    k = int(np.argmin(np.abs(FREQS - 1000.0)))
    tgt = int(np.argmin(np.abs(thetas.numpy() - th_t)))
    assert diag[tgt, k] >= diag[:, k].max() - 1e-3
    assert abs(float(diag[tgt, k])) < 0.1


def _mixture(rng, at, ai, N=50):
    s = rng.standard_normal((len(FREQS), N)) + 1j * rng.standard_normal((len(FREQS), N))
    v = rng.standard_normal((len(FREQS), N)) + 1j * rng.standard_normal((len(FREQS), N))
    return s, s[..., None] * at[:, None, :] + v[..., None] * ai[:, None, :]


def test_apply_beamformer_recovers_target_from_mixture():
    at, ai = steer(0.4)[0].numpy(), steer(-0.9)[0].numpy()
    s, X = _mixture(np.random.default_rng(0), at, ai)
    w = mvdr_filter(at, ai[None], diag_load=1e-6, device=CPU)
    y = apply_beamformer(w, X, device=CPU).numpy()
    err = np.linalg.norm(y[8:] - s[8:]) / np.linalg.norm(s[8:])
    assert err < 0.05


def test_mvdr_accepts_single_interferer_as_2d():
    at, ai3 = steer(0.3)[0], steer(-0.7)
    w2 = mvdr_filter(at, ai3[0], diag_load=1e-6, device=CPU)
    w3 = mvdr_filter(at, ai3, diag_load=1e-6, device=CPU)
    np.testing.assert_allclose(w2.numpy(), w3.numpy(), atol=1e-6)


# ---- the port against the JAX package --------------------------------------


@pytest.mark.parametrize("n_sensors", [2, 3, 4])
def test_ula_steering_matches_jax(n_sensors):
    th = np.array([-1.2, -0.3, 0.0, 0.4, 1.5])
    got = ula_steering(th, FREQS, n_sensors=n_sensors, dist_inter_sensor=0.1, device=CPU)
    ref = jbf.ula_steering(jnp.asarray(th), jnp.asarray(FREQS), n_sensors, 0.1)
    assert rel(got.numpy(), ref) < 1e-5


@pytest.mark.parametrize("n_sensors,n_interf", [(2, 0), (2, 2), (3, 1), (4, 3)])
def test_mvdr_and_apply_match_jax(n_sensors, n_interf):
    rng = np.random.default_rng(n_sensors * 10 + n_interf)
    at = ula_steering([0.35], FREQS, n_sensors=n_sensors, device=CPU)[0].numpy()
    ai = (ula_steering(rng.uniform(-1.4, 1.4, n_interf), FREQS, n_sensors=n_sensors,
                       device=CPU).numpy() if n_interf else None)
    got = mvdr_filter(at, ai, diag_load=1e-3, device=CPU)
    ref = jbf.mvdr_filter(jnp.asarray(at), None if ai is None else jnp.asarray(ai), 1e-3)
    # R = Σ a aᴴ + 1e-3·I is ill-conditioned (κ up to ~1.6e4 here): the two
    # float32 solves agree to κ times float32's unit roundoff
    a64 = at.astype(np.complex128)
    R = a64[:, :, None] * a64[:, None, :].conj() + 1e-3 * np.eye(n_sensors)
    if ai is not None:
        R = R + (ai[..., :, None] * ai[..., None, :].conj()).sum(axis=0)
    kappa = np.linalg.cond(R).max()
    assert rel(got.numpy(), ref) < max(1e-5, kappa * 2.0 ** -23)
    X = (rng.standard_normal((len(FREQS), 20, n_sensors))
         + 1j * rng.standard_normal((len(FREQS), 20, n_sensors))).astype(np.complex64)
    y = apply_beamformer(got, X, device=CPU)
    assert rel(y.numpy(), jbf.apply_beamformer(jnp.asarray(got.numpy()), jnp.asarray(X))) < 1e-5


def test_directivity_diagram_matches_jax():
    at = ula_steering([0.5], FREQS, n_sensors=3, device=CPU)[0].numpy()
    ai = ula_steering([-0.6], FREQS, n_sensors=3, device=CPU).numpy()
    w = mvdr_filter(at, ai, diag_load=1e-4, device=CPU).numpy()
    th, got = directivity_diagram(w, FREQS, n_thetas=91, device=CPU)
    th_r, ref = jbf.directivity_diagram(jnp.asarray(w), jnp.asarray(FREQS), n_thetas=91)
    np.testing.assert_allclose(th.numpy(), np.asarray(th_r), atol=1e-6)
    # in linear power: near a null the dB value magnifies a roundoff-sized
    # response (5.8e-3 dB apart at −55 dB)
    assert rel(10.0 ** (got.numpy() / 10), 10.0 ** (np.asarray(ref) / 10)) < 1e-5


@pytest.mark.parametrize("name", ["ula_steering", "mvdr_filter", "directivity_diagram",
                                  "apply_beamformer"])
def test_entry_point_defaults_to_the_card(name):
    import inspect

    from exemplars_vc_tpu_torch.separate import beamform

    fn = getattr(beamform, name)
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    w = np.ones((4, 2), np.complex64)
    args = {"ula_steering": ([0.1], FREQS[:4]), "mvdr_filter": (w,),
            "directivity_diagram": (w, FREQS[:4]),
            "apply_beamformer": (w, np.ones((4, 3, 2), np.complex64))}[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fn(*args)
