"""The quality preset as the benchmark serves it (``stft-quality.serve``):
the port against the benchmark's plain reference
(``benchmark/reference/quality.py``), on the CPU at a small size.

Tolerances, each with its reason:

- the KL solve: the port and the reference make the same float32 products
  in the same order on the CPU (the recon's twin is ``H @ A``), so H agrees
  within 1e-6 relative L2 and n_iter is equal; the errors agree within 1e-5
  relative, since the two define D_KL's guard differently (the port clamps
  H·A at float32's eps, the reference at float64's, as sklearn). The same
  solve with its products in TF32 (operands rounded to 10 mantissa bits, as
  the card's TF32 matmul does) fails these;
- the VTLP expansion: the port forms each bin's source position j / α in
  float32 and warps by a (D, D) interpolation operator in one product; the
  reference forms the positions in float64 and gathers the two neighbour
  bins. An ulp of float32 at position 200 is 1.5e-5, so the weights differ
  by up to ~1.4e-5 (half an ulp, and α's own rounding carried to 200): within
  2e-5 of the largest entry, the original rows and the zero rows exact;
- the box filter: the same 2s + 1 float32 terms summed in another order:
  within 1e-6 relative;
- one ``Converter.convert`` under the cell's settings against the
  reference's conversion of the same clip: all of the above and 5
  Griffin-Lim iterations, within 1e-5 relative L2 on the audio (measured
  ~1e-6), and the same MU steps.

Also: a KL solve asks ``nmf_recon`` for 1 + n_iter reconstructions (the
error check's P feeds the next step) and ``nmf_kl_update`` for n_iter
updates, and its H and error are bit-equal on the CPU to the formulation
it replaced (a fresh H·A each step and each check, and F × K
temporaries); ``nmf_kl_update`` on CPU tensors is the step's old three ops
(``torch.mm`` into a buffer, ``div_``, ``mul_``) bit for bit."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark.harness.bench import program_config
from benchmark.reference import quality as ref
from exemplars_vc_tpu_torch.factorize import nmf, nmf_cuda
from exemplars_vc_tpu_torch.factorize.nmf import EPS, _kl_error, _mu_loop
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.io.wav import read_wav
from exemplars_vc_tpu_torch.pipelines import convert as tconvert
from exemplars_vc_tpu_torch.pipelines.serve import Converter
from torch_corpus import rel_l2, write_synthetic_corpus

ROOT = Path(__file__).resolve().parents[1]
CONFIG = ROOT / "benchmark" / "configs" / "vcc2016-sf1-tf1-stft-quality.json"
WARPS = (0.9, 0.95, 1.05, 1.1)


def _kl_inputs(F=40, K=1536, D=201, seed=0):
    """Magnitude-like X (a sparse mix of A's rows plus a floor) and A with
    zero padding rows at the end of each of its five blocks."""
    g = torch.Generator().manual_seed(seed)
    A = torch.rand((K, D), generator=g) * torch.linspace(1.0, 0.01, D)
    blk = K // 5
    A[torch.arange(K) % blk >= blk - 17] = 0.0
    mix = torch.zeros((F, K))
    mix.scatter_(1, torch.randint(0, K, (F, 6), generator=g), torch.rand((F, 6), generator=g))
    return mix @ A + 1e-3 * torch.rand((F, D), generator=g), A


def _tf32(t):
    """float32 rounded to TF32's 10 mantissa bits (nearest)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


@pytest.fixture
def tf32_products(monkeypatch):
    """The port's KL products made as a TF32 matmul makes them."""
    mm = torch.mm

    def tf32_mm(a, b, out=None):
        return mm(_tf32(a), _tf32(b), out=out)
    monkeypatch.setattr(nmf, "nmf_recon", lambda H, A: _tf32(H) @ _tf32(A))
    monkeypatch.setattr(torch, "mm", tf32_mm)


def _solve_agrees(st, H, n_iter, X, A):
    return (st.n_iter == n_iter
            and float(torch.linalg.norm(st.H - H) / torch.linalg.norm(H)) <= 1e-6
            and abs(float(st.error) - float(ref.kl_error(X, H @ A))) <= 1e-5 * float(st.error))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kl_solve_matches_the_reference(seed):
    X, A = _kl_inputs(seed=seed)
    H, n_iter = ref.kl_solve(X, A, 1e-4, 150)
    st = nmf.nmf_activations(X, A, beta_loss="kl", tol=1e-4, max_iter=150)
    assert 10 <= n_iter <= 150
    assert _solve_agrees(st, H, n_iter, X, A)
    assert float(H.abs().sum(dim=0)[A.sum(dim=1) == 0].max()) == 0.0   # padding rows stay off


def test_kl_solve_in_tf32_fails_the_tolerances(tf32_products):
    X, A = _kl_inputs(seed=0)
    H, n_iter = ref.kl_solve(X, A, 1e-4, 150)
    st = nmf.nmf_activations(X, A, beta_loss="kl", tol=1e-4, max_iter=150)
    assert not _solve_agrees(st, H, n_iter, X, A)


def test_vtlp_expansion_matches_the_reference():
    g = torch.Generator().manual_seed(4)
    A = torch.rand((37, 201), generator=g)
    B = torch.rand((37, 201), generator=g) * 3.0
    A[-5:], B[-5:] = 0.0, 0.0
    A2, B2 = tconvert._augment_dicts({"stft": (A, B)}, WARPS)["stft"]
    assert A2.shape == B2.shape == (5 * 37, 201)
    for M, M2 in ((A, A2), (B, B2)):
        want = torch.cat([M] + [ref.vtlp(M, a) for a in WARPS])
        assert torch.equal(M2[:37], M)
        assert float((M2 - want).abs().max()) <= 2e-5 * float(M.abs().max())
        assert float(M2.view(5, 37, 201)[:, -5:].abs().max()) == 0.0


@pytest.mark.parametrize("F", [1, 3, 4, 5, 40])
@pytest.mark.parametrize("s", [1, 2])
def test_h_smooth_matches_the_reference(F, s):
    """Within 1e-6 of the reference, and bit-equal to the sum of 2s + 1
    gathered copies that the port's in-place sum replaced."""
    H = torch.rand((F, 300), generator=torch.Generator().manual_seed(F + 10 * s))
    got = tconvert._smooth_h(H, s)
    torch.testing.assert_close(got, ref.smooth(H, s), rtol=1e-6, atol=0.0)
    base = torch.arange(F)
    gathers = sum(H[(base + d).clamp(0, F - 1)] for d in range(-s, s + 1)) / (2 * s + 1)
    assert torch.equal(got, gathers)


def test_converter_matches_the_reference_under_the_cells_settings(tmp_path):
    settings = json.loads(CONFIG.read_text())["settings"]
    settings.update({"misc.nb_file": 3, "nmf.max_iter": 20, "nmf.griffin_lim_iters": 5})
    data, src, _ = write_synthetic_corpus(tmp_path / "corpus")
    conv = Converter(program_config(settings), ArtifactStore(str(tmp_path / "store")), data,
                     device="cpu")
    A, B = conv.dicts["stft"]
    dicts = ref.build_dictionaries(settings, data, "cpu")
    assert A.shape == dicts["stft"][0].shape and A.shape[0] % (5 * 512) == 0
    assert rel_l2(B.numpy(), dicts["stft"][1].numpy()) < 1e-6
    got = conv.convert(src)
    x, _ = read_wav(src)
    want, steps = ref.convert_one(np.asarray(x, np.float64), dicts, settings, "cpu")
    assert got.nmf_iters == steps
    assert got.audio.shape == want.shape and rel_l2(got.audio, want) <= 1e-5


def _old_kl(X, A, tol, max_iter, l1):
    """The KL solve before it took its P from ``nmf_recon``."""
    F, K = X.shape[0], A.shape[0]
    H = torch.sqrt(torch.clamp(X.mean(), min=0.0) / K).expand(F, K).contiguous()
    den = A.sum(dim=1)[None, :] + l1
    den = torch.where(den == 0.0, EPS, den)

    def step(H):
        ratio = X / torch.clamp(H @ A, min=EPS)
        return H * ((ratio @ A.T) / den)

    def error(H):
        return _kl_error(X, H @ A)
    return _mu_loop(H, step, error, tol, max_iter, 10)


@pytest.mark.parametrize("tol,max_iter,l1", [(1e-4, 150, 0.0), (0.0, 25, 0.0), (1e-4, 60, 0.3)])
def test_kl_solve_makes_one_recon_a_step_and_the_old_bits(monkeypatch, tol, max_iter, l1):
    X, A = _kl_inputs(F=33, K=1024, seed=5)
    calls, updates = [], []
    recon, update = nmf.nmf_recon, nmf.nmf_kl_update

    def counted(H, A):
        calls.append(1)
        return recon(H, A)

    def counted_update(*args, **kw):
        updates.append(1)
        return update(*args, **kw)
    monkeypatch.setattr(nmf, "nmf_recon", counted)
    monkeypatch.setattr(nmf, "nmf_kl_update", counted_update)
    st = nmf.nmf_activations(X, A, beta_loss="kl", tol=tol, max_iter=max_iter, l1=l1)
    H, n_iter, err = _old_kl(X, A, tol, max_iter, l1)
    assert len(calls) == 1 + st.n_iter and len(updates) == st.n_iter
    assert st.n_iter == n_iter
    assert torch.equal(st.H, H) and torch.equal(st.error, err)


@pytest.mark.parametrize("l1", [0.0, 0.3])
@pytest.mark.parametrize("in_place", [False, True])
def test_kl_update_on_the_cpu_is_the_old_three_ops(l1, in_place):
    """``nmf_kl_update`` on CPU tensors against the step it replaced
    (``torch.mm(R, Aᵀ, out=G)``, ``G.div_(den)``, ``H.mul_(G)``), bit for bit,
    in place and out of place, zero rows of A (den = EPS) included."""
    X, A = _kl_inputs(F=21, K=700, seed=7)
    H = torch.rand((21, 700), generator=torch.Generator().manual_seed(8)) * 0.05
    R = X / torch.clamp(H @ A, min=EPS)
    den = A.sum(dim=1)[None, :] + l1
    den = torch.where(den == 0.0, EPS, den)
    G = torch.empty((21, 700))
    torch.mm(R, A.T, out=G)
    want = H.clone().mul_(G.div_(den))
    At = nmf_cuda.nmf_kl_operand(A)
    before = nmf_cuda.nmf_kl_update.launches
    if in_place:
        Hin = H.clone()
        assert nmf_cuda.nmf_kl_update(R, At, Hin, den, out=Hin) is Hin
        got = Hin
    else:
        got = nmf_cuda.nmf_kl_update(R, At, H, den)
    assert torch.equal(got, want)
    assert nmf_cuda.nmf_kl_update.launches == before     # the twin: no kernel launch
    if l1 == 0.0:
        assert bool((got[:, A.sum(dim=1) == 0] == 0).all())
