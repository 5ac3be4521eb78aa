"""The port's public surface against the JAX package's: the thin public
functions over modules the port already had (``build_exemplar_dicts``,
``stft_magnitude``, ``extract_stft_features_stacked``/``_batch``,
``mcep_to_spectrum``, ``spectral_convergence``, ``trace_to``,
``warping_forward``/``_batch``), each held to its JAX counterpart on the
same seeded numpy inputs, and the names that every module and package
``__init__`` of the JAX package exports.

Tolerances: gathers are bit-equal; magnitudes rtol 1e-5 with a floor of
1e-5 of the peak (float32 FFTs in another order, as ``test_torch_dsp.py``);
``mcep_to_spectrum`` rtol 1e-5 (a float32 product of ≤ 40 terms under an
exp); ``spectral_convergence`` rtol 1e-6 and exactly 0 for identical inputs;
the warping net's forwards atol 1e-5 (as ``test_torch_warping.py``)."""

import ast
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_corpus
from exemplars_vc_tpu.align import exemplar as jexemplar
from exemplars_vc_tpu.config import load_config as jload_config
from exemplars_vc_tpu.models import warping as jwarp
from exemplars_vc_tpu.obs import metrics as jmetrics
from exemplars_vc_tpu.pipelines import conv_dicts as jconv
from exemplars_vc_tpu_torch.align.dtw import dtw_batch
from exemplars_vc_tpu_torch.align.exemplar import build_exemplar_dicts, build_exemplar_dicts_padded
from exemplars_vc_tpu_torch.config import load_config
from exemplars_vc_tpu_torch.dsp.mcep import mcep_to_spectrum
from exemplars_vc_tpu_torch.dsp.stft import stft, stft_magnitude
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.models import warping as twarp
from exemplars_vc_tpu_torch.obs.metrics import spectral_convergence
from exemplars_vc_tpu_torch.obs.profiling import trace_to
from exemplars_vc_tpu_torch.pipelines import conv_dicts
from exemplars_vc_tpu_torch.pipelines.make_dict import speaker_batch, trim_and_mask

# the JAX package's dsp/__init__ re-exports functions under the module names
jmcep = importlib.import_module("exemplars_vc_tpu.dsp.mcep")
jstft = importlib.import_module("exemplars_vc_tpu.dsp.stft")

REPO = Path(__file__).resolve().parents[1]
JAX_PKG, PORT_PKG = REPO / "exemplars_vc_tpu", REPO / "exemplars_vc_tpu_torch"

# ROADMAP.md, "Not to port": JAX modules with no counterpart (None) or whose
# place a CUDA wrapper takes, and public names the port leaves out
NOT_TO_PORT_MODULES = {
    "runtime.py": None,                                  # the TPU runtime's XLA cache
    "dsp/fft.py": None,                                  # matmul-DFT: torch.fft instead
    "align/dtw_pallas.py": "align/dtw_cuda.py",
    "factorize/nmf_pallas.py": "factorize/nmf_cuda.py",
    "dsp/griffin_lim_pallas.py": "dsp/griffin_lim_cuda.py",
}
NOT_TO_PORT_NAMES = {
    ("separate/glue.py", "first_source"),                # works round the TPU's complex slicing
    ("io/store.py", "stacked_speaker_batch"),            # the port's make_dict.speaker_batch
}


def _close(got, ref, rtol=1e-5, floor=1e-5):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=floor * np.abs(ref).max())


def _signals(seed: int, lengths) -> list[np.ndarray]:
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        t = np.arange(n) / 16000.0
        x = sum(np.sin(2 * np.pi * 150.0 * k * t + rng.uniform(0, 6)) / k for k in range(1, 9))
        out.append((0.2 * x + 0.01 * rng.standard_normal(n)).astype(np.float32))
    return out


# -- align: the ragged exemplar dictionaries ---------------------------------

def _padded_paths(rng, lens, p, t):
    """(N, p) monotone index paths, −1 past each length."""
    pi = np.full((len(lens), p), -1, np.int32)
    pj = np.full((len(lens), p), -1, np.int32)
    for n, ln in enumerate(lens):
        pi[n, :ln] = np.sort(rng.integers(0, t, ln))
        pj[n, :ln] = np.sort(rng.integers(0, t, ln))
    return pi, pj


@pytest.mark.parametrize("lens", [(24, 7, 12), (5, 0, 24)],
                         ids=["zero_length_padding_tail", "zero_length_path"])
def test_build_exemplar_dicts_is_bit_equal_to_jax(lens):
    """Paths padded with −1; one pair's path fills all 24 slots (a padding
    tail of length 0), and in the second case another pair has no path."""
    rng = np.random.default_rng(4)
    fa = rng.standard_normal((3, 30, 6)).astype(np.float32)
    fb = rng.standard_normal((3, 30, 6)).astype(np.float32)
    pi, pj = _padded_paths(rng, lens, 24, 30)
    plen = np.asarray(lens, np.int32)
    ref_a, ref_b = jexemplar.build_exemplar_dicts(fa, fb, pi, pj, plen)
    assert ref_a.shape == (sum(lens), 6)
    for args in ((fa, fb, pi, pj, plen),
                 tuple(torch.as_tensor(a) for a in (fa, fb, pi, pj, plen))):
        A, B = build_exemplar_dicts(*args)
        assert isinstance(A, torch.Tensor) and A.dtype == torch.float32
        np.testing.assert_array_equal(A.numpy(), ref_a)
        np.testing.assert_array_equal(B.numpy(), ref_b)


def test_build_exemplar_dicts_keeps_the_padded_rows_on_dtw_paths():
    """On the port's DTW paths the ragged rows are the rows that
    ``build_exemplar_dicts_padded`` packs first, bit for bit, and the JAX
    function gives the same rows from the same paths."""
    rng = np.random.default_rng(5)
    la, lb = np.asarray([40, 23, 31], np.int32), np.asarray([35, 40, 18], np.int32)
    fa = rng.standard_normal((3, 40, 8)).astype(np.float32)
    fb = rng.standard_normal((3, 40, 8)).astype(np.float32)
    fa[np.arange(40)[None, :] >= la[:, None]] = 0.0
    fb[np.arange(40)[None, :] >= lb[:, None]] = 0.0
    r = dtw_batch(torch.as_tensor(fa), torch.as_tensor(fb), la, lb)
    A, B = build_exemplar_dicts(torch.as_tensor(fa), torch.as_tensor(fb), r.path_i, r.path_j,
                                r.path_len)
    k = int(r.path_len.sum())
    Ap, Bp = build_exemplar_dicts_padded(torch.as_tensor(fa), torch.as_tensor(fb), r.path_i,
                                         r.path_j, k_pad=k)
    assert A.shape == (k, 8) and torch.equal(A, Ap) and torch.equal(B, Bp)
    ref_a, ref_b = jexemplar.build_exemplar_dicts(fa, fb, r.path_i.numpy(), r.path_j.numpy(),
                                                  r.path_len.numpy())
    np.testing.assert_array_equal(A.numpy(), ref_a)
    np.testing.assert_array_equal(B.numpy(), ref_b)


# -- dsp ---------------------------------------------------------------------

@pytest.mark.parametrize("shape,kw", [((4000,), {}),
                                      ((2, 3000), dict(n_fft=256, hop_length=64)),
                                      ((3000,), dict(n_fft=512, hop_length=128,
                                                     window="hamming"))])
def test_stft_magnitude_matches_jax(shape, kw):
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    got = stft_magnitude(torch.as_tensor(x), **kw)
    _close(got.numpy(), jstft.stft_magnitude(jnp.asarray(x), **kw))
    assert torch.equal(got, torch.abs(stft(torch.as_tensor(x), **kw)))


@pytest.mark.parametrize("order", [24, 39])
@pytest.mark.parametrize("alpha", [0.42, 0.55])
def test_mcep_to_spectrum_matches_jax(order, alpha):
    rng = np.random.default_rng(order)
    c = (rng.standard_normal((2, 7, order + 1)) / (1.0 + np.arange(order + 1))).astype(np.float32)
    ref = np.asarray(jmcep.mcep_to_spectrum(jnp.asarray(c), alpha=alpha))
    got = mcep_to_spectrum(torch.as_tensor(c), alpha=alpha).numpy()
    assert got.shape == (2, 7, 257)
    np.testing.assert_allclose(got, ref, rtol=1e-5)


# -- obs ---------------------------------------------------------------------

def test_spectral_convergence_matches_jax():
    rng = np.random.default_rng(7)
    ref = np.abs(rng.standard_normal((50, 201))).astype(np.float32)
    est = (ref * (1 + 0.1 * rng.standard_normal(ref.shape))).astype(np.float32)
    zero = np.zeros_like(ref)
    for a, b in ((est, ref), (ref, est), (est, zero)):
        got = spectral_convergence(torch.as_tensor(a), torch.as_tensor(b))
        np.testing.assert_allclose(float(got), float(jmetrics.spectral_convergence(
            jnp.asarray(a), jnp.asarray(b))), rtol=1e-6)
    assert float(spectral_convergence(torch.as_tensor(ref), torch.as_tensor(ref))) == 0.0


def test_trace_to_writes_a_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with trace_to(str(log_dir)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    traces = list(log_dir.rglob("*.pt.trace.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any(ev.get("name") == "aten::mm" for ev in events)


# -- models ------------------------------------------------------------------

VARIANTS = {"unidirectional": dict(),
            "bidirectional": dict(bidirectional=True),
            "deep_head": dict(deep_head=True, fc_neurons=64),
            "bidirectional_deep_head": dict(bidirectional=True, deep_head=True,
                                            fc_neurons=32)}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_warping_forward_matches_jax(variant):
    """``warping_forward`` (T, in) and ``warping_forward_batch`` (N, T, in)
    of the JAX parameters carried over by ``warping_params_from_jax``; the
    ``fc4`` head and the ``fc1-3`` head."""
    kw = VARIANTS[variant]
    params = jwarp.init_warping_params(jax.random.PRNGKey(3), jwarp.WarpingNetConfig(**kw))
    net = twarp.warping_params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                        twarp.WarpingNetConfig(**kw))
    x = np.random.default_rng(8).standard_normal((3, 25, 20)).astype(np.float32)
    with torch.no_grad():
        got_b = twarp.warping_forward_batch(net, torch.as_tensor(x)).numpy()
        got_1 = twarp.warping_forward(net, torch.as_tensor(x[1])).numpy()
    np.testing.assert_allclose(
        got_b, np.asarray(jwarp.warping_forward_batch(params, jnp.asarray(x))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(
        got_1, np.asarray(jwarp.warping_forward(params, jnp.asarray(x[1]))), rtol=0, atol=1e-5)
    assert got_1.shape == (25, 20)


# -- pipelines: the |STFT| feature batch --------------------------------------

def test_extract_stft_features_stacked_and_batch_match_jax():
    sigs = _signals(9, [3000, 5123, 4100, 80])
    cfg, jcfg = load_config(), jload_config()
    mags, lens = conv_dicts.extract_stft_features_stacked(sigs, cfg, device="cpu")
    ref, ref_lens = jconv.extract_stft_features_stacked(sigs, jcfg)
    ref = np.asarray(ref)
    assert lens.dtype == np.int32 and np.array_equal(lens, np.asarray(ref_lens))
    assert mags.shape == ref.shape and mags.device.type == "cpu"
    _close(mags.numpy(), ref)
    for i, n in enumerate(lens):
        assert torch.count_nonzero(mags[i, n:]) == 0
    got = conv_dicts.extract_stft_features_batch(sigs, cfg, device="cpu")
    for g, r in zip(got, jconv.extract_stft_features_batch(sigs, jcfg), strict=True):
        _close(g.numpy(), np.asarray(r))


@pytest.mark.parametrize("name", ["extract_stft_features_stacked",
                                  "extract_stft_features_batch"])
def test_stft_feature_batch_defaults_to_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        getattr(conv_dicts, name)(_signals(1, [800]), load_config())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return torch_corpus.write_synthetic_corpus(tmp_path_factory.mktemp("surface"))


def test_build_conversion_dicts_keeps_its_bits(corpus, tmp_path):
    """``build_conversion_dicts`` (STFT) through
    ``extract_stft_features_stacked`` gives the bits of the computation it
    inlined before (the speaker's padded batch, one |STFT|, the mask), and
    the JAX package's magnitudes within the STFT tolerance."""
    data = corpus[0]
    cfg = load_config(overrides=torch_corpus.OVERRIDES)
    got = conv_dicts.build_conversion_dicts(cfg, ArtifactStore(str(tmp_path / "s")), data,
                                            "SF1", device="cpu")
    m = cfg.mcep
    batch, samples = speaker_batch(data, "SF1", cfg.misc.nb_file,
                                   m.hop_length * cfg.data.frame_bucket, cfg.misc.cpu_rate)
    lens = (1 + samples // m.hop_length).astype(np.int32)
    mags = torch.abs(stft(torch.as_tensor(batch), n_fft=m.frame_length,
                          hop_length=m.hop_length, window=m.window))
    before = trim_and_mask(mags, mags.shape[1], torch.as_tensor(lens))
    assert got.kind == "stft" and torch.equal(got.feats["stft"], before)
    assert got.lens.dtype == lens.dtype and np.array_equal(got.lens, lens)
    from exemplars_vc_tpu.io.store import ArtifactStore as JArtifactStore

    ref = jconv.build_conversion_dicts(jload_config(overrides=torch_corpus.OVERRIDES),
                                       JArtifactStore(str(tmp_path / "j")), data, "SF1")
    _close(got.feats["stft"].numpy(), np.asarray(ref.feats["stft"]))
    assert np.array_equal(got.lens, np.asarray(ref.lens))


# -- the export surface -------------------------------------------------------

def _jax_inits():
    return sorted(JAX_PKG.rglob("__init__.py"))


def _exported(init: Path) -> list[str]:
    """The names a JAX ``__init__.py`` imports from its package, read with
    ``ast`` (JAX is not imported for it)."""
    names = []
    for node in ast.parse(init.read_text()).body:
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("exemplars_vc_tpu"):
            names += [a.asname or a.name for a in node.names]
    return names


def _module_name(path: Path, root: Path) -> str:
    parts = path.relative_to(root.parent).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _port_of(name: str) -> str:
    return name.replace("exemplars_vc_tpu", "exemplars_vc_tpu_torch", 1)


def _is_ports_own(obj) -> bool:
    return getattr(obj, "__module__", "").startswith("exemplars_vc_tpu_torch")


@pytest.mark.parametrize("init", _jax_inits(), ids=lambda p: str(p.relative_to(REPO)))
def test_package_exports_match_jax(init):
    """Every name a JAX package exports imports from the port's package of
    the same path, and is the port's own."""
    names = _exported(init)
    assert names, init
    pkg = importlib.import_module(_port_of(_module_name(init, JAX_PKG)))
    missing = [n for n in names if not hasattr(pkg, n)]
    assert not missing, f"{pkg.__name__} lacks {missing}"
    assert all(_is_ports_own(getattr(pkg, n)) for n in names)


def _jax_modules():
    return sorted(p for p in JAX_PKG.rglob("*.py") if p.name != "__init__.py")


def _public_defs(path: Path) -> list[str]:
    return [n.name for n in ast.parse(path.read_text()).body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef)) and not n.name.startswith("_")]


@pytest.mark.parametrize("module", _jax_modules(), ids=lambda p: str(p.relative_to(JAX_PKG)))
def test_module_public_names_match_jax(module):
    """Every public function and class of a JAX module is a name of the
    port's module at the same path, apart from the "Not to port" list."""
    rel = str(module.relative_to(JAX_PKG))
    if rel in NOT_TO_PORT_MODULES:
        replaced = NOT_TO_PORT_MODULES[rel]
        assert not (PORT_PKG / rel).exists()
        assert replaced is None or (PORT_PKG / replaced).is_file()
        return
    port = importlib.import_module(_port_of(_module_name(module, JAX_PKG)))
    left_out = {name for r, name in NOT_TO_PORT_NAMES if r == rel}
    missing = [n for n in _public_defs(module) if n not in left_out and not hasattr(port, n)]
    assert not missing, f"{port.__name__} lacks {missing}"
    assert not any(hasattr(port, n) for n in left_out)


def test_not_to_port_entries_name_real_code():
    for rel in NOT_TO_PORT_MODULES:
        assert (JAX_PKG / rel).is_file(), rel
    for rel, name in NOT_TO_PORT_NAMES:
        assert name in _public_defs(JAX_PKG / rel), (rel, name)


def test_exports_import_without_jax():
    """The package exports import in a process that never loads JAX."""
    code = ("import sys\n"
            "from exemplars_vc_tpu_torch import Config, load_config\n"
            "from exemplars_vc_tpu_torch.align import build_exemplar_dicts, dtw_batch\n"
            "from exemplars_vc_tpu_torch.dsp import stft, stft_magnitude, mcep_to_spectrum, "
            "griffin_lim\n"
            "from exemplars_vc_tpu_torch.obs import Timer, trace_to, spectral_convergence, mcd\n"
            "from exemplars_vc_tpu_torch.models import warping_forward, warping_forward_batch\n"
            "from exemplars_vc_tpu_torch.pipelines import convert_utterance, make_dictionary\n"
            "import exemplars_vc_tpu_torch.factorize, exemplars_vc_tpu_torch.io, "
            "exemplars_vc_tpu_torch.parallel, exemplars_vc_tpu_torch.separate, "
            "exemplars_vc_tpu_torch.world\n"
            "from exemplars_vc_tpu_torch.kernels import build\n"
            "assert not build.build_seconds, 'a kernel was built on import'\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', "
            "'exemplars_vc_tpu')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
