"""The port stands alone: it imports nothing of jax or of the JAX package,
and its own copies of the configuration, wav IO, the artifact store and the
native wav loader behave as the JAX package's modules of the same names
(equal dataclasses, bit-equal wavs, equal arrays). Its entry points run on
the card unless the caller passes ``device="cpu"``, so on a host without a
card a call without ``device`` raises."""

import ast
import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from exemplars_vc_tpu import config as jconfig
from exemplars_vc_tpu.io import store as jstore
from exemplars_vc_tpu.io import wav as jwav
from exemplars_vc_tpu_torch import config as tconfig
from exemplars_vc_tpu_torch.io import native as tnative
from exemplars_vc_tpu_torch.io import store as tstore
from exemplars_vc_tpu_torch.io import wav as twav
from exemplars_vc_tpu_torch.io.standin import AUDIO_DIR, build_standin_corpus

REPO = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "exemplars_vc_tpu")


def _port_sources():
    return (sorted((REPO / "exemplars_vc_tpu_torch").rglob("*.py"))
            + [REPO / "chip_smoke.py", REPO / "bench_torch.py"]
            + sorted((REPO / "tools").glob("*_torch.py")))


def _imported_roots(path: Path) -> list[tuple[int, str]]:
    """(line, top-level module) of every import in ``path``, nested ones too."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [(node.lineno, a.name.split(".")[0]) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.append((node.lineno, node.module.split(".")[0]))
    return sorted(out)


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(REPO)))
def test_port_module_imports_nothing_of_jax(path):
    bad = [(line, mod) for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def test_import_scan_sees_nested_and_from_imports(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import os\n\ndef f():\n    from exemplars_vc_tpu.io.wav import read_wav\n"
                 "    import jax.numpy as jnp\n"
                 "from exemplars_vc_tpu_torch.io import wav\n")
    assert _imported_roots(p) == [(1, "os"), (4, "exemplars_vc_tpu"), (5, "jax"),
                                  (6, "exemplars_vc_tpu_torch")]


CONFIG_CASES = [
    dict(),
    dict(overrides=["data.tar=TF1", "misc.nb_file=3", "nmf.max_iter=20"]),
    dict(overrides=["data.tar=TF1", "misc.nb_file=8"]),
    dict(overrides=["misc.nb_file=3", "nmf.context_frames=2", "data.use_stft=false",
                    "nmf.solver=qr", "data.dict_augment_warps=0.9", "nmf.activation_power=1.5"]),
    dict(preset="quality"),
    dict(preset="quality", overrides=["nmf.h_smooth=0"]),
]


@pytest.mark.parametrize("kw", CONFIG_CASES, ids=range(len(CONFIG_CASES)))
def test_load_config_equals_jax(kw):
    assert dataclasses.asdict(tconfig.load_config(**kw)) == \
        dataclasses.asdict(jconfig.load_config(**kw))


def test_load_config_ini_and_errors_match_jax(tmp_path):
    ini = tmp_path / "config"
    ini.write_text("[VAR]\nsrc = SM1\nuse_stft = false\n[MCEP]\nfeat_hop_length = 160\n"
                   "[MISC]\nnb_file = 5 ; comment\n[OTHER]\nx = 1\n")
    assert dataclasses.asdict(tconfig.load_config(str(ini), ["nmf.tol=1e-3"])) == \
        dataclasses.asdict(jconfig.load_config(str(ini), ["nmf.tol=1e-3"]))
    assert tconfig.PRESETS == jconfig.PRESETS
    for kw, err in ((dict(overrides=["nmf.nope=1"]), KeyError),
                    (dict(preset="nope"), KeyError),
                    (dict(path=str(tmp_path / "missing")), FileNotFoundError)):
        with pytest.raises(err):
            tconfig.load_config(**kw)


def _committed_wavs():
    return sorted(AUDIO_DIR.glob("*.wav"))[:2] + sorted((AUDIO_DIR / "loo").glob("*.wav"))[:2]


@pytest.mark.parametrize("name", [p.name for p in _committed_wavs()])
def test_wav_read_write_bit_equal_to_jax(name, tmp_path):
    path = next(p for p in _committed_wavs() if p.name == name)
    x, sr = twav.read_wav(str(path))
    xj, srj = jwav.read_wav(str(path))
    assert sr == srj and x.dtype == xj.dtype and np.array_equal(x, xj)
    x32, _ = twav.read_wav(str(path), dtype=np.float32)
    assert np.array_equal(x32, jwav.read_wav(str(path), dtype=np.float32)[0])
    rng = np.random.default_rng(0)
    for sig in (x, 1.7 * x, np.stack([x, -x]) * rng.uniform(0.5, 1.0)):
        twav.write_wav(str(tmp_path / "t.wav"), sig, sr)
        jwav.write_wav(str(tmp_path / "j.wav"), sig, sr)
        assert (tmp_path / "t.wav").read_bytes() == (tmp_path / "j.wav").read_bytes()
    st, _ = twav.read_wav(str(tmp_path / "t.wav"), mono=False)
    assert np.array_equal(st, jwav.read_wav(str(tmp_path / "j.wav"), mono=False)[0])


def test_wav_rejects_what_jax_rejects(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav file at all")
    with pytest.raises(ValueError, match="not a RIFF/WAVE file"):
        twav.read_wav(str(bad))


@pytest.mark.parametrize("async_writes", [True, False])
def test_artifact_store_round_trip_equals_jax(tmp_path, async_writes):
    rng = np.random.default_rng(1)
    arrays = dict(path_i=rng.integers(-1, 100, (3, 17)).astype(np.int32),
                  feat=rng.standard_normal((3, 5, 4)).astype(np.float32),
                  tensor=torch.arange(6, dtype=torch.float32).reshape(2, 3))
    t = tstore.ArtifactStore(str(tmp_path / "t"), async_writes=async_writes)
    j = jstore.ArtifactStore(str(tmp_path / "j"), async_writes=async_writes)
    assert not t.has("a")
    t.save("a", **arrays)
    j.save("a", **arrays)
    t.flush()
    j.flush()
    assert t.has("a") and j.has("a")
    got, ref = t.load("a"), j.load("a")
    assert sorted(got) == sorted(ref)
    for k in got:
        assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k])
    # one store reads what the other wrote
    cross = jstore.ArtifactStore(str(tmp_path / "t")).load("a")
    assert all(np.array_equal(cross[k], got[k]) for k in got)
    t.save_json("meta", {"k": [1, 2]})
    assert t.load_json("meta") == {"k": [1, 2]}


def test_load_speaker_on_standin_corpus_equals_jax(tmp_path):
    data, _, _ = build_standin_corpus(str(tmp_path), n_pairs=3)
    for spk in ("SF1", "TF1"):
        # each call lists other paths, so none is served from the in-process cache
        for kw in (dict(use_native=False), dict(nb_file=1, use_native=True),
                   dict(nb_file=2, cache_dir=str(tmp_path / "cache"))):
            sigs, sr = tstore.load_speaker(data, spk, **kw)
            ref, srj = jstore.load_speaker(data, spk, **kw)
            assert sr == srj == 16000 and len(sigs) == len(ref)
            assert all(s.dtype == r.dtype and np.array_equal(s, r) for s, r in zip(sigs, ref))
    os.makedirs(os.path.join(data, "XX0"))
    with pytest.raises(FileNotFoundError, match="no wavs for speaker XX0"):
        tstore.load_speaker(data, "XX0")


def test_padding_helpers_equal_jax():
    rng = np.random.default_rng(2)
    sig = rng.standard_normal(12_345)
    for a, b in zip(tstore.bucketed_signal(sig, 80, 128), jstore.bucketed_signal(sig, 80, 128)):
        assert np.array_equal(a, b)
    x = rng.standard_normal((37, 3))
    for axis in (0, 1):
        got, ref = tstore.pad_to_bucket(x, 16, axis), jstore.pad_to_bucket(x, 16, axis)
        assert np.array_equal(got[0], ref[0]) and got[1] == ref[1]
    ragged = [rng.standard_normal((n, 4)).astype(np.float32) for n in (5, 130, 1)]
    for a, b in zip(tstore.stack_ragged(ragged, 64), jstore.stack_ragged(ragged, 64)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert not hasattr(tstore, "stacked_speaker_batch")


def _code_of(path: Path) -> str:
    """The module's AST without docstrings, the port's package name read as
    the JAX package's: what is left of a faithful copy."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant) and isinstance(body[0].value.value, str)):
            node.body = body[1:]
        if isinstance(node, ast.Constant) and node.value == "exemplars_vc_tpu_torch":
            node.value = "exemplars_vc_tpu"
    return ast.dump(tree)


@pytest.mark.parametrize("module", ["obs/logging.py", "obs/scalars.py"])
def test_obs_modules_are_copies_of_jax(module):
    """``obs/logging.py`` and ``obs/scalars.py`` are the JAX package's code;
    only docstrings and ``get_logger``'s default name (the port's logger)
    differ."""
    assert _code_of(REPO / "exemplars_vc_tpu_torch" / module) == \
        _code_of(REPO / "exemplars_vc_tpu" / module)


def test_obs_copies_behave_as_jax(tmp_path):
    from exemplars_vc_tpu.obs import logging as jlogging
    from exemplars_vc_tpu.obs import scalars as jscalars
    from exemplars_vc_tpu_torch.obs import logging as tlogging
    from exemplars_vc_tpu_torch.obs import scalars as tscalars

    assert tlogging.get_logger().name == "exemplars_vc_tpu_torch"
    for mod in (tlogging, jlogging):
        root = tmp_path / mod.__name__
        os.makedirs(root / "3")
        os.makedirs(root / "notes")
        assert [os.path.basename(mod.new_run_dir(str(root))) for _ in range(2)] == ["4", "5"]
    rng = np.random.default_rng(0)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    for mod in (tscalars, jscalars):
        with mod.ScalarWriter(str(tmp_path / ("s_" + mod.__name__))) as sw:
            sw.scalar("loss/train", 1.5, 0)
            sw.summary("params/leaf_0", w, 0)
    got, ref = (mod.read_scalars(str(tmp_path / ("s_" + mod.__name__) / "scalars.jsonl"))
                for mod in (tscalars, jscalars))
    strip = [{k: v for k, v in e.items() if k != "wall"} for e in got]
    assert strip == [{k: v for k, v in e.items() if k != "wall"} for e in ref]


def test_native_loader_builds_outside_the_source_tree(tmp_path):
    """The library goes to the git-ignored build directory, never into
    ``native/``; where it builds, it decodes as the numpy reader does."""
    assert tnative._LIB_PATH.parent == REPO / "build" / "native"
    assert tnative._SRC == REPO / "native" / "evc_io.cpp"
    if not tnative.available():
        pytest.skip("no C++ compiler on this host")
    paths = [str(p) for p in sorted((AUDIO_DIR / "loo").glob("*.wav"))[:3]]
    sigs, sr = tnative.read_wavs(paths, n_threads=2)
    for p, s in zip(paths, sigs):
        x, srx = twav.read_wav(p)
        assert sr == srx and np.array_equal(s, x)


ENTRY_POINTS = ["convert_utterance", "make_dictionary", "build_conversion_dicts_pair",
                "extract_stft_complex", "mcd_between_signals", "build_conversion_dicts",
                "extract_world_features", "Converter", "run_freq_warp", "train_warping_net",
                "make_warping_dataset", "apply_warping_net", "evaluate_heldout", "evaluate_loo",
                "no_conversion_baseline"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_entry_point_defaults_to_the_card(name, tmp_path):
    """Called without ``device``, an entry point asks for the card: on a host
    without one it raises rather than fall back to the CPU."""
    import inspect

    from exemplars_vc_tpu_torch.models import train
    from exemplars_vc_tpu_torch.pipelines import (
        conv_dicts, convert, evaluate, freq_warp, make_dict, serve)

    fn = {"run_freq_warp": freq_warp.run_freq_warp,
          "train_warping_net": train.train_warping_net,
          "make_warping_dataset": train.make_warping_dataset,
          "apply_warping_net": train.apply_warping_net,
          "evaluate_heldout": evaluate.evaluate_heldout,
          "evaluate_loo": evaluate.evaluate_loo,
          "no_conversion_baseline": evaluate.no_conversion_baseline,
          "convert_utterance": convert.convert_utterance,
          "make_dictionary": make_dict.make_dictionary,
          "build_conversion_dicts_pair": conv_dicts.build_conversion_dicts_pair,
          "extract_stft_complex": conv_dicts.extract_stft_complex,
          "mcd_between_signals": convert.mcd_between_signals,
          "build_conversion_dicts": conv_dicts.build_conversion_dicts,
          "extract_world_features": conv_dicts.extract_world_features,
          "Converter": serve.Converter}[name]
    assert inspect.signature(fn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device works")
    data, src, tar = build_standin_corpus(str(tmp_path / "c"), n_pairs=2)
    world = ["data.use_stft=false"] if name in ("build_conversion_dicts", "Converter") else []
    cfg = tconfig.load_config(overrides=["data.tar=TF1", "misc.nb_file=2"] + world)
    store = tstore.ArtifactStore(str(tmp_path / "s"))
    x, _ = twav.read_wav(src)
    args = {"run_freq_warp": (cfg, store, data),
            "train_warping_net": (cfg, store, data),
            "make_warping_dataset": (cfg, store, data),
            "apply_warping_net": (store, cfg, np.zeros((1, 4, 20), np.float32)),
            "evaluate_heldout": (cfg, store, data),
            "evaluate_loo": (cfg, store, data),
            "no_conversion_baseline": (cfg, data),
            "convert_utterance": (cfg, store, data, src),
            "make_dictionary": (cfg, store, data),
            "build_conversion_dicts_pair": (cfg, store, data, "SF1", "TF1"),
            "extract_stft_complex": (x, cfg),
            "mcd_between_signals": (x, x, cfg),
            "build_conversion_dicts": (cfg, store, data, "SF1"),
            "extract_world_features": (x, cfg),
            "Converter": (cfg, store, data)}[name]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        fn(*args)
