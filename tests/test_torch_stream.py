"""The port's ``StreamingConverter`` (``pipelines/stream.py``): the four cases
of ``tests/test_stream.py`` (which skip on a host without the reference
corpus, though they need none of it) on the same seeded inputs, each also
against the JAX package's class.

Tolerances: chunked against batch ``rtol=1e-4, atol=1e-5``, the JAX test's
own; the port's converted block against the JAX package's within 1e-3
relative L2 (float32 rounding through 60–80 MU steps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from exemplars_vc_tpu.config import load_config as jload_config
from exemplars_vc_tpu.dsp import stft as jstft
from exemplars_vc_tpu.pipelines.stream import StreamingConverter as JStreamingConverter
from exemplars_vc_tpu_torch.config import load_config
from exemplars_vc_tpu_torch.dsp.stft import stft
from exemplars_vc_tpu_torch.pipelines.stream import StreamingConverter
from torch_corpus import rel_l2


def _dicts():
    rng = np.random.default_rng(0)
    K, D = 256, 201
    A = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    B = np.abs(rng.standard_normal((K, D))).astype(np.float32)
    return A, B


def test_streaming_nmf_matches_batch():
    """Row independence: chunked activations reproduce the batch conversion."""
    ov = ["nmf.max_iter=80", "nmf.tol=0"]
    A, B = _dicts()
    X = np.abs(np.random.default_rng(1).standard_normal((96, 201))).astype(np.float32)
    sc = StreamingConverter(load_config(overrides=ov), A, B, device="cpu")
    streamed = torch.cat([sc._convert_block(X[i: i + 32]) for i in range(0, 96, 32)], dim=0)
    batch = sc._convert_block(X)
    np.testing.assert_allclose(streamed.numpy(), batch.numpy(), rtol=1e-4, atol=1e-5)
    ref = JStreamingConverter(jload_config(overrides=ov), A, B)._convert_block(X)
    assert rel_l2(batch.numpy(), ref) < 1e-3


def test_streaming_with_source_phase_seed():
    """push(phase_chunk=...) seeds Griffin-Lim with the chunk's phase; the
    context frames take the previous push's converged phase. With the same
    seeds the audio equals the JAX package's within 1e-3 relative L2."""
    A, B = _dicts()
    sc = StreamingConverter(load_config(), A, B, context_frames=16, synth_iters=5, device="cpu")
    jsc = JStreamingConverter(jload_config(), A, B, context_frames=16, synth_iters=5)
    x = np.random.default_rng(3).standard_normal(64 * 80).astype(np.float32) * 0.1
    S = stft(torch.as_tensor(x), n_fft=400, hop_length=80)[:64]
    Sj = jstft(jnp.asarray(x), n_fft=400, hop_length=80)[:64]
    for k in range(3):
        # the converted block bypassed (identity conversion): the synthesis seed alone
        y = sc._synthesize(torch.abs(S), phase_new=S)
        yj = jsc._synthesize(np.asarray(jnp.abs(Sj)), phase_new=Sj)
        assert y.shape == (64 * 80,) and y.dtype == np.float32 and np.isfinite(y).all()
        assert rel_l2(y, yj) < 1e-3, k
    assert sc._context_phase is not None and sc._context_phase.shape == (16, 201)
    assert sc._context_mag.shape == (16, 201)
    # an unseeded push resets the stored phase; the next seeded push falls
    # back to unit phase for the context frames
    sc._synthesize(torch.abs(S))
    assert sc._context_phase is None
    y = sc._synthesize(torch.abs(S), phase_new=S)
    assert np.isfinite(y).all() and sc._context_phase.shape == (16, 201)
    # no context kept
    sc0 = StreamingConverter(load_config(), A, B, context_frames=0, synth_iters=2, device="cpu")
    sc0._synthesize(torch.abs(S), phase_new=S)
    assert sc0._context_mag is None and sc0._context_phase is None


def test_streaming_audio_continuity():
    A, B = _dicts()
    rng = np.random.default_rng(2)
    sc = StreamingConverter(load_config(overrides=["nmf.max_iter=30"]), A, B, context_frames=16,
                            synth_iters=20, device="cpu")
    outs = []
    for k in range(3):
        mag = np.abs(rng.standard_normal((64, 201))).astype(np.float32)
        y = sc.push(mag)
        assert y.shape == (64 * 80,) and np.isfinite(y).all()
        assert sc._context_mag.shape == (16, 201)
        outs.append(y)
    assert np.concatenate(outs).shape == (3 * 64 * 80,)
    assert sc.flush().shape == (0,)


def test_streaming_row_independent_levers_match_batch():
    """prune_topk and activation_power are per frame, so chunked ≡ batch
    holds; the temporal levers and the bfloat16 solve are set back by the
    constructor to keep the contract."""
    ov = ["nmf.max_iter=60", "nmf.tol=0", "nmf.prune_topk=16", "nmf.prune_iters=40",
          "nmf.activation_power=1.3", "nmf.h_smooth=2", "nmf.context_frames=2",
          "nmf.work_dtype=bfloat16"]
    A, B = _dicts()
    sc = StreamingConverter(load_config(overrides=ov), A, B, device="cpu")
    assert sc.cfg.nmf.h_smooth == 0 and sc.cfg.nmf.context_frames == 0
    assert sc.cfg.nmf.work_dtype == "float32"
    assert sc.cfg.nmf.prune_topk == 16          # row-independent: passes through
    X = np.abs(np.random.default_rng(7).standard_normal((64, 201))).astype(np.float32)
    streamed = torch.cat([sc._convert_block(X[i: i + 16]) for i in range(0, 64, 16)], dim=0)
    batch = sc._convert_block(X)
    np.testing.assert_allclose(streamed.numpy(), batch.numpy(), rtol=1e-4, atol=1e-5)
    ref = JStreamingConverter(jload_config(overrides=ov), A, B)._convert_block(X)
    assert rel_l2(batch.numpy(), ref) < 1e-3


def test_streaming_defaults_to_the_card_and_refuses_the_unported():
    import inspect

    A, B = _dicts()
    assert inspect.signature(StreamingConverter.__init__).parameters["device"].default == "cuda"
    # the sharded solver (ROADMAP queue 1 item 12) streams, in a world of one
    # process as mu does, bit for bit
    X = np.abs(np.random.default_rng(3).standard_normal((16, A.shape[1]))).astype(np.float32)
    sharded = StreamingConverter(load_config(overrides=["nmf.solver=mu_sharded"]), A, B,
                                 device="cpu")._convert_block(X)
    assert torch.equal(sharded, StreamingConverter(load_config(), A, B,
                                                   device="cpu")._convert_block(X))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            StreamingConverter(load_config(), A, B)
