"""The traffic generator: deterministic by seed, the same lengths for every
seed, inside the mix's range."""

import numpy as np

from benchmark.harness import traffic
from benchmark.harness.spec import load_cell

SERVE = load_cell("stft.serve")
PARAMS = SERVE.traffic
BIG = 2**33 + 17


def test_same_seed_same_requests(tmp_path):
    import torch

    a, b = (SERVE.entry.requests(PARAMS | {"pool": 8}, SERVE.settings, BIG, str(tmp_path / d),
                                 torch.device("cpu")) for d in "ab")
    for xs, ys in zip(a, b):
        assert all(len(x) == 1 for x in xs + ys)
        xs, ys = [x[0] for x in xs], [y[0] for y in ys]
        assert [len(c.samples) for c in xs] == [len(c.samples) for c in ys]
        assert all(np.array_equal(x.samples, y.samples) for x, y in zip(xs, ys))
        assert all(open(x.path, "rb").read() == open(y.path, "rb").read() for x, y in zip(xs, ys))


def test_other_seed_same_lengths_other_order_and_speech():
    n = 2 * int(PARAMS["lengths_per_block"])
    a = traffic.request_lengths(PARAMS, BIG, n)
    b = traffic.request_lengths(PARAMS, BIG + 1, n)
    assert sorted(a) == sorted(b) and a != b
    ca = traffic.cut_clips(a[:4], BIG, 2)
    cb = traffic.cut_clips(a[:4], BIG + 1, 2)
    assert not all(np.array_equal(x.samples, y.samples) for x, y in zip(ca, cb))


def test_lengths_stay_in_range_and_every_block_is_whole():
    m = int(PARAMS["lengths_per_block"])
    lengths = traffic.request_lengths(PARAMS, 12345, 3 * m)
    sr = traffic.SR
    assert min(lengths) >= PARAMS["min_seconds"] * sr
    assert max(lengths) <= PARAMS["max_seconds"] * sr
    for k in range(3):
        assert sorted(lengths[k * m:(k + 1) * m]) == sorted(traffic.block_lengths(PARAMS))
    # pairs of a short and a long one: every even prefix of a block is near the mean
    mean = np.mean(lengths[:m])
    for j in range(2, m + 1, 2):
        assert abs(np.mean(lengths[:j]) - mean) < 0.35 * mean


def test_stream_sessions_are_whole_chunks():
    import torch

    cell = load_cell("stft.stream")
    clip = traffic.cut_clips([int(1.7 * traffic.SR)], 99, 2)[0]
    chunks = cell.entry.session_chunks(clip, cell.traffic, cell.settings, torch.device("cpu"))
    c = cell.traffic["chunk_frames"]
    assert len(chunks) == (1 + len(clip.samples) // 80) // c
    assert all(m.shape == (c, 201) and s.shape == (c, 201) for m, s in chunks)
    assert np.allclose(chunks[0][0], np.abs(chunks[0][1]))
