"""Rank workers of the port's multi-process tests: a world of processes on
the CPU over gloo, spawned once a test module.

Imports no jax (the spawned children import only torch, numpy and the port),
so the JAX side of each comparison runs in the test's own process. Each case
runs on every rank of one world and returns a dict of tensors and numbers;
:func:`run_world` collects them by rank, in the cases' order. Torch runs one
thread a rank.
"""

import os
import socket
import tempfile

import torch
import torch.multiprocessing as mp

from exemplars_vc_tpu_torch.parallel import (
    initialize_multihost,
    make_mesh,
    shard_batch,
    sharded_dtw_batch,
    sharded_nmf_activations,
)
from exemplars_vc_tpu_torch.parallel.mesh import replicate
from exemplars_vc_tpu_torch.parallel.sharded_long_dtw import sharded_dtw_long
from exemplars_vc_tpu_torch.parallel.sharded_nmf import gather_activations


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank: int, world: int, port: int, cases: list, out_dir: str) -> None:
    torch.set_num_threads(1)
    info = initialize_multihost(f"127.0.0.1:{port}", world, rank, device="cpu")
    results = [CASES[name](rank, world, *args) for name, args in cases]
    torch.save({"info": info, "cases": results}, os.path.join(out_dir, f"{rank}.pt"))


def run_world(world: int, cases: list) -> list[dict]:
    """Run ``cases`` [(name, args), ...] in order on every rank of a new
    world of ``world`` processes; returns each rank's {"info": its
    ``initialize_multihost`` summary, "cases": the cases' results}."""
    with tempfile.TemporaryDirectory(prefix="evc_world_") as out:
        mp.spawn(_entry, args=(world, free_port(), cases, out), nprocs=world, join=True)
        return [torch.load(os.path.join(out, f"{r}.pt"), weights_only=False)
                for r in range(world)]


# ---------------------------------------------------------------------------
# cases
# ---------------------------------------------------------------------------

def nmf_case(rank, world, X, A, dict_, tol, max_iter):
    """The sharded solve over the first ``dict_`` ranks; the others stay
    out (they only take part in making the mesh's groups)."""
    mesh = make_mesh(data=1, dict_=dict_)
    if mesh.coordinate() is None:
        return None
    st = sharded_nmf_activations(torch.as_tensor(X), torch.as_tensor(A), mesh, tol=tol,
                                 max_iter=max_iter)
    return {"H": gather_activations(st.H, mesh), "H_loc": st.H, "n_iter": st.n_iter,
            "error": float(st.error)}


def sharded_solve_case(rank, world, X, A, max_iter):
    """The conversion's ``mu_sharded`` solve over the whole world, whose
    ``dict`` axis shrinks to a divisor of K: ranks outside it receive H."""
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.pipelines.convert import _dispatch_solver

    cfg = load_config(overrides=["nmf.solver=mu_sharded", f"nmf.max_iter={max_iter}",
                                 "nmf.tol=0"])
    st = _dispatch_solver(torch.as_tensor(X), torch.as_tensor(A), cfg)
    return {"H": st.H, "n_iter": st.n_iter, "error": float(st.error)}


def dtw_batch_case(rank, world, fa, fb, la, lb, data):
    mesh = make_mesh(data=data, dict_=1)
    if mesh.coordinate() is None:
        return None
    r = sharded_dtw_batch(fa, fb, la, lb, mesh, device="cpu")
    return r._asdict()


def placement_case(rank, world, x, data, dict_):
    mesh = make_mesh(data=data, dict_=dict_)
    xs, xr = shard_batch(x, mesh, device="cpu"), replicate(x, mesh, device="cpu")
    return {"shape": mesh.shape, "coordinate": mesh.coordinate(), "local": xs.to_local(),
            "full": xs.full_tensor(), "replicated": xr.full_tensor()}


def long_dtw_case(rank, world, a, b, n_dev, col_block, keep_dirs):
    mesh = make_mesh(data=n_dev, dict_=1)
    if mesh.coordinate() is None:
        return None
    d, dirs = sharded_dtw_long(a, b, mesh, col_block=col_block, keep_dirs=keep_dirs,
                               device="cpu")
    return {"distance": d, "dirs": dirs}


def convert_case(rank, world, data, wav, store_root):
    """``convert_utterance`` with ``nmf.solver=mu_sharded`` over the world
    and with ``mu`` in this process alone, as the JAX package's two-process
    gate runs them: 10 MU steps without the tolerance, 2 Griffin-Lim
    iterations, two pairs, the first second of the held-out input."""
    from dataclasses import replace

    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav
    from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance

    cfg = load_config(overrides=["data.tar=TF1", "misc.nb_file=2"])
    cfg_sh = replace(cfg, nmf=replace(cfg.nmf, solver="mu_sharded", max_iter=10, tol=0.0))
    cfg_mu = replace(cfg_sh, nmf=replace(cfg_sh.nmf, solver="mu"))
    sig, sr = read_wav(wav)
    short = os.path.join(store_root, f"in_{rank}.wav")
    write_wav(short, sig[:sr], sr)
    out = {}
    for name, c in (("sharded", cfg_sh), ("mu", cfg_mu)):
        res = convert_utterance(c, ArtifactStore(os.path.join(store_root, f"{name}_{rank}")),
                                data, short, nb_file=2, synth_iters=2, device="cpu")
        out[name] = {"Y": res.converted["stft"], "audio": res.audio, "n_iter": res.n_iter,
                     "K": res.nmf_shape[1]}
    return out


def train_case(rank, world, data, store_root, leaves, overrides):
    """``train_warping_net(data_parallel=True)`` from the given initial
    parameters (the JAX package's ``leaf_i`` leaves)."""
    from exemplars_vc_tpu_torch.config import load_config
    from exemplars_vc_tpu_torch.io.store import ArtifactStore
    from exemplars_vc_tpu_torch.models import train as ttrain
    from exemplars_vc_tpu_torch.models.warping import warping_params_from_jax

    ttrain.init_warping_params = lambda key, cfg: warping_params_from_jax(leaves, cfg)
    store = ArtifactStore(os.path.join(store_root, f"t{rank}"))
    m = ttrain.train_warping_net(load_config(overrides=overrides), store, data, nb_file=3,
                                 data_parallel=True, device="cpu")
    # the same store object: its load waits for its own pending writes
    return {"metrics": m, "params": store.load(m["checkpoint"])}


def separate_batch_case(rank, world, X, n_em, key):
    """``separate_batch`` of the whole batch over a mesh of every rank,
    from ``key`` (a key's two words; None: the default key ``PRNGKey(0)``)."""
    from exemplars_vc_tpu_torch.parallel.sharded_separate import separate_batch

    mesh = make_mesh(data=world, dict_=1)
    key = None if key is None else torch.as_tensor(key, dtype=torch.int64)
    images, nll = separate_batch(X, n_sources=2, n_components=2, n_em=n_em, mesh=mesh,
                                 key=key, device="cpu")
    return {"images": images.full_tensor(), "nll": nll.full_tensor(),
            "local": images.to_local(), "placements": [(type(p).__name__, getattr(p, "dim", None)) for p in images.placements]}


def nsgt_case(rank, world, x):
    """The NSGT and its inverse on this rank's shard of a signal batch,
    gathered over the mesh's data axis."""
    from exemplars_vc_tpu_torch.dsp.nsgt import insgt, nsgt
    from exemplars_vc_tpu_torch.parallel.distributed import all_gather_cat

    mesh = make_mesh(data=world, dict_=1)
    xs = shard_batch(x, mesh, device="cpu")
    c = nsgt(xs.to_local(), sr=16000, fmin=150.0, device="cpu")
    back = insgt(c, x.shape[-1], sr=16000, fmin=150.0, device="cpu")
    group = mesh.group("data")
    return {"c": all_gather_cat(c, group), "back": all_gather_cat(back, group)}


CASES = {f.__name__[:-5]: f for f in (nmf_case, sharded_solve_case, dtw_batch_case,
                                      placement_case, long_dtw_case, convert_case, train_case,
                                      separate_batch_case, nsgt_case)}
