"""Training loop of the neural warping net, stage 02 (port of
``exemplars_vc_tpu/models/train.py``).

The reference's ``02_freq_warping_neural.py:121-246``: a summed L1 loss over
the valid frames, RMSprop(lr=5e-3, weight_decay=1e-4) with torch's defaults
(alpha 0.99, eps 1e-8 outside the square root, coupled L2 — the semantics
of the JAX package's ``reference_rmsprop``), ``nb_epoch`` epochs of
minibatches of ``batch_size`` utterances, a held-out 20 % evaluated each
epoch, best-loss checkpoints and patience early stopping. Utterances are
padded and masked into one batch on the device.

``data_parallel=True`` in a process group of W > 1 ranks splits each
minibatch over the ranks (one process a rank, each on its own device or
sharing one): each rank runs its slice, the gradients of the summed loss are
all-reduced (SUM), and every rank takes the same RMSprop step, so the
parameters and the optimizer state stay equal on every rank.

Left out: the orbax checkpoint backend (the JAX ecosystem's library; the
npz layout here is the JAX package's ``leaf_i`` layout, so checkpoints go
both ways).
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.align.exemplar import gather_aligned_batch
from exemplars_vc_tpu_torch.config import Config
from exemplars_vc_tpu_torch.device import resolve_device
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.models.warping import (
    WarpingNet,
    WarpingNetConfig,
    init_warping_params,
    warping_params_from_jax,
    warping_params_to_jax,
)
from exemplars_vc_tpu_torch.obs.logging import new_run_dir
from exemplars_vc_tpu_torch.obs.profiling import Timer
from exemplars_vc_tpu_torch.obs.scalars import ScalarWriter
from exemplars_vc_tpu_torch.pipelines.conv_dicts import build_conversion_dicts
from exemplars_vc_tpu_torch.pipelines.make_dict import make_dictionary

log = logging.getLogger("exemplars_vc_tpu_torch")


def make_warping_dataset(cfg: Config, store: ArtifactStore, data_path: str,
                         nb_file: int | None = None, features: str = "dict",
                         *, device: str | torch.device = "cuda"):
    """Aligned (source, target) frame sequences along the dictionary's DTW
    paths, the reference's ``SF12TM3_*.pkl`` pairs: host arrays src, tar
    (N, P, D) and the valid-frame mask (N, P).

    ``features="dict"`` takes the dictionary's own alignment features (MFCC);
    another value names a conversion feature ("stft", "sp", …), gathered
    along the same paths (the features share the alignment's hop)."""
    device = resolve_device(device)
    art = make_dictionary(cfg, store, data_path, nb_file=nb_file, device=device)
    if features == "dict":
        fa, fb = art.feat_a, art.feat_b
    else:
        fa, fb = (build_conversion_dicts(cfg, store, data_path, spk, nb_file=nb_file,
                                         device=device).feats[features]
                  for spk in (cfg.data.src, cfg.data.tar))
        max_idx = int(art.path_i.max())
        if max_idx >= fa.shape[1]:
            raise ValueError(f"alignment grid ({max_idx}) exceeds {features} frames "
                             f"({fa.shape[1]})")
    src = gather_aligned_batch(fa, art.path_i)
    tar = gather_aligned_batch(fb, art.path_j)
    mask = (art.path_i >= 0).cpu().numpy().astype(np.float32)
    return src.cpu().numpy(), tar.cpu().numpy(), mask


def train_test_split(n: int, test_size: float = 0.2, seed: int = 10):
    """Index split of the reference's sklearn call (``utils.py:109``:
    test_size=0.2, random_state=10), by a numpy permutation."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_test = max(1, int(round(n * test_size)))
    return perm[n_test:], perm[:n_test]


def reference_rmsprop(net: WarpingNet, learning_rate: float,
                      weight_decay: float) -> torch.optim.RMSprop:
    """The reference's optimizer (``02_freq_warping_neural.py:150``) over the
    net's trainable parameters (``bias_hh`` is not one)."""
    return torch.optim.RMSprop([p for p in net.parameters() if p.requires_grad],
                               lr=learning_rate, alpha=0.99, eps=1e-8,
                               weight_decay=weight_decay)


def l1_sum(net: WarpingNet, x: torch.Tensor, y: torch.Tensor,
           mask: torch.Tensor) -> torch.Tensor:
    """Σ |net(x) − y| over the valid frames (mask (N, T))."""
    return torch.sum(torch.abs(net(x) - y) * mask[..., None])


def update_step(net: WarpingNet, opt: torch.optim.Optimizer, x: torch.Tensor,
                y: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """One optimizer step on the minibatch; returns its loss (before the
    step). With a process ``group`` each rank passes its slice of the
    minibatch: the loss is a sum, so the gradients and the loss are
    all-reduced with SUM before the step, in one buffer (one collective a
    step)."""
    opt.zero_grad(set_to_none=True)
    loss = l1_sum(net, x, y, mask)
    loss.backward()
    loss = loss.detach()
    if group is not None:
        grads = [p.grad for p in net.parameters() if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        parts = flat.split([g.numel() for g in grads] + [1])
        for g, part in zip(grads, parts):
            g.copy_(part.view_as(g))
        loss = parts[-1][0]
    opt.step()
    return loss


def eval_loss(net: WarpingNet, x: torch.Tensor, y: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return l1_sum(net, x, y, mask)


def save_params(store: ArtifactStore, name: str, net: WarpingNet, backend: str = "npz") -> None:
    """Persist the net as the JAX package's npz checkpoint: the JAX tree's
    leaves as ``leaf_i`` (:func:`warping_params_to_jax`) and ``{name}_meta``."""
    if backend != "npz":
        raise ValueError(f"checkpoint backend {backend!r}: only 'npz' is ported "
                         "(orbax is the JAX package's checkpoint library)")
    leaves = warping_params_to_jax(net)
    store.save(name, **{f"leaf_{i}": a for i, a in enumerate(leaves)})
    store.save_json(name + "_meta", {"n_leaves": len(leaves)})


def load_params(store: ArtifactStore, name: str, cfg: WarpingNetConfig,
                backend: str = "npz") -> WarpingNet:
    """A net of shape ``cfg`` from an npz checkpoint of either package."""
    if backend != "npz":
        raise ValueError(f"checkpoint backend {backend!r}: only 'npz' is ported "
                         "(orbax is the JAX package's checkpoint library)")
    return warping_params_from_jax(store.load(name), cfg)


def _net_config(cfg: Config, features: str, in_size: int, out_size: int) -> WarpingNetConfig:
    """The net's shape: the config's sizes for the dictionary features, the
    data's for a conversion feature."""
    dict_feats = features == "dict"
    return WarpingNetConfig(
        in_size=cfg.net.in_size if dict_feats else in_size, hidden_size=cfg.net.hidden_size,
        out_size=cfg.net.out_size if dict_feats else out_size,
        nb_lstm_layers=cfg.net.nb_lstm_layers, bidirectional=cfg.net.bidirectional)


def train_warping_net(cfg: Config, store: ArtifactStore, data_path: str,
                      nb_file: int | None = None, run_root: str | None = None, seed: int = 0,
                      data_parallel: bool = False, features: str = "dict",
                      *, device: str | torch.device = "cuda") -> dict:
    """Train the warping net on ``device``; returns the JAX package's metrics.

    ``features`` other than "dict" trains on that aligned conversion feature
    (e.g. "stft"); the checkpoint and normalisation artifacts then carry the
    feature's name. ``data_parallel`` in a process group of W > 1 ranks
    (every rank calls this with the same arguments, its own ``device`` and
    its own store) rounds the minibatch up to a multiple of W and gives each
    rank its contiguous slice (module docstring); in a world of one process
    it trains as without it, as the JAX package does on one device."""
    device = resolve_device(device)
    group, n_ranks, rank = None, 1, 0
    if data_parallel and dist.is_initialized() and dist.get_world_size() > 1:
        group, n_ranks, rank = dist.group.WORLD, dist.get_world_size(), dist.get_rank()
    src, tar, mask = make_warping_dataset(cfg, store, data_path, nb_file=nb_file,
                                          features=features, device=device)
    idx_train, idx_test = train_test_split(src.shape[0])
    log.info("warping dataset (%s): %d train / %d test utterances, T=%d",
             features, len(idx_train), len(idx_test), src.shape[1])
    net_cfg = _net_config(cfg, features, src.shape[2], tar.shape[2])
    net = init_warping_params(prng.PRNGKey(seed), net_cfg).to(device)
    opt = reference_rmsprop(net, cfg.net.learning_rate, cfg.net.weight_decay)

    # standardize with the masked training-set statistics (stored with the
    # checkpoint for inference): raw MFCCs have c0 ~ 500, which lr 5e-3
    # cannot condition
    m3 = mask[idx_train][..., None]
    denom = max(m3.sum(), 1.0)
    mu = (src[idx_train] * m3).sum((0, 1)) / denom
    sd = np.sqrt(((src[idx_train] - mu) ** 2 * m3).sum((0, 1)) / denom) + 1e-6
    feat_tag = "" if features == "dict" else f"_{features}"
    store.save(f"warping_norm{feat_tag}", mu=mu, sd=sd)

    def on_device(a):
        return torch.as_tensor(a, device=device)

    xs_tr, ys_tr = on_device((src[idx_train] - mu) / sd), on_device((tar[idx_train] - mu) / sd)
    xs_te, ys_te = on_device((src[idx_test] - mu) / sd), on_device((tar[idx_test] - mu) / sd)
    m_tr, m_te = on_device(mask[idx_train]), on_device(mask[idx_test])
    frames_te = max(float(mask[idx_test].sum()), 1.0)

    run_dir = new_run_dir(run_root or os.path.join(store.root, "runs"))
    writer = ScalarWriter(run_dir)
    best_loss, best_epoch, stale = np.inf, -1, 0
    history = []
    ckpt_name = f"{cfg.net.checkpoint_name}_warping{feat_tag}"
    n_train = xs_tr.shape[0]
    mb = max(1, cfg.net.batch_size)   # utterances a step (the reference: one)
    # the minibatch fills the ranks: rounded up to a multiple of their count
    mb = -(-max(mb, n_ranks) // n_ranks) * n_ranks
    share = slice(rank * (mb // n_ranks), (rank + 1) * (mb // n_ranks))
    rng = np.random.default_rng(seed + 1)
    steps_run = 0
    with Timer(device, fence=True) as t_total:
        for epoch in range(cfg.net.nb_epoch):
            order = rng.permutation(n_train)
            tr_loss = 0.0
            for s in range(0, n_train, mb):
                idx = order[s : s + mb]
                if len(idx) < mb:
                    # the true tail, then wrap from the start (cycling if mb > n_train)
                    idx = np.concatenate([idx, np.resize(order, mb - len(idx))])
                sel = on_device(idx[share])
                tr_loss += float(update_step(net, opt, xs_tr[sel], ys_tr[sel], m_tr[sel],
                                             group))
                steps_run += 1
            te_loss = float(eval_loss(net, xs_te, ys_te, m_te))
            per_frame = te_loss / frames_te
            history.append({"epoch": epoch, "train_loss": tr_loss,
                            "test_loss": te_loss, "test_l1_per_frame": per_frame})
            # the reference's tensorboardX scalars and histograms (:212-220)
            writer.scalar("loss/train", tr_loss, epoch)
            writer.scalar("loss/test", te_loss, epoch)
            for i, leaf in enumerate(warping_params_to_jax(net)):
                writer.summary(f"params/leaf_{i}", leaf, epoch)
            log.info("epoch %d: train %.1f test %.1f (%.4f/frame)",
                     epoch, tr_loss, te_loss, per_frame)
            if te_loss < best_loss:            # best-loss checkpoint (ref :222-235)
                best_loss, best_epoch, stale = te_loss, epoch, 0
                save_params(store, ckpt_name, net)
            else:
                stale += 1
                if stale >= cfg.net.patience:   # early stop (ref :238-240)
                    log.info("early stop at epoch %d (patience %d)", epoch, cfg.net.patience)
                    break
    writer.close()
    elapsed = t_total.elapsed
    return {
        "epochs_run": len(history),
        "best_epoch": best_epoch,
        "best_test_loss": float(best_loss),
        "final_test_l1_per_frame": history[-1]["test_l1_per_frame"],
        "train_seconds": elapsed,
        "steps_run": steps_run,
        "steps_per_s": round(steps_run / max(elapsed, 1e-9), 2),
        "epochs_per_s": round(len(history) / max(elapsed, 1e-9), 3),
        "seconds_to_best": round(elapsed * (best_epoch + 1) / max(len(history), 1), 2),
        "minibatch_utterances": mb,
        "checkpoint": ckpt_name,
        "run_dir": run_dir,
        "history": history,
    }


def apply_warping_net(store: ArtifactStore, cfg: Config, feats, features: str = "dict",
                      *, device: str | torch.device = "cuda") -> torch.Tensor:
    """Warp feature sequences (..., T, D) with the best checkpoint of
    :func:`train_warping_net` and its normalisation stats (the reference's
    unfinished ``02_test_freq_warping_neural``); ``features`` picks the
    feature-suffixed checkpoint."""
    device = resolve_device(device)
    feat_tag = "" if features == "dict" else f"_{features}"
    feats = torch.as_tensor(feats, dtype=torch.float32, device=device)
    mu, sd = 0.0, 1.0
    if store.has(f"warping_norm{feat_tag}"):
        z = store.load(f"warping_norm{feat_tag}")
        mu, sd = (torch.as_tensor(z[k], device=device) for k in ("mu", "sd"))
    net_cfg = _net_config(cfg, features, feats.shape[-1], feats.shape[-1])
    net = load_params(store, f"{cfg.net.checkpoint_name}_warping{feat_tag}", net_cfg).to(device)
    with torch.no_grad():
        return net((feats - mu) / sd) * sd + mu
