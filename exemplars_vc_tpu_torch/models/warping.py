"""The neural frequency-warping net (port of ``exemplars_vc_tpu/models/warping.py``).

The reference's ``models.Net``: an LSTM stack (2 layers, 20 → 20,
unidirectional by default) whose per-frame output goes through one linear
head ``fc4``, or optionally the ``fc1→tanh→fc2→tanh→fc3`` deep head. Here it
is ``nn.LSTM`` (cuDNN on the card) over padded batches, never packed: the
JAX package runs the backward direction over the padded tail as well, and
so does an unpacked bidirectional ``nn.LSTM``.

The JAX package keeps one bias a gate, ``nn.LSTM`` two. The second,
``bias_hh``, stays at zero and out of training (``requires_grad=False``):
two trainable biases get the same gradient, so RMSprop and the weight decay
would move their sum twice as far as the JAX trainer moves its one bias.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from exemplars_vc_tpu_torch import prng


@dataclass(frozen=True)
class WarpingNetConfig:
    in_size: int = 20
    hidden_size: int = 20
    out_size: int = 20
    nb_lstm_layers: int = 2
    bidirectional: bool = False  # the reference's config knob (config/config:15)
                                 # which its Net hard-codes off (models.py:72)
    deep_head: bool = False     # use the fc1→fc2→fc3 MLP head instead of fc4
    fc_neurons: int = 1024      # reference models.py:60 fc_neuron default


class WarpingNet(nn.Module):
    """(N, T, in_size) → (N, T, out_size)."""

    def __init__(self, cfg: WarpingNetConfig):
        super().__init__()
        self.cfg = cfg
        self.lstm = nn.LSTM(cfg.in_size, cfg.hidden_size, num_layers=cfg.nb_lstm_layers,
                            batch_first=True, bidirectional=cfg.bidirectional)
        for name, p in self.lstm.named_parameters():
            if name.startswith("bias_hh"):
                p.requires_grad_(False)
        h_out = cfg.hidden_size * (2 if cfg.bidirectional else 1)
        if cfg.deep_head:
            self.head = nn.ModuleDict({"fc1": nn.Linear(h_out, cfg.fc_neurons),
                                       "fc2": nn.Linear(cfg.fc_neurons, cfg.fc_neurons),
                                       "fc3": nn.Linear(cfg.fc_neurons, cfg.out_size)})
        else:
            self.head = nn.ModuleDict({"fc4": nn.Linear(h_out, cfg.out_size)})

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, _ = self.lstm(x)
        if "fc4" in self.head:
            return self.head["fc4"](h)
        h = torch.tanh(self.head["fc1"](h))
        h = torch.tanh(self.head["fc2"](h))
        return self.head["fc3"](h)


def warping_forward(net: WarpingNet, x: torch.Tensor) -> torch.Tensor:
    """(T, in_size) → (T, out_size): one utterance through ``net``."""
    return net(x[None])[0]


def warping_forward_batch(net: WarpingNet, x: torch.Tensor) -> torch.Tensor:
    """(N, T, in_size) → (N, T, out_size)."""
    return net(x)


def _jax_slots(cfg: WarpingNetConfig) -> list[tuple[str, str, str]]:
    """The leaves of the JAX parameter tree in ``jax.tree_util`` order (dict
    keys sorted, lists in order): (leaf path, module part, W or b) — the
    ``leaf_i`` order of a JAX checkpoint."""
    heads = ["fc1", "fc2", "fc3"] if cfg.deep_head else ["fc4"]
    slots = [(f"head.{fc}.{wb}", fc, wb) for fc in heads for wb in ("W", "b")]
    for layer in range(cfg.nb_lstm_layers):
        for d in (["bwd", "fwd"] if cfg.bidirectional else ["fwd"]):   # sorted keys
            slots += [(f"lstm[{layer}].{d}.{wb}", f"{layer}.{d}", wb) for wb in ("W", "b")]
    return slots


def _jax_leaf(tree, path: str):
    """The leaf at ``path`` ("head.fc4.W", "lstm[1].bwd.b") of a nested
    dict/list tree."""
    node = tree
    for part in path.replace("[", ".").replace("]", "").split("."):
        node = node[int(part)] if part.isdigit() else node[part]
    return node


def warping_params_from_jax(arrays, cfg: WarpingNetConfig) -> WarpingNet:
    """A :class:`WarpingNet` holding the JAX package's parameters.

    ``arrays`` is the JAX parameter tree with numpy leaves
    (``{"lstm": [{"fwd": {"W", "b"}, …}, …], "head": {…}}``) or the flat
    ``{"leaf_i": …}`` mapping a JAX checkpoint stores. A fused LSTM weight
    ``W (in+H, 4H)`` (gate order i, f, g, o in both packages) becomes
    ``weight_ih = W[:in].T`` and ``weight_hh = W[in:].T``, its bias ``b``
    becomes ``bias_ih`` (``bias_hh`` stays 0); a head ``W (in, out)`` becomes
    ``Linear.weight = W.T``."""
    slots = _jax_slots(cfg)
    if "leaf_0" in arrays:
        if len(arrays) != len(slots):
            raise ValueError(f"{len(arrays)} leaves for a net of {len(slots)}: {cfg}")
        leaves = {path: arrays[f"leaf_{i}"] for i, (path, _, _) in enumerate(slots)}
    else:
        leaves = {path: _jax_leaf(arrays, path) for path, _, _ in slots}
    net = WarpingNet(cfg)
    state = {}
    for path, part, wb in slots:
        a = torch.tensor(np.asarray(leaves[path], dtype=np.float32))
        if path.startswith("head"):
            state[f"head.{part}.{'weight' if wb == 'W' else 'bias'}"] = a.T if wb == "W" else a
            continue
        layer, d = part.split(".")
        sfx = f"l{layer}" + ("_reverse" if d == "bwd" else "")
        if wb == "W":
            d_in = a.shape[0] - cfg.hidden_size
            state[f"lstm.weight_ih_{sfx}"] = a[:d_in].T
            state[f"lstm.weight_hh_{sfx}"] = a[d_in:].T
        else:
            state[f"lstm.bias_ih_{sfx}"] = a
            state[f"lstm.bias_hh_{sfx}"] = torch.zeros_like(a)
    net.load_state_dict(state)
    return net


def warping_params_to_jax(net: WarpingNet) -> list[np.ndarray]:
    """The net's parameters as the JAX tree's leaves, in ``leaf_i`` order
    (the inverse of :func:`warping_params_from_jax`; the two LSTM biases
    summed into the one)."""
    sd = {k: v.detach().cpu().numpy() for k, v in net.state_dict().items()}
    out = []
    for path, part, wb in _jax_slots(net.cfg):
        if path.startswith("head"):
            out.append(sd[f"head.{part}.weight"].T.copy() if wb == "W"
                       else sd[f"head.{part}.bias"].copy())
            continue
        layer, d = part.split(".")
        sfx = f"l{layer}" + ("_reverse" if d == "bwd" else "")
        if wb == "W":
            out.append(np.concatenate([sd[f"lstm.weight_ih_{sfx}"].T,
                                       sd[f"lstm.weight_hh_{sfx}"].T], axis=0))
        else:
            out.append(sd[f"lstm.bias_ih_{sfx}"] + sd[f"lstm.bias_hh_{sfx}"])
    return out


def init_warping_params(key: torch.Tensor, cfg: WarpingNetConfig) -> WarpingNet:
    """A freshly initialised net (on the CPU) holding the JAX package's
    ``init_warping_params(key, cfg)`` draws: per LSTM layer and direction a
    fused weight uniform in ±1/√H from the second half of a split of the
    running key (biases 0, the forget gate's 1), then a five-way split whose
    subkeys 1-3 draw the deep head and 4 the ``fc4`` head, uniform in
    ±1/√fan_in. The bounds are float32 as JAX computes them."""
    def scale(n: int) -> float:
        return float(np.float32(1.0) / np.sqrt(np.float32(n)))

    h = cfg.hidden_size
    n_dir = 2 if cfg.bidirectional else 1
    tree: dict = {"lstm": [], "head": {}}
    for layer in range(cfg.nb_lstm_layers):
        d_in = cfg.in_size if layer == 0 else h * n_dir
        dirs = {}
        for direction in (["fwd", "bwd"] if cfg.bidirectional else ["fwd"]):
            key, k1 = prng.split(key)
            b = torch.zeros(4 * h)
            b[h : 2 * h] = 1.0
            dirs[direction] = {"W": prng.uniform(k1, (d_in + h, 4 * h), minval=-scale(h),
                                                 maxval=scale(h)), "b": b}
        tree["lstm"].append(dirs)
    _, k1, k2, k3, k4 = prng.split(key, 5)
    h_out = h * n_dir

    def fc(k, n_in, n_out, s):
        return {"W": prng.uniform(k, (n_in, n_out), minval=-s, maxval=s),
                "b": torch.zeros(n_out)}

    if cfg.deep_head:
        s1, s2 = scale(h_out), scale(cfg.fc_neurons)
        tree["head"] = {"fc1": fc(k1, h_out, cfg.fc_neurons, s1),
                        "fc2": fc(k2, cfg.fc_neurons, cfg.fc_neurons, s2),
                        "fc3": fc(k3, cfg.fc_neurons, cfg.out_size, s2)}
    else:
        tree["head"] = {"fc4": fc(k4, h_out, cfg.out_size, scale(h_out))}
    return warping_params_from_jax(tree, cfg)
