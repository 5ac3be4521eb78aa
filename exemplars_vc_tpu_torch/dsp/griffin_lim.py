"""Fast Griffin-Lim phase reconstruction (port of
``exemplars_vc_tpu/dsp/griffin_lim.py``), plain torch over ``torch.fft``.

Each iteration projects mag∘angles onto consistent spectrograms (ISTFT then
STFT at the magnitude's natural length, trimmed to its frame count: the
centered, reflect-padded projection, whose fixed point is the production's),
then extrapolates with momentum μ/(1+μ) (Perraudin et al. 2013; μ = 0 is the
classic update).

Which route the iterations take is decided up front from the device and the
shape alone:

- On a CUDA tensor (``_graph=True``, ``n_iter > 0``) whose shape
  ``griffin_lim_cuda.fused_route`` accepts (hop divides n_fft, a tile that
  fits shared memory: up to 19 frames an SM at n_fft 400, so 2,508 frames on
  132 SMs, ~25 s;
  F ≥ 4 for the reflect pad), all iterations are one cooperative launch of
  the fused kernel with ``center=True``, which computes this same centered
  projection in float64 (``griffin_lim.fused`` counts these calls). Every
  served and streamed synthesis takes it; a new length costs no capture.
- Any other CUDA shape replays captured CUDA graphs, the counterpart of the
  reference's ``lax.fori_loop`` compiled once: ~20 small kernels an
  iteration, which run eagerly take ~10× their device time in launches. A
  graph holds ``GRAPH_BLOCK`` iterations over static buffers (magnitude,
  angles, momentum state) and is replayed ``n_iter // GRAPH_BLOCK`` times,
  a graph of the remainder once; both are captured at the first call of a
  shape and kept (``griffin_lim.captures`` counts captures). While a
  profiler records, each miss of the cache (a new shape's buffers and the
  least recent shape's eviction) and each capture is a
  ``griffin_lim.capture`` span (``obs.profiling``). The same kernels run in
  the same order as the eager loop, so the result is bit-equal to it.
- ``_graph=False`` runs the eager loop (the CPU always does).

The fused route differs from the float32 loops only in rounding (float64
transforms in place of float32 cuFFT).
"""

from __future__ import annotations

import math
import threading
from collections import OrderedDict

import torch

from exemplars_vc_tpu_torch import prng
from exemplars_vc_tpu_torch.dsp.griffin_lim_cuda import fused_route, gl_angles_fused
from exemplars_vc_tpu_torch.dsp.stft import istft, stft
from exemplars_vc_tpu_torch.obs.profiling import Timer

# iterations a captured graph holds: blocks of 10 captured faster and
# replayed no slower than blocks of 50 or one graph of all 300 (PERF.md), so
# each new utterance length (a new shape) stays cheap
GRAPH_BLOCK = 10
_GRAPHS_KEPT = 8       # shapes whose graphs stay captured, least recent dropped


def _iterate(mag: torch.Tensor, angles: torch.Tensor, prev: torch.Tensor, n_fft: int,
             hop_length: int, alpha: float, n_iter: int):
    for _ in range(n_iter):
        y = istft(mag * angles, n_fft=n_fft, hop_length=hop_length)
        rebuilt = stft(y, n_fft=n_fft, hop_length=hop_length)[: mag.shape[0]]
        t = rebuilt - alpha * prev
        angles = t / torch.clamp(torch.abs(t), min=1e-16)
        prev = rebuilt
    return angles, prev


class _GraphedLoop:
    """Captured blocks of iterations for one (device, shape, n_fft, hop,
    momentum), over static buffers that carry the state from block to
    block; the graphs share one memory pool (they replay in turn on one
    stream)."""

    def __init__(self, shape: tuple, device: torch.device, n_fft: int, hop_length: int,
                 alpha: float):
        self.mag = torch.zeros(shape, dtype=torch.float32, device=device)
        self.angles = torch.ones(shape, dtype=torch.complex64, device=device)
        self.prev = torch.zeros(shape, dtype=torch.complex64, device=device)
        self.args = (n_fft, hop_length, alpha)
        self.pool = torch.cuda.graph_pool_handle()
        self.graphs: dict[int, torch.cuda.CUDAGraph] = {}
        self.lock = threading.Lock()
        self.done = torch.cuda.Event()
        # one eager iteration on a side stream first: cuFFT's plans and the
        # STFT's window are made outside the capture
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            _iterate(self.mag, self.angles, self.prev, *self.args, 1)
        torch.cuda.current_stream(device).wait_stream(side)

    def _graph(self, n_iter: int) -> torch.cuda.CUDAGraph:
        g = self.graphs.get(n_iter)
        if g is None:
            with Timer(self.mag.device, name="griffin_lim.capture"):
                g = torch.cuda.CUDAGraph()
                with torch.cuda.graph(g, pool=self.pool):
                    angles, prev = _iterate(self.mag, self.angles, self.prev, *self.args,
                                            n_iter)
                    self.angles.copy_(angles)
                    self.prev.copy_(prev)
            self.graphs[n_iter] = g
            griffin_lim.captures += 1
        return g

    def run(self, mag: torch.Tensor, angles: torch.Tensor, n_iter: int) -> torch.Tensor:
        block = GRAPH_BLOCK
        stream = torch.cuda.current_stream(self.mag.device)
        # the static buffers are shared: callers enqueue one at a time, and a
        # caller on another stream waits until the last one's result is out
        with self.lock:
            stream.wait_event(self.done)
            self.mag.copy_(mag)
            self.angles.copy_(angles)
            self.prev.zero_()
            for _ in range(n_iter // block):
                self._graph(block).replay()
            if n_iter % block:
                self._graph(n_iter % block).replay()
            out = self.angles.clone()
            self.done.record(stream)
        return out


_loops: OrderedDict[tuple, _GraphedLoop] = OrderedDict()
_loops_lock = threading.Lock()


def _graphed_loop(mag: torch.Tensor, n_fft: int, hop_length: int,
                  alpha: float) -> _GraphedLoop:
    key = (mag.device, tuple(mag.shape), n_fft, hop_length, alpha)
    with _loops_lock:
        loop = _loops.get(key)
        if loop is None:
            with Timer(mag.device, name="griffin_lim.capture"):
                loop = _loops[key] = _GraphedLoop(tuple(mag.shape), mag.device, n_fft,
                                                  hop_length, alpha)
                if len(_loops) > _GRAPHS_KEPT:
                    _loops.popitem(last=False)
        _loops.move_to_end(key)
        return loop


def griffin_lim(magnitude: torch.Tensor, n_fft: int = 400, hop_length: int = 80,
                n_iter: int = 300, length: int | None = None, momentum: float = 0.9,
                key: torch.Tensor | None = None,
                init_phase: torch.Tensor | None = None,
                return_phase: bool = False, _graph: bool = True):
    """(n_frames, n_bins) magnitude → time signal.

    ``init_phase``: a complex STFT with at least ``n_frames`` frames whose
    angles seed the iteration (the source utterance's phase on the
    conversion path); exactly-zero bins get unit phase. Without it the
    phases start uniform-random, 2π·``uniform(key)`` (``key`` ``PRNGKey(0)``
    when None, as in the JAX package; drawn on the CPU, then moved).
    On a CUDA tensor the iterations run in the fused kernel or replay
    captured graphs, by shape (module docstring); a launch or a capture
    that fails raises."""
    mag = torch.clamp(magnitude, min=0.0).float()
    if init_phase is not None:
        ip = init_phase[: mag.shape[0]].to(torch.complex64)
        a = torch.abs(ip)
        angles = torch.where(a > 0.0, ip / torch.clamp(a, min=1e-16),
                             torch.ones((), dtype=torch.complex64, device=mag.device))
    else:
        u = prng.uniform(prng.key_or_default(key), mag.shape).to(mag.device)
        angles = torch.polar(torch.ones_like(u), 2.0 * math.pi * u)

    alpha = momentum / (1.0 + momentum)
    on_card = mag.device.type == "cuda" and _graph
    if on_card and fused_route(
            mag.shape[0], n_fft, hop_length, n_iter,
            torch.cuda.get_device_properties(mag.device).multi_processor_count):
        angles = gl_angles_fused(mag, angles, n_fft, hop_length, n_iter, momentum, center=True)
        griffin_lim.fused += 1
    elif on_card and n_iter > 0:
        angles = _graphed_loop(mag, n_fft, hop_length, alpha).run(mag, angles, n_iter)
    else:
        angles, _ = _iterate(mag, angles, torch.zeros_like(angles), n_fft, hop_length, alpha,
                             n_iter)
    y = istft(mag * angles, n_fft=n_fft, hop_length=hop_length, length=length)
    if return_phase:
        return y, angles
    return y


griffin_lim.captures = 0
griffin_lim.fused = 0
