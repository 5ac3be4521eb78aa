"""WORLD-class analysis and synthesis in PyTorch (port of
``exemplars_vc_tpu/world``): DIO, Harvest and NCC f0 estimators, StoneMask
refinement, CheapTrick envelopes, D4C aperiodicity and a harmonic + shaped
noise synthesizer. Every function takes tensors on any device, batched
over leading utterances where its docstring says so; none launches a
hand-written kernel (the JAX package computes all of this in XLA, outside
its Pallas kernels), so they run on cuFFT, cuBLAS and torch's own kernels."""

from exemplars_vc_tpu_torch.world.analysis import WorldFeatures, analyze  # noqa: F401
from exemplars_vc_tpu_torch.world.cheaptrick import cheaptrick, world_fft_size  # noqa: F401
from exemplars_vc_tpu_torch.world.d4c import d4c_aperiodicity  # noqa: F401
from exemplars_vc_tpu_torch.world.dio import estimate_f0_dio  # noqa: F401
from exemplars_vc_tpu_torch.world.f0 import (  # noqa: F401
    estimate_f0,
    estimate_f0_tracked,
    refine_f0_stonemask,
)
from exemplars_vc_tpu_torch.world.harvest import estimate_f0_harvest  # noqa: F401
from exemplars_vc_tpu_torch.world.synthesis import synthesize  # noqa: F401
