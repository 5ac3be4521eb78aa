"""exemplars_vc_tpu_torch — the exemplar-VC conversion path in PyTorch + CUDA.

A port of the STFT conversion path of :mod:`exemplars_vc_tpu` (the JAX
package, which stays the reference) to PyTorch on an NVIDIA H100:

- ``dsp``        periodic hann, STFT/ISTFT over ``torch.fft``, mel/MFCC,
                 Griffin-Lim, mel-cepstrum
- ``align``      pairwise cost, wavefront DTW + backtrace (CUDA kernels
                 ``csrc/dtw_wavefront.cu``), exemplar gathers
- ``factorize``  fixed-dictionary MU NMF (CUDA kernels ``csrc/nmf_mu.cu``)
- ``pipelines``  dictionary build, conversion features, ``convert_utterance``
- ``obs``        MCD metrics and a stage timer
- ``io``         wav IO, the artifact store, the native batch wav loader and
                 the stand-in corpus made of the in-repo speech
- ``config``     the typed configuration (``load_config``)
- ``kernels``    the nvcc build + ctypes loader for ``csrc/*.cu``

Every kernel wrapper takes a CUDA tensor to its hand-written kernel (or
raises) and a CPU tensor to the plain-PyTorch twin beside it. The package
imports ``torch`` and nothing of ``jax`` or of the JAX package: it keeps its
own copies of the configuration, wav IO and the artifact store.
"""

from exemplars_vc_tpu_torch import device as _device  # noqa: F401  (fp32 parity flags)

__version__ = "0.1.0"
