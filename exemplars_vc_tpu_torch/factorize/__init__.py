"""Fixed-dictionary MU NMF (CUDA kernels + plain twins) and conversion."""

from exemplars_vc_tpu_torch.factorize.nmf import (  # noqa: F401
    NmfState,
    convert_features,
    nmf_activations,
    prune_topk_refine,
    residual_compensation,
    sharpen_activations,
)
from exemplars_vc_tpu_torch.factorize.qrmf import nnls_activations, qr_activations  # noqa: F401
