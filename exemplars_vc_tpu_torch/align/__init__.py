"""Wavefront DTW (CUDA kernels + plain twins) and exemplar gathers."""

from exemplars_vc_tpu_torch.align.dtw import dtw, dtw_batch, pairwise_sqdist  # noqa: F401
from exemplars_vc_tpu_torch.align.exemplar import (  # noqa: F401
    build_exemplar_dicts,
    build_exemplar_dicts_padded,
    gather_aligned,
)
