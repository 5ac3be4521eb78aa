"""The neural warping net (``nn.LSTM`` + linear head) and its trainer."""

from exemplars_vc_tpu_torch.models.warping import (  # noqa: F401
    WarpingNetConfig,
    init_warping_params,
    warping_forward,
    warping_forward_batch,
)
