"""Dictionary build, conversion features and ``convert_utterance``."""

from exemplars_vc_tpu_torch.pipelines.make_dict import make_dictionary  # noqa: F401
from exemplars_vc_tpu_torch.pipelines.conv_dicts import build_conversion_dicts  # noqa: F401
from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance  # noqa: F401
from exemplars_vc_tpu_torch.pipelines.evaluate import (  # noqa: F401
    evaluate_heldout,
    heldout_pair,
    no_conversion_baseline,
)
