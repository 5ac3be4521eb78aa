"""Windows, STFT/ISTFT, mel/MFCC, Griffin-Lim, mel-cepstrum and the
constant-Q family (CQT, MinQT, NSGT) in torch."""

from exemplars_vc_tpu_torch.dsp.cqt import cqt, cqt_frequencies, cqt_magnitude, hybrid_cqt  # noqa: F401
from exemplars_vc_tpu_torch.dsp.minqt import iminqt, minqt, minqt_plan  # noqa: F401
from exemplars_vc_tpu_torch.dsp.nsgt import insgt, nsgt, nsgt_frequencies, nsgt_plan  # noqa: F401
