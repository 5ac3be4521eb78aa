"""Windows, STFT/ISTFT, mel/MFCC, Griffin-Lim, mel-cepstrum, LPC/LSP and the
constant-Q family (CQT, MinQT, NSGT) in torch.

As in the JAX package, the names below are functions: ``dsp.stft``,
``dsp.mcep``, ``dsp.griffin_lim``, ``dsp.lpc``, ``dsp.cqt``, ``dsp.minqt``
and ``dsp.nsgt`` shadow their modules, which ``importlib.import_module``
still returns."""

from exemplars_vc_tpu_torch.dsp.windows import get_window  # noqa: F401
from exemplars_vc_tpu_torch.dsp.stft import frame_signal, istft, stft, stft_magnitude  # noqa: F401
from exemplars_vc_tpu_torch.dsp.mel import dct_matrix, mel_filterbank, melspectrogram, mfcc  # noqa: F401
from exemplars_vc_tpu_torch.dsp.griffin_lim import griffin_lim  # noqa: F401
from exemplars_vc_tpu_torch.dsp.cqt import cqt, cqt_frequencies, cqt_magnitude, hybrid_cqt  # noqa: F401
from exemplars_vc_tpu_torch.dsp.minqt import iminqt, minqt, minqt_plan  # noqa: F401
from exemplars_vc_tpu_torch.dsp.nsgt import insgt, nsgt, nsgt_frequencies, nsgt_plan  # noqa: F401
from exemplars_vc_tpu_torch.dsp.mcep import mcep, mcep_frames, mcep_to_spectrum, warped_basis  # noqa: F401
from exemplars_vc_tpu_torch.dsp.lpc import lpc, lpc_to_lsp  # noqa: F401
