"""Source separation in torch (port of the core of
``exemplars_vc_tpu/separate``; the reference's vendored pyfasst toolbox):

- ``glue``: host float64 input transforms, device STFT stacking, Wiener
  splits and source-image ISTFTs, spatial-covariance builders;
- ``isnmf``: Itakura-Saito NMF (``tools/nmf.py:NMF_decomp_init``) and the
  Durrieu source/filter variant (``SFNMF_decomp_init``);
- ``multichannel``: EM of the FASST local Gaussian model (per-source NMF
  spectral power × full-rank spatial covariance), Wiener separation,
  ``separate_signal``;
- ``hmm``: HMM/SHMM spectral-state models, Viterbi-decoded
  (``MultiChanHMM``);
- ``demix``: DEMIX anechoic mixing-direction clustering (``demixTF.py``);
- ``beamform``: ULA steering vectors, MVDR filters, directivity diagrams;
- ``lead``: SIMM lead/accompaniment separation — source/filter melody
  model, Viterbi melody tracking, two-pass estimation, Wiener resynthesis
  (``SeparateLeadStereo``/``SIMM``);
- ``stereo_simm``: the stereo SIMM (``SIMM.py:Stereo_SIMM``) and its
  two-round VUIMM schedule;
- ``lead_multichannel``: the composed source-F0-filter multichannel model
  and the ``multichanLead`` schedule.

Every entry point takes ``device`` (default ``"cuda"``; a CUDA device
without a card raises) and, where the JAX package takes a PRNG key,
``key``: a key of ``exemplars_vc_tpu_torch.prng`` (``PRNGKey(0)`` when None,
as in the JAX package), split and drawn as the JAX package does, on the CPU,
then moved. The Viterbi tracker is ``align.viterbi``.
"""

from exemplars_vc_tpu_torch.separate.beamform import (
    apply_beamformer,
    directivity_diagram,
    mvdr_filter,
    ula_steering,
)
from exemplars_vc_tpu_torch.separate.demix import DemixEstimate, demix
from exemplars_vc_tpu_torch.separate.hmm import (
    HMMSpectra,
    fit_hmm_spectra,
    fit_multichannel_hmm,
    sticky_transition,
)
from exemplars_vc_tpu_torch.separate.isnmf import is_divergence, is_nmf, sf_nmf
from exemplars_vc_tpu_torch.separate.lead import (
    LeadSeparation,
    harmonic_dictionary,
    hann_filter_basis,
    separate_lead,
)
from exemplars_vc_tpu_torch.separate.multichannel import (
    MultichannelNMF,
    fit_multichannel_nmf,
    separate_signal,
)
from exemplars_vc_tpu_torch.separate.lead_multichannel import (
    MultichannelLead,
    MultichannelSF,
    fit_multichannel_sf,
    separate_lead_multichannel,
)
from exemplars_vc_tpu_torch.separate.stereo_simm import (
    StereoLeadSeparation,
    StereoSIMM,
    separate_lead_stereo,
    stereo_simm,
)

__all__ = [
    "is_nmf",
    "is_divergence",
    "sf_nmf",
    "MultichannelNMF",
    "fit_multichannel_nmf",
    "separate_signal",
    "DemixEstimate",
    "demix",
    "HMMSpectra",
    "fit_hmm_spectra",
    "fit_multichannel_hmm",
    "sticky_transition",
    "LeadSeparation",
    "harmonic_dictionary",
    "hann_filter_basis",
    "separate_lead",
    "StereoSIMM",
    "StereoLeadSeparation",
    "stereo_simm",
    "separate_lead_stereo",
    "MultichannelSF",
    "MultichannelLead",
    "fit_multichannel_sf",
    "separate_lead_multichannel",
    "ula_steering",
    "mvdr_filter",
    "directivity_diagram",
    "apply_beamformer",
]
