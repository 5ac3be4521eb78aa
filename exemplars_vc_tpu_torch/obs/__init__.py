"""Run logging, MCD and spectral-convergence metrics, a stage timer and
``torch.profiler`` trace capture."""

from exemplars_vc_tpu_torch.obs.logging import get_logger, new_run_dir  # noqa: F401
from exemplars_vc_tpu_torch.obs.metrics import mcd, mcd_aligned, spectral_convergence  # noqa: F401
from exemplars_vc_tpu_torch.obs.profiling import Timer, trace_to  # noqa: F401
