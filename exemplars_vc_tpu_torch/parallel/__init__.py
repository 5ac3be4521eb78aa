"""Multi-process parallelism: the (data × dict) rank grid, the
dictionary-sharded NMF, the data-parallel and the sequence-parallel DTW, and
the process-group bootstrap (port of ``exemplars_vc_tpu/parallel``)."""

from exemplars_vc_tpu_torch.parallel.mesh import make_mesh, shard_batch  # noqa: F401
from exemplars_vc_tpu_torch.parallel.sharded_nmf import sharded_nmf_activations  # noqa: F401
from exemplars_vc_tpu_torch.parallel.sharded_dtw import sharded_dtw_batch  # noqa: F401
from exemplars_vc_tpu_torch.parallel.distributed import initialize_multihost  # noqa: F401
