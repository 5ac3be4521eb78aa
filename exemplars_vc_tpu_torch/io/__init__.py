"""The port's IO: wav read/write (``wav``), speaker loading, padded batching
and the artifact store (``store``), the native batch wav loader (``native``)
and the stand-in corpus (``standin``). ``wav``, ``store`` and
``native`` are the port's own copies of the JAX package's modules of the same
names, with the same behaviour."""

from exemplars_vc_tpu_torch.io.store import (  # noqa: F401
    ArtifactStore,
    bucketed_signal,
    load_speaker,
    pad_to_bucket,
    stack_ragged,
)
from exemplars_vc_tpu_torch.io.wav import read_wav, write_wav  # noqa: F401
