"""Entry ``serve_quality``: the ``serve`` entry's requests, driver and
observations (``Converter.convert`` on one wav a request, on a
``Converter`` prepared in set-up) on a configuration of the ``quality``
preset; the reference converts the same clip with the KL solve, the warped
dictionary and the box filter of :mod:`benchmark.reference.quality`."""

from __future__ import annotations

import numpy as np

from benchmark.entries.serve import LATENCY, Driver, observe, requests  # noqa: F401
from benchmark.reference import quality as ref


def reference(sessions: dict, settings: dict, params: dict, data_path: str, device, tf32: bool,
              built: dict) -> dict:
    with ref.precision(tf32):
        if tf32 not in built:
            built[tf32] = ref.build_dictionaries(settings, data_path, device)
        return {k: ref.convert_one(clips[0].samples.astype(np.float64) / 32768.0, built[tf32],
                                   settings, device)
                for k, clips in sessions.items()}
