"""Held-out evaluation: the reference's own protocol (port of the path
helpers of ``exemplars_vc_tpu/pipelines/evaluate.py``).

The reference's conversion evaluation is fixed to utterance 100162, which is
not in the dictionary-build set; its source/target pair lies in a ``wav/``
directory beside the ``data/`` root. The scoring functions of the module
(``evaluate_heldout``, ``evaluate_loo``) are not ported yet (ROADMAP queue 1
item 14).
"""

from __future__ import annotations

import os

HELD_OUT_UTT = "100162"


def heldout_pair(data_path: str, src: str = "SF1", tar: str = "TF1") -> tuple[str, str]:
    """Paths of the held-out source and target wavs, ``<root>/wav/<speaker>_100162.wav``
    with ``<root>`` the parent of ``data_path``."""
    base = os.path.join(os.path.dirname(os.path.abspath(data_path)), "wav")
    return (os.path.join(base, f"{src}_{HELD_OUT_UTT}.wav"),
            os.path.join(base, f"{tar}_{HELD_OUT_UTT}.wav"))
