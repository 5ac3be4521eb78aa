"""The WORLD path's stand-in MCD in the JAX package and in the port, on the
CPU, at the tests' size: the synthetic corpus of ``tests/torch_corpus.py``
(3 vowel-sequence pairs, held-out pair), ``nmf.max_iter=20``,
``data.use_stft=false``, each package's ``convert_utterance`` with
``reference_wav``. The synthesizer's noise is each package's default draw.
With ``--base DIR`` the port of another checkout (the parent, say) converts
too, for a before and after. Prints one JSON line.

    python tools/world_mcd_parity.py [--base DIR]
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVERRIDES = ["data.tar=TF1", "misc.nb_file=3", "nmf.max_iter=20", "data.use_stft=false"]

PORT_RUN = """
import json, sys
sys.path.insert(0, sys.argv[1])
from exemplars_vc_tpu_torch.config import load_config
from exemplars_vc_tpu_torch.io.store import ArtifactStore
from exemplars_vc_tpu_torch.pipelines.convert import convert_utterance
data, src, tar, store = sys.argv[2:6]
res = convert_utterance(load_config(overrides=sys.argv[6:]), ArtifactStore(store), data, src,
                        nb_file=3, reference_wav=tar, device="cpu")
print(json.dumps({"mcd_db": float(res.mcd_vs_reference), "samples": int(len(res.audio))}))
"""


def port_mcd(root: str, corpus, store: str) -> dict:
    """The port of the checkout at ``root`` in a fresh process (its own
    imports), on ``corpus``."""
    out = subprocess.run([sys.executable, "-c", PORT_RUN, root, *corpus, store, *OVERRIDES],
                         capture_output=True, text=True, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--base", default=None, help="another checkout whose port to run too")
    args = ap.parse_args()
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    from torch_corpus import write_synthetic_corpus

    from exemplars_vc_tpu.config import load_config
    from exemplars_vc_tpu.io.store import ArtifactStore
    from exemplars_vc_tpu.pipelines.convert import convert_utterance

    with tempfile.TemporaryDirectory() as d:
        corpus = write_synthetic_corpus(os.path.join(d, "corpus"))
        data, src, tar = corpus
        ref = convert_utterance(load_config(overrides=OVERRIDES),
                                ArtifactStore(os.path.join(d, "jax")), data, src, nb_file=3,
                                reference_wav=tar)
        out = {"jax": {"mcd_db": float(ref.mcd_vs_reference), "samples": int(len(ref.audio))},
               "port": port_mcd(ROOT, corpus, os.path.join(d, "port"))}
        if args.base:
            out["base_port"] = port_mcd(os.path.abspath(args.base), corpus,
                                        os.path.join(d, "base"))
    print(json.dumps(out))


if __name__ == "__main__":
    sys.exit(main())
