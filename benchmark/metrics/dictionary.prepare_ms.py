"""The dictionary's preparation: ``Converter.prepare_seconds``, the program's
fenced timer around the DTW alignment, the conversion features and the
exemplar gather, in ms."""


def read(obs):
    s = obs.get("prepare_s")
    return None if s is None else s * 1e3
