"""Mean over the traced window's requests of the device time of the
``features`` span under each ``convert`` span (``Converter.convert``, as
served), in ms."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    return spans.per_root_ms(obs, "convert", "features")
