"""Mean over the traced window's requests of the device time of the
``world.d4c`` span (D4C's aperiodicity) under each ``convert`` span, in ms."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    return spans.per_root_ms(obs, "convert", "world.d4c")
