"""Mean over the traced window's requests of the device time of the
``solve`` span under each ``convert`` span (the KL solve, the box filter
and Y = H·B, as served), in ms."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    return spans.per_root_ms(obs, "convert", "solve")
