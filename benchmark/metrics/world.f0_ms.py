"""Mean over the traced window's requests of the device time of the
``world.f0`` span (the f0 estimate (DIO) and StoneMask) under each ``convert`` span, in ms."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    return spans.per_root_ms(obs, "convert", "world.f0")
