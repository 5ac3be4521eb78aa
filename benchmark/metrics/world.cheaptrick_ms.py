"""Mean over the traced window's requests of the device time of the
``world.cheaptrick`` span (CheapTrick's spectral envelope) under each ``convert`` span, in ms."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    return spans.per_root_ms(obs, "convert", "world.cheaptrick")
