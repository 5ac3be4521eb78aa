"""Mean over the traced window's requests of the device time of the
``h_smooth`` span (the box filter on H, inside each request's ``solve``),
in ms. None where the program records no such span."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    return spans.per_root_ms(obs, "convert", "h_smooth")
