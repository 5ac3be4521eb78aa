"""Mean over the traced window's separations of the device time of the
``separate.em`` spans under each ``separate`` span (the fit: the random
start's draws and the EM iterations), in ms."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    return spans.per_root_ms(obs, "separate", "separate.em")
