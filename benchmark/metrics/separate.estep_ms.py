"""Mean over the traced window's separations of the device time of the
``separate.estep`` spans under each ``separate`` span (the E-steps with
their spatial M-steps, one span an EM iteration, summed), in ms."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    return spans.per_root_ms(obs, "separate", "separate.estep")
