"""Mean over the traced window's pushes of the device time of the ``solve``
span under each ``push`` span (the chunk's activation solve and Y = H·B),
in ms."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    return spans.per_root_ms(obs, "push", "solve")
