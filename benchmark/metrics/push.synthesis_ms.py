"""Mean over the traced window's pushes of the device time of the
``synthesis`` span under each ``push`` span (Griffin-Lim over the context
and the chunk, and the audio's copy to the host), in ms."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    return spans.per_root_ms(obs, "push", "synthesis")
