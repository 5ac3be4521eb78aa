"""Mean over the traced window's requests of the device time of the
``synthesis`` span under each ``convert`` span (Griffin-Lim or the WORLD
synthesizer, and the audio's copy to the host, as served), in ms."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    return spans.per_root_ms(obs, "convert", "synthesis")
