"""Mean over the traced window's separations of the device time of the
``separate.images`` spans under each ``separate`` span (the Wiener filter
and the ISTFT of the source images), in ms."""

from benchmark.harness import spans

snapshot = spans.cursor


def read(obs):
    return spans.per_root_ms(obs, "separate", "separate.images")
