"""The device's idle share in the attack: the busy time of its traced
iterations (320-420 of a call) against the window's time an iteration."""

from h100_bench.core.readers import idle_pct


def read(record):
    return idle_pct(record, "attack")
