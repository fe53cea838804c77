"""The device's idle share in the victim's training: the busy time of its
traced steps against the window's time a step."""

from h100_bench.core.readers import idle_pct


def read(record):
    return idle_pct(record, "train_ae")
