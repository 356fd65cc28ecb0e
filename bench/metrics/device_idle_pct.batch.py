"""The device's idle share of the traced batches, in percent
(``bench.trace.idle_pct``)."""

from bench import trace


def read(record):
    return trace.idle_pct(record["trace"])
