"""The device's idle share of the traced train steps' wall time, %."""

from perfbench.lib import readers


def read(record):
    return readers.idle(record)
