"""The device's idle share of the traced round's wall time, %."""

from perfbench.lib import readers


def read(record):
    return readers.idle(record)
