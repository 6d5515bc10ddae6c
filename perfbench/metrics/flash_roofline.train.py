"""Attention's forward and gradient in the traced train steps: the frozen
bounds of their calls over the device time inside their spans, %."""

from perfbench.lib import readers

ENTRIES = ("flash", "flash.backward")


def read(record):
    return readers.roofline(record, ENTRIES)
