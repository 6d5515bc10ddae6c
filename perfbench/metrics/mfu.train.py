"""The train step's model FLOPs (the frozen count, no recompute) over the
window, as a share of the bf16 peak, %."""

from perfbench.lib import readers


def read(record):
    return readers.mfu(record)
