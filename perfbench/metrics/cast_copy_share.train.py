"""Share of the traced train steps' device time in copy and cast kernels,
by chip_smoke.py's classification of kernel names, %."""

from perfbench.lib import readers


def read(record):
    return readers.kind_share(record, "casts and copies")
