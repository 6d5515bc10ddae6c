"""Serving's model FLOPs (2 a matmul weight a token, the head at a prompt's
last position only, plus the mixing, over prompt and generated tokens) over
the window, as a share of the bf16 peak, %."""

from perfbench.lib import readers


def read(record):
    return readers.mfu(record)
