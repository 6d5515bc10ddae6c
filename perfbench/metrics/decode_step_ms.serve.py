"""Mean host time of a decode step: each round's decode phase (its
lm.decode_step calls with no read between them, until the round's tokens
are on the host) over its steps, ms."""

from perfbench.lib import readers


def read(record):
    return readers.span_ms(record, "decode_step")
