"""Mean host time of a round's prefill (lm.prefill), ending in a
synchronize, ms."""

from perfbench.lib import readers


def read(record):
    return readers.span_ms(record, "prefill")
