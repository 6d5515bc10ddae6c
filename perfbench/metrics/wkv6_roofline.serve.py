"""WKV6's prefill and decode calls in the traced round: the frozen bounds
of their calls over the device time inside their spans, %."""

from perfbench.lib import readers

ENTRIES = ("wkv6",)


def read(record):
    return readers.roofline(record, ENTRIES)
