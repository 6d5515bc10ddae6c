"""Arithmetic the per-layer metric readers share. A reader returns None
where its cell gives it nothing to read; a share of a roofline or of a peak
is never given as 0 for want of data."""

from __future__ import annotations

from perfbench.lib import yardstick as ys

# the port's chip_smoke.py classification of device time by kernel name
# (KERNEL_KINDS, as it stood when this benchmark was defined), with the
# runtime's own copies ("Memcpy DtoD") counted as copies: the first kind
# whose names the lower-cased operation name holds
KERNEL_KINDS = (("flash", ("flash_fwd_", "decode_attention_")),
                ("GEMMs", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
                ("routing", ("sort", "scatter", "gather", "index")),
                ("casts and copies", ("copy", "cast", "memcpy")))


def kind(name):
    low = name.lower()
    return next((k for k, names in KERNEL_KINDS
                 if any(n in low for n in names)), "other")


def mfu(record):
    """Model FLOPs of the window's work over its seconds, as a share of the
    bf16 dense peak, in %."""
    if not record.get("model_flops") or not record.get("window_s"):
        return None
    return 100.0 * record["model_flops"] / record["window_s"] / ys.PEAK_FLOPS


def kind_share(record, wanted):
    """Share of the traced device time in kernels of kind ``wanted``, %."""
    ops = record["trace"]["ops"]
    total = sum(ops.values())
    if not total:
        return None
    return 100.0 * sum(s for n, s in ops.items() if kind(n) == wanted) / total


def span_ms(record, span):
    """Mean host time of a span, ms."""
    times = record.get("spans", {}).get(span)
    return 1e3 * sum(times) / len(times) if times else None


def roofline(record, entries):
    """The entries' calls' bounds over their device time, %."""
    calls = [c for e in entries
             for c in record["trace"]["entries"].get(e, ())]
    device = sum(d for d, _ in calls)
    if not calls or device <= 0:
        return None
    return 100.0 * sum(b for _, b in calls) / device


def idle(record):
    """The device's idle share of the traced window, %."""
    t = record["trace"]
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"]) if t["window_s"] \
        else None
