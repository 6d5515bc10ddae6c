"""WKV6's forward as the models call it: ``repro_torch.kernels.ops.wkv6``
(the prefill, decode and training forms alike). Its work is the frozen
``wkv6_work`` at the call's shapes, its products fp32 multiply-adds."""

from perfbench.lib import yardstick as ys

TARGET = ("repro_torch.kernels.ops", "wkv6")


def work(r, k, v, logw, u, s0):
    B, H, T, K = r.shape
    flops, nbytes = ys.wkv6_work(B, H, T, K, r.element_size())
    return flops, nbytes, ys.PEAK_FLOPS_BY_DTYPE["float32"]
