"""Attention's forward as the models call it:
``repro_torch.kernels.ops.flash_attention`` (model layout, q (B,S,H,hd),
k/v (B,T,KV,hd)). Its work is the frozen ``flash_work``, at the peak of q's
dtype."""

from perfbench.lib import yardstick as ys

TARGET = ("repro_torch.kernels.ops", "flash_attention")


def work(q, k, v, *, causal=True, window=0, softcap=0.0, seq_k=None,
         q_offset=0):
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    flops, nbytes = ys.flash_work(B, H, KV, S, T if seq_k is None else seq_k,
                                  hd, q.element_size(), k.element_size(),
                                  causal, window, q_offset)
    return flops, nbytes, ys.PEAK_FLOPS_BY_DTYPE[str(q.dtype).split(".")[-1]]
