"""Attention's gradient: ``repro_torch.kernels.flash_attention.
FlashAttention.backward`` (saved q, k, v in (B,H,S,hd)). Its work is the
frozen ``flash_bwd_work``; bf16 at the tensor cores' bf16 peak, fp32 at the
rate of three TF32 products."""

import torch

from perfbench.lib import yardstick as ys

TARGET = ("repro_torch.kernels.flash_attention", "FlashAttention.backward")


def work(ctx, g):
    q, k = ctx.saved_tensors[:2]
    B, H, Sq, hd = q.shape
    KV, T = k.shape[1], k.shape[2]
    a = ctx.args
    flops, nbytes = ys.flash_bwd_work(
        B, H, KV, Sq, T if a["seq_k"] is None else a["seq_k"], hd,
        q.element_size(), k.element_size(), a["causal"], a["window"],
        a["q_offset"])
    peak = ys.PEAK_FLOPS if q.dtype == torch.bfloat16 \
        else ys.PEAK_FLOPS_SPLIT_TF32
    return flops, nbytes, peak
