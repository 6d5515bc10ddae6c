"""Blocked online-softmax (flash) attention forward.

``flash_attention_bhsd`` takes the plain version (``attention_ref``) for CPU
tensors and launches the CUDA kernel (``csrc/flash_attention.cu``) for CUDA
tensors. Contract, shared by both: q (B,H,Sq,hd), k/v (B,KV,Sk,hd) with GQA
kv head = h // (H // KV); scale 1/sqrt(hd); optional causal mask, local
``window`` and tanh ``softcap``; ``seq_q``/``seq_k`` (default Sq/Sk) mask
rows and columns past the real lengths; a q row with no live key writes
zeros. Unlike the TPU kernel, no input needs padding to a block multiple:
the CUDA kernel masks its ragged edge itself.
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels import _cuda

NEG_INF = -0.7 * float(torch.finfo(torch.float32).max)
HEAD_DIMS = (16, 32, 64, 128, 256)   # the kernel's compiled head dims


def attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                  seq_q=None, seq_k=None):
    """Plain version of ``flash_attention_bhsd``: one masked fp32 softmax
    over the whole score matrix."""
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    seq_q = Sq if seq_q is None else seq_q
    seq_k = Sk if seq_k is None else seq_k
    kf = k.float().repeat_interleave(H // KV, dim=1)
    vf = v.float().repeat_interleave(H // KV, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * (1.0 / math.sqrt(hd))
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    rows = torch.arange(Sq, device=q.device)[:, None]
    cols = torch.arange(Sk, device=q.device)[None, :]
    mask = (rows < seq_q) & (cols < seq_k)
    if causal:
        mask &= cols <= rows
    if window > 0:
        mask &= cols > rows - window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)) * mask
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    return (torch.einsum("bhqk,bhkd->bhqd", p, vf) / l).to(q.dtype)


def flash_attention_bhsd(q, k, v, *, causal=True, window=0, softcap=0.0,
                         seq_q=None, seq_k=None):
    """q (B,H,Sq,hd); k/v (B,KV,Sk,hd). Returns (B,H,Sq,hd) in q's dtype."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             softcap=softcap, seq_q=seq_q, seq_k=seq_k)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bhsd: no kernel for {q.device}")
    return _launch(q, k, v, causal, window, softcap, seq_q, seq_k)


def _launch(q, k, v, causal, window, softcap, seq_q, seq_k):
    name = "flash_attention_bhsd"
    fdt = (torch.float32, torch.bfloat16)
    dev = _cuda.check_cuda_tensors(name, (q, k, v),
                                   (fdt, (q.dtype,), (q.dtype,)))
    B, H, Sq, hd = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    seq_q = Sq if seq_q is None else int(seq_q)
    seq_k = Sk if seq_k is None else int(seq_k)
    if (hd not in HEAD_DIMS or k.shape != (B, KV, Sk, hd)
            or v.shape != k.shape or KV == 0 or H % KV
            or not 0 <= seq_q <= Sq or not 0 <= seq_k <= Sk
            or B > 65535 or H > 65535):
        raise ValueError(
            f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, seq_q {seq_q}, seq_k {seq_k} (head dim must "
            f"be one of {HEAD_DIMS})")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    err = _cuda.lib().repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        B, H, KV, Sq, Sk, hd, seq_q, seq_k, int(bool(causal)), int(window),
        float(softcap), _cuda.DTYPE_CODES[q.dtype],
        *_cuda.device_and_stream(dev))
    _cuda.check_launch(name, err)
    return out
