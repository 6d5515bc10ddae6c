"""The benchmark's frozen arithmetic: the H100's peaks, the kernels' work
formulas and the model-FLOP count.

The peaks and the four kernel formulas are copies of the port's
``repro_torch/distributed/roofline.py`` and ``distributed/cost.py`` as they
stood when this benchmark was defined; they live here so that a change to the
program cannot change the yardstick it is measured with. The model-FLOP count
is the benchmark's own: the matmul weights of the plain reference (the head
once, tied or not; the embedding lookup not at all) and the sequence mixing's
products (causal attention's scores and values, WKV's state), with no
rematerialized recompute.
"""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM data sheet, dense, at the 700 W power limit
PEAK_FLOPS = 989e12            # bf16 / fp16 FLOP/s on the tensor cores
HBM_BW = 3.35e12               # bytes/s of the 80 GB of HBM3
PEAK_FLOPS_TF32 = 495e12       # TF32 FLOP/s on the tensor cores
# fp32 work taken as three TF32 products on the tensor cores
PEAK_FLOPS_SPLIT_TF32 = PEAK_FLOPS_TF32 / 3
PEAK_FLOPS_BY_DTYPE = {"bfloat16": PEAK_FLOPS, "float16": PEAK_FLOPS,
                       "float32": 67e12}       # fp32 outside the tensor cores


def bound_s(flops, nbytes, peak):
    """The least time the chip could take for the work: the larger of the
    operations over ``peak`` and the bytes over the HBM rate."""
    return max(flops / peak, nbytes / HBM_BW)


def _live_ranges(Sq, Sk, causal, window, q_offset=0):
    r = np.arange(Sq, dtype=np.int64) + q_offset
    lo = np.maximum(0, r - window + 1) if window > 0 else np.zeros_like(r)
    hi = np.minimum(r, Sk - 1) if causal else np.full_like(r, Sk - 1)
    return lo, hi


def live_pairs(Sq, Sk, causal, window, q_offset=0):
    """(q, k) pairs a mask leaves live, query r at position r + q_offset."""
    lo, hi = _live_ranges(Sq, Sk, causal, window, q_offset)
    return int(np.maximum(0, hi - lo + 1).sum())


def live_keys(Sq, Sk, causal, window, q_offset=0):
    """Keys from the first that some query reads to the last."""
    lo, hi = _live_ranges(Sq, Sk, causal, window, q_offset)
    live = hi >= lo
    return int(hi[live].max() - lo[live].min() + 1) if live.any() else 0


def flash_work(B, H, KV, Sq, Sk, hd, q_elem, kv_elem, causal=True,
               window=0, q_offset=0):
    """(flops, bytes) of attention: 4·hd a live pair; q read and the output
    written, K and V read once over the keys some query reads."""
    flops = 4 * hd * B * H * live_pairs(Sq, Sk, causal, window, q_offset)
    keys = live_keys(Sq, Sk, causal, window, q_offset)
    return flops, (2 * B * H * Sq * hd * q_elem
                   + 2 * B * KV * keys * hd * kv_elem)


def flash_bwd_work(B, H, KV, Sq, Sk, hd, q_elem, kv_elem, causal=True,
                   window=0, q_offset=0):
    """(flops, bytes) of attention's gradient: 10·hd a live pair; q, o, do
    read and dq written, K, V read and dK, dV written once."""
    flops = 10 * hd * B * H * live_pairs(Sq, Sk, causal, window, q_offset)
    keys = live_keys(Sq, Sk, causal, window, q_offset)
    return flops, (4 * B * H * Sq * hd * q_elem
                   + 4 * B * KV * keys * hd * kv_elem)


def wkv6_work(B, H, T, K, elem):
    """(flops, bytes) of one WKV6 call: two fp32 multiply-adds a state
    element a token; r/k/v read and y written in the compute dtype, logw
    read in fp32, u read, s0 read and s_T written in fp32."""
    n = B * H * T * K
    return (4 * B * H * T * K * K,
            4 * n * elem + 4 * n + 4 * H * K + 2 * 4 * B * H * K * K)


def wkv6_bwd_work(B, H, T, K, elem):
    """(flops, bytes) of one WKV6 gradient call: six fp32 multiply-adds a
    state element a token; r/k/v/dy read and dr/dk/dv written in the compute
    dtype, logw read and dlogw written in fp32, u read and du written, s0
    and dS read and ds0 written in fp32."""
    n = B * H * T * K
    return (12 * B * H * T * K * K,
            7 * n * elem + 2 * 4 * n + 2 * 4 * H * K + 3 * 4 * B * H * K * K)


# ---------------------------------------------------------------------------
# model FLOPs
# ---------------------------------------------------------------------------


def matmul_weights(leaves, kinds=("mm", "head")):
    """Elements of the leaves used as matmul weights (``kind`` ``"mm"`` or
    ``"head"`` in the reference's leaf list: the head once, tied or not)."""
    return sum(int(np.prod(shape)) for _, shape, kind, *_ in leaves
               if kind in kinds)


def mixing_flops(mixers, positions):
    """Forward FLOPs of the sequence mixing for one row whose tokens sit at
    ``positions`` (a range of absolute positions, the earlier ones cached):
    causal attention 4·hd·H a live pair, WKV 4·H·K·K a token."""
    lo, hi = positions.start, positions.stop
    total = 0
    for m in mixers:
        if m["kind"] == "attention":
            # queries lo..hi-1 over keys 0..q (causal), window 0
            n = hi - lo
            pairs = n * lo + n * (n + 1) // 2
            total += 4 * m["head_dim"] * m["heads"] * pairs
        elif m["kind"] == "wkv":
            total += 4 * m["heads"] * m["head_dim"] ** 2 * (hi - lo)
        else:
            raise ValueError(f"unknown mixer {m['kind']!r}")
    return total


def forward_flops(leaves, mixers, rows, positions):
    """Model FLOPs of a forward over ``rows`` rows of tokens at
    ``positions``: 2 a matmul weight a token, plus the mixing."""
    n = positions.stop - positions.start
    return rows * (2 * matmul_weights(leaves) * n
                   + mixing_flops(mixers, positions))


def serve_flops(leaves, mixers, rows, prompt_len, gen):
    """Model FLOPs of serving ``rows`` prompts of ``prompt_len`` tokens and
    ``gen`` tokens each: a prefill over the prompt that applies the head at
    its last position only, then ``gen - 1`` decode steps of one token."""
    prefill = forward_flops(leaves, mixers, rows, range(0, prompt_len)) \
        - rows * 2 * matmul_weights(leaves, ("head",)) * (prompt_len - 1)
    return prefill + sum(
        forward_flops(leaves, mixers, rows, range(p, p + 1))
        for p in range(prompt_len, prompt_len + gen - 1))


def train_flops(leaves, mixers, rows, seq):
    """Model FLOPs of one training step: the forward and twice it for the
    backward, without any recompute."""
    return 3 * forward_flops(leaves, mixers, rows, range(0, seq))
