"""The frozen work formulas and the model-FLOP count against hand counts at
small shapes."""

from __future__ import annotations

import json

import pytest

from perfbench.lib import readers
from perfbench.lib import yardstick as ys
from perfbench.lib.manifest import ROOT
from perfbench.ref import lm


def test_flash_forward_and_gradient_by_hand():
    # 4 queries, 4 keys, causal: 1 + 2 + 3 + 4 = 10 live pairs
    assert ys.live_pairs(4, 4, True, 0) == 10
    assert ys.live_pairs(4, 4, False, 0) == 16
    assert ys.live_pairs(4, 4, True, 2) == 7      # window 2: 1 + 2 + 2 + 2
    assert ys.live_pairs(2, 4, True, 0, q_offset=2) == 3 + 4
    flops, nbytes = ys.flash_work(1, 2, 1, 4, 4, 8, 2, 2)
    assert flops == 4 * 8 * 2 * 10
    assert nbytes == 2 * 2 * 4 * 8 * 2 + 2 * 1 * 4 * 8 * 2
    flops, nbytes = ys.flash_bwd_work(1, 2, 1, 4, 4, 8, 2, 2)
    assert flops == 10 * 8 * 2 * 10
    assert nbytes == 4 * 2 * 4 * 8 * 2 + 4 * 1 * 4 * 8 * 2


def test_wkv6_forward_and_gradient_by_hand():
    B, H, T, K, e = 2, 3, 5, 4, 2
    n = B * H * T * K
    assert ys.wkv6_work(B, H, T, K, e) == (
        2 * 2 * B * H * T * K * K,
        n * e * 4 + n * 4 + H * K * 4 + 2 * B * H * K * K * 4)
    assert ys.wkv6_bwd_work(B, H, T, K, e) == (
        6 * 2 * B * H * T * K * K,
        7 * n * e + 2 * n * 4 + 2 * H * K * 4 + 3 * B * H * K * K * 4)


def test_bound_takes_the_larger_term():
    assert ys.bound_s(989e12, 0, ys.PEAK_FLOPS) == pytest.approx(1.0)
    assert ys.bound_s(0, 3.35e12, ys.PEAK_FLOPS) == pytest.approx(1.0)
    assert ys.bound_s(989e12, 2 * 3.35e12, ys.PEAK_FLOPS) == pytest.approx(2)


def _config(name):
    return json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                      .read_text())


def test_model_flops_count_matmul_weights_once():
    c = _config("smollm-360m")
    d, f, H, KV, hd, V, L = 960, 2560, 15, 5, 64, 49152, 32
    per_layer = d * H * hd + 2 * d * KV * hd + H * hd * d + 3 * d * f
    assert ys.matmul_weights(lm.leaves(c)) == L * per_layer + V * d
    c = _config("rwkv6-3b")
    d, f, V, L = 2560, 8960, 65536, 32
    per_layer = 6 * d * d + 2 * d * f + 5 * 2 * d * 32 + 2 * d * 64
    assert ys.matmul_weights(lm.leaves(c)) == L * per_layer + d * V


def test_mixing_and_train_flops_by_hand():
    attn = [{"kind": "attention", "heads": 2, "head_dim": 8}]
    # prefill of 4 tokens: 10 live pairs; a decode token at position 4: 5
    assert ys.mixing_flops(attn, range(0, 4)) == 4 * 8 * 2 * 10
    assert ys.mixing_flops(attn, range(4, 5)) == 4 * 8 * 2 * 5
    wkv = [{"kind": "wkv", "heads": 2, "head_dim": 8}]
    assert ys.mixing_flops(wkv, range(0, 3)) == 4 * 2 * 64 * 3
    leaves = [("w", (3, 5), "mm", 0, 1), ("e", (7, 3), "emb", 0, 1),
              ("s", (3,), "vec", 1, 0), ("h", (3, 7), "head", 0, 1)]
    assert ys.forward_flops(leaves, attn, 2, range(0, 4)) == 2 * (
        2 * 36 * 4 + 4 * 8 * 2 * 10)
    assert ys.train_flops(leaves, attn, 2, 4) == 3 * ys.forward_flops(
        leaves, attn, 2, range(0, 4))


def test_serve_flops_apply_the_head_at_the_prompts_last_position():
    attn = [{"kind": "attention", "heads": 2, "head_dim": 8}]
    leaves = [("w", (3, 5), "mm", 0, 1), ("h", (3, 7), "head", 0, 1)]
    # 2 rows: a prefill of 4 tokens (the head once), then 2 decode steps
    prefill = 2 * (2 * 15 * 4 + 2 * 21 + 4 * 8 * 2 * 10)
    decode = 2 * (2 * 36 + 4 * 8 * 2 * 5) + 2 * (2 * 36 + 4 * 8 * 2 * 6)
    assert ys.serve_flops(leaves, attn, 2, 4, 3) == prefill + decode


def test_readers_read_nothing_where_there_is_nothing():
    assert readers.mfu({"model_flops": 0, "window_s": 1.0}) is None
    assert readers.mfu({"model_flops": 989e12, "window_s": 2.0}) == \
        pytest.approx(50.0)
    assert readers.roofline({"trace": {"entries": {}}}, ("wkv6",)) is None
    rec = {"trace": {"entries": {"wkv6": [(2.0, 1.0)], "flash": [(1.0, 1.0)]}}}
    assert readers.roofline(rec, ("wkv6",)) == pytest.approx(50.0)
    rec = {"trace": {"ops": {"void bfloat16_copy_kernel": 1.0,
                             "nvjet_tst_gemm": 3.0}}}
    assert readers.kind_share(rec, "casts and copies") == pytest.approx(25.0)
    assert readers.span_ms({"spans": {"prefill": [0.5, 1.5]}},
                           "prefill") == pytest.approx(1000.0)
    assert readers.idle({"trace": {"busy_s": 3.0, "window_s": 4.0}}) == \
        pytest.approx(25.0)
