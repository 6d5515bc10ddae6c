"""Tiny copies of the benchmark's configurations and mixes for CPU tests:
the port's reduced sizes (``configs/*.py`` ``reduced()``), the cell's
structure otherwise as it is."""

from __future__ import annotations

import copy

RWKV = {"hidden_size": 64, "attention_hidden_size": 64, "head_size": 16,
        "intermediate_size": 128, "vocab_size": 256, "num_hidden_layers": 2,
        "time_mix_extra_dim": 32, "time_decay_extra_dim": 64}
LLAMA = {"hidden_size": 60, "intermediate_size": 128,
         "num_attention_heads": 3, "num_key_value_heads": 1, "head_dim": 20,
         "vocab_size": 256, "num_hidden_layers": 2}
MIXES = {"train": {"rows": 2, "seq": 16, "trace_steps": 1},
         "serve": {"clients": 2, "prompt_len": 8, "gen": 3,
                   "check_requests": 2, "check_per_round": 2,
                   "check_rows": 2}}


def config(c, compute="bfloat16"):
    """``c`` at tiny sizes; the port's config replaced to match."""
    c = copy.deepcopy(c)
    sizes = RWKV if c["layer_type"] == "rwkv6" else LLAMA
    c.update(sizes, compute_dtype=compute)
    rep = {"n_layers": c["num_hidden_layers"], "d_model": c["hidden_size"],
           "d_ff": c["intermediate_size"], "vocab_size": c["vocab_size"],
           "compute_dtype": compute, "remat": "full", "ce_chunks": 2}
    if c["layer_type"] == "rwkv6":
        K = c["head_size"]
        rep.update(n_heads=c["hidden_size"] // K,
                   n_kv_heads=c["hidden_size"] // K, head_dim=K,
                   rwkv_head_dim=K, fsdp=False,
                   segments=[[["rwkv"], c["num_hidden_layers"]]])
    else:
        rep.update(n_heads=c["num_attention_heads"],
                   n_kv_heads=c["num_key_value_heads"],
                   head_dim=c["head_dim"], segments=[])
    c["port"] = dict(c["port"], replace=rep)
    return c


def mix(m):
    m = copy.deepcopy(m)
    m.update(MIXES[m["loop"]])
    return m
