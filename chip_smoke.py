#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and exits non-zero:

1. Device and build: the card's name and power limit from ``nvidia-smi``,
   then the CUDA kernels built from ``src/repro_torch/kernels/csrc``.
2. Kernel parity: each kernel against its plain PyTorch version on the
   card, at the shapes the main path gives it and at edge cases, then the
   kernel's, the plain version's and (for flash) ``scaled_dot_product_
   attention``'s device time at the main path's shapes (calls captured in
   a CUDA graph and replayed), beside the wall time of back-to-back
   eager calls. Paged decode is also held at rows of length 0, 1, 7, 8, 9
   and the full capacity behind a NaN trash page, at head dims 16-256,
   groups of 1-20 and 1, 2 and 5 key ranges forced, and timed at 24 slots
   x 43 tokens (one range and two, forced) and at a design length, 256
   slots x 320 tokens with its pools past the L2 cache; beside them the
   launch floor, the device time of a 1-element ``add_``.
3. Small-input agreement: the reduced payload on the card (kernels) and on
   the CPU (plain versions), same seed and noise, in fp32: the same
   sampled tokens, log-likelihoods, scores and accepted designs, through
   the paged design loop and through the dense ``generate`` and
   ``generate_batch``.
4. Main path: ``ProteinPayload`` at the full width of progen-s and
   foldscore-s runs 2 IMPRESS design cycles for 4 pipelines, playing the
   executor's and protocol's part: a fused paged ``generate_batch``, the
   ranking by log-likelihood, a masked ``predict_batch`` on each
   pipeline's top 3 with the peptide appended, and ``fitness`` to accept
   or decline. The kernels' launch counters are zeroed just before and
   read just after: the paged kernel must have run once per layer per
   decode step, the flash kernel once per layer per prompt prefill and
   per ``predict_batch``.
5. Where the time goes: one more design cycle under ``torch.profiler``,
   device time by kernel and the device's busy share; paged decode must
   be one device kernel a layer a decode step, with no combine.
5b. The paper's main path: an im-rp campaign (4 structures, the session's
   defaults, 2 cycles) through the port's ``Coordinator``,
   ``AsyncExecutor`` (2 workers), ``DeviceAllocator`` of the card and
   ``ProteinPayload`` at full width, once in the default form (dense
   ``generate``, solo ``predict``) and once batched (paged
   ``generate_batch`` with live admission, ``predict_batch``). No task may
   fail or retry; the counters, zeroed just before each campaign and read
   just after, must equal what its completed tasks imply, by kernel and
   flash form. Prints the makespan, tasks by kind, occupancy, designs
   accepted by cycle and first calls per shape key, then profiles one
   cycle of each form.
6. The LM serving path at full width: ``serve_batch`` on rwkv6-7b (32
   layers, d 4096, bf16 compute, seeded weights drawn on the card), one
   prefill of 8 x 512 tokens and 31 greedy decode steps through the
   RWKV-6 state. The counters are zeroed just before and read just after:
   the wkv6 kernels must have run once per layer per prefill (the prefill
   kernel) and per decode step (the decode kernel), the attention kernels
   not at all. Then a full-width fp32 check
   that the T=1 decode path agrees with one prefill over the same tokens,
   and one decode step under ``torch.profiler``.
7. recurrentgemma-2b serving at full width: ``serve_batch`` (26 layers,
   18 RG-LRU and 8 local-attention, d 2560, seeded weights drawn on the
   card), one prefill of 8 x 2560 tokens (past the 2048 window, so the
   window mask, the ring's rotation and its wrap at decode all run) and 31
   greedy decode steps. The counters must show the rglru kernel once per
   RG-LRU layer and the flash kernel once per local-attention layer, per
   prefill (its fp32 sequence form) and per decode step (its decode form,
   over the bf16 ring in place), and the other two kernels not at all.
   Then the full-width fp32 per-layer check over a prompt past the window,
   and one decode step over a full ring under ``torch.profiler``.
8. One ``{"kernels": [...]}`` JSON line, the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Phase 2 holds the flash kernel's bf16 sequence form (``mma.sync``) against
both the plain version and the tiled algebra it repeats
(``attention_tiled_ref``) and times it at three protein shapes beside
sdpa. It also holds the wkv6 kernels (2b: prefill and decode, the prefill
one also against ``wkv6_serial_ref``), the rglru kernel and the flash
kernel at head dim 256 (2c) against their plain versions and times them;
2c also holds the flash kernel's decode form (one query over strided ring
views, bf16 K/V beside an fp32 q, every head dim, groups of 1 to 20 query
heads) and its fp32 sequence form (every head dim, ragged lengths, window,
softcap, no mask), and times both at recurrentgemma-2b's shapes. 2d holds
the decode form at the dense sampler's shape (6 rows x 8/4 heads of 32,
bf16, strided views of an 89-slot cache) at 1, 2 and the automatic number
of key ranges, and times it beside sdpa. Phase 3 also holds the reduced
rwkv6 (3b) and recurrentgemma (3c) models on the card against the CPU.

Imports neither jax nor the reference package. Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import collections
import gc
import itertools
import json
import re
import subprocess
import sys
import time
from importlib import metadata
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12                        # H100 SXM device memory
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}   # H100 SXM, dense
TOL = {"float32": 2e-5, "bfloat16": 2e-2}        # flash, as the CPU tests
PAGED_TOL = {"float32": 1e-5, "bfloat16": 2e-2}
WKV_STATE_TOL = {"atol": 1e-4, "rtol": 1e-3}       # test_kernels.py's own
# rwkv6-7b serving (phase 6): batch x prompt tokens, tokens generated
SERVE_BATCH, SERVE_PROMPT, SERVE_GEN = 8, 512, 32
# recurrentgemma-2b serving (phase 7): a prompt past the 2048 window, not a
# multiple of it
RG_BATCH, RG_PROMPT, RG_GEN = 8, 2560, 32
RGLRU_TOL = 1e-5                                 # test_kernels.py's own
# the port's kernels, as the profiler names them
PORT_KERNELS = ("decode_attention_", "flash_fwd_", "wkv6_",
                "rglru_kernel")
# session defaults (repro/session.py): receptor 24 + peptide 6, 6 candidates
RECEPTOR, PEPTIDE, N_CAND, TOP_K = 24, 6, 6, 3
# the campaign phase (5b): the session's im-rp defaults, two cycles, in the
# default form (dense generate, solo predict) and the batched form
CAMPAIGN_FORMS = {"default": {},
                  "batched": {"generate_batch_size": 4, "score_batch": 3,
                              "decode_kernel": True}}
CAMPAIGN_CYCLES = 2


def expect(cond, msg):
    if not cond:
        raise AssertionError(msg)


def check(label, err, tol):
    print(f"  {label}: max_abs_err {err:.3e} (tol {tol:.0e})", flush=True)
    expect(err <= tol, f"{label}: max_abs_err {err} > {tol}")


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", "0"], capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def wall_ms(torch, fn, iters=200, warmup=20):
    """Mean time per call of ``fn`` over ``iters`` back-to-back calls,
    between CUDA events: for launches this small, the host's launch rate."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def kernel_events(prof):
    return [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")]


def graph_ms(torch, fn, iters=20, replays=10):
    """Device time of one call of ``fn``: ``iters`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's launch gaps are not in the time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound_ms(n_bytes, n_ops, dtype):
    """The least time for the work: bytes over the memory rate or operations
    over the peak rate for their type, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / PEAK_OPS[dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def max_err(got, want):
    return float((got.float() - want.float()).abs().max())


def check_close(label, got, want, atol, rtol):
    """``|got - want| <= atol + rtol |want|`` everywhere (numpy's
    ``assert_allclose``, as the CPU tests hold it); returns the max abs
    error."""
    got, want = got.float(), want.float()
    excess = float(((got - want).abs() - rtol * want.abs()).max())
    err = max_err(got, want)
    print(f"  {label}: max_abs_err {err:.3e} (atol {atol:.0e}, rtol "
          f"{rtol:.0e})", flush=True)
    expect(excess <= atol, f"{label}: error exceeds atol {atol} + rtol "
           f"{rtol} |want| by {excess - atol}")
    return err


def dtype_name(dt):
    return str(dt).split(".")[1]


def paged_inputs(torch, rng, lengths, dtype, *, KV=4, G=2, hd=32, page=8,
                 maxp=11, trash=float("nan")):
    """Paged decode inputs on the card, one row a length, at progen-s'
    heads and its 24-slot engine's 11 pages of 8 by default: every row's
    live pages drawn from a scrambled pool, every page past its length the
    trash page (the pool's last), which holds ``trash``: NaN by default,
    so that a key read past a row's length shows as NaN."""
    import numpy as np
    B = len(lengths)
    P = B * maxp + 1
    mk = lambda *s: rng.normal(size=s).astype(np.float32)
    q, kp, vp = mk(B, KV, G, hd), mk(P, KV, page, hd), mk(P, KV, page, hd)
    kp[P - 1] = vp[P - 1] = trash
    order = rng.permutation(P - 1)
    bt = np.full((B, maxp), P - 1, np.int32)
    for b, n in enumerate(lengths):
        live = -(-int(n) // page)
        bt[b, :live] = order[b * maxp:b * maxp + live]
    t = lambda a, dt=None: torch.from_numpy(a).to("cuda", dt)
    return (t(q, dtype), t(kp, dtype), t(vp, dtype), t(bt),
            t(np.asarray(lengths, np.int32)), page)


def paged_parity(torch, rng):
    """The paged kernel against its plain version: random lengths at the
    protein engine's shapes (24 and 32 slots), then rows of length 0, 1,
    7, 8, 9, the full capacity, 40 and 65 behind a NaN trash page at every
    head dim and groups of 1 to 20, at the wrapper's range count and
    forced to 1, 2 and 5 ranges (5: more ranges than a row has tiles), and
    a batch with no active row."""
    from repro_torch.kernels import paged_attention as pa

    for B in (24, 32):
        for dt in (torch.float32, torch.bfloat16):
            lengths = rng.integers(0, 11 * 8 + 1, size=B)
            lengths[::5] = 0
            q, kp, vp, bt, lens, page = paged_inputs(torch, rng, lengths, dt)
            got = pa.paged_decode_bkgh(q, kp, vp, bt, lens, page_size=page)
            want = pa.paged_decode_ref(q, kp, vp, bt, lens, page_size=page)
            torch.cuda.synchronize()
            check(f"paged_decode B={B} {dtype_name(dt)}", max_err(got, want),
                  PAGED_TOL[dtype_name(dt)])
            expect(bool((got[lens == 0] == 0).all()),
                   "paged_decode: inactive rows are not exactly zero")
    lengths = (0, 1, 7, 8, 9, 72, 40, 65)
    for G, hd in ((1, 16), (2, 16), (4, 16), (1, 32), (2, 32), (4, 32),
                  (2, 64), (8, 128), (20, 256)):
        for dt in (torch.float32, torch.bfloat16):
            q, kp, vp, bt, lens, page = paged_inputs(
                torch, rng, lengths, dt, KV=2, G=G, hd=hd, maxp=9)
            want = pa.paged_decode_ref(q, kp, vp, bt, lens, page_size=page)
            worst = 0.0
            for n_split in (None, 1, 2, 5):
                got = pa.paged_decode_bkgh(
                    q, kp, vp, bt, lens, page_size=page) if n_split is None \
                    else pa._launch(q, kp, vp, bt, lens, page, n_split)
                torch.cuda.synchronize()
                expect(bool(torch.isfinite(got).all()),
                       "paged_decode read a key past a row's length")
                expect(bool((got[lens == 0] == 0).all()),
                       "paged_decode: inactive rows are not exactly zero")
                worst = max(worst, max_err(got, want))
            check(f"paged_decode edges G={G} hd {hd} {dtype_name(dt)}, "
                  f"lengths {lengths}, NaN trash page, 1/1/2/5 ranges",
                  worst, PAGED_TOL[dtype_name(dt)])
    q, kp, vp, bt, lens, page = paged_inputs(torch, rng, (0,) * 24,
                                             torch.bfloat16)
    for n_split in (1, 3):
        got = pa._launch(q, kp, vp, bt, lens, page, n_split)
        expect(bool((got == 0).all()), "paged_decode: no active row, "
               f"{n_split} ranges: not exactly zero")
    print("  paged_decode with no active row: exact zeros at 1 and 3 ranges",
          flush=True)


def time_paged(torch, pa, rng, B, n_tok, maxp, n_split=None, cold=False):
    """Device time of paged decode at progen-s' heads in bf16: ``B`` slots
    of ``n_tok`` cached tokens each, ``maxp`` pages of 8 a row; the kernel
    at ``n_split`` ranges (None: the wrapper's choice), the plain version,
    and the bound. With ``cold`` the calls rotate over input sets past 100
    MB, twice the L2 cache, as a model's layers would find their pools.
    ``pa`` is the module of the tree under test, so older trees can be
    timed alike: the trash page holds zeros, since a plain version that
    weighs a dead key's value by 0 turns a NaN there into NaN. Returns a
    dict of the numbers."""
    import numpy as np
    KV, G, hd = 4, 2, 32
    live = B * n_tok
    n_bytes = (2 * B * KV * G * hd + 2 * live * KV * hd) * 2 \
        + (B * maxp + B) * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * hd * G * KV * live, "bfloat16")
    sets = [paged_inputs(torch, rng, np.full(B, n_tok), torch.bfloat16,
                         maxp=maxp, trash=0.0)
            for _ in range(-(-100_000_000 // n_bytes) if cold else 1)]
    if n_split is None:
        kernel = lambda q, kp, vp, bt, lens, page: pa.paged_decode_bkgh(
            q, kp, vp, bt, lens, page_size=page)
    else:
        kernel = lambda q, kp, vp, bt, lens, page: pa._launch(
            q, kp, vp, bt, lens, page, n_split)
    q, kp, vp, bt, lens, page = sets[0]
    err = max_err(kernel(*sets[0]),
                  pa.paged_decode_ref(q, kp, vp, bt, lens, page_size=page))
    turn = itertools.cycle(sets)
    run_k = lambda: kernel(*next(turn))

    def run_p():
        q, kp, vp, bt, lens, page = next(turn)
        return pa.paged_decode_ref(q, kp, vp, bt, lens, page_size=page)
    reps = dict(iters=4, replays=3) if cold else {}
    out = {"ms": graph_ms(torch, run_k), "plain_ms": graph_ms(
        torch, run_p, **reps), "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err, "wall_ms": wall_ms(torch, run_k),
        "bytes": n_bytes}
    del sets, turn
    return out


def launch_floor_ms(torch):
    """Device time of the smallest launch that reads and writes device
    memory: a 1-element ``add_`` under the same CUDA-graph replay as the
    kernels' times."""
    x = torch.zeros(1, device="cuda")
    return graph_ms(torch, lambda: x.add_(1.0))


def phase_kernels(torch):
    """Parity of both kernels against their plain versions, then timings at
    the main path's shapes. Returns the kernel records for the JSON line."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(0)
    print("phase 2: kernel parity on the card", flush=True)
    paged_parity(torch, rng)

    flash_cases = [  # label, (B, H, KV, S, hd), kwargs
        ("foldscore S=32", (4, 8, 8, 32, 32), {}),
        ("foldscore S=64", (4, 8, 8, 64, 32), {}),
        ("progen prefill GQA S=31", (1, 8, 4, 31, 32), {}),
        ("progen prefill GQA S=65", (1, 8, 4, 65, 32), {}),
        ("window 24", (2, 8, 8, 64, 32), {"window": 24}),
        ("softcap 20", (2, 8, 8, 64, 32), {"softcap": 20.0}),
        ("seq_q=seq_k=37 of 48", (2, 8, 8, 48, 32),
         {"seq_q": 37, "seq_k": 37}),
        ("non-causal", (2, 4, 4, 50, 32), {"causal": False}),
        ("hd 16 GQA", (1, 4, 2, 80, 16), {}),
        ("hd 64", (1, 2, 2, 64, 64), {}),
        ("hd 128 window", (1, 2, 1, 40, 128), {"window": 7}),
        ("hd 256 GQA", (2, 8, 2, 70, 256), {}),
        ("S = 1 + a tile, GQA", (2, 8, 4, 33, 32), {}),
        ("non-causal window 9, seq_k 40 of 64", (2, 4, 2, 64, 32),
         {"causal": False, "window": 9, "seq_k": 40}),
        # the campaign's own shapes (phase 5b): the dense generate's prefill
        # of 6 candidates, the solo predict, and predict_batch at exact
        # length in each row bucket it pads a dispatch to
        ("dense generate prefill 6 x GQA S=31", (6, 8, 4, 31, 32), {}),
        ("solo predict S=30", (1, 8, 8, 30, 32), {}),
        *((f"predict_batch {b} rows S=30", (b, 8, 8, 30, 32), {})
          for b in (2, 4, 8, 16)),
    ]
    for label, (B, H, KV, S, hd), kw in flash_cases:
        # rows with no live key: past seq_q, or past seq_k + window - 1
        # without the causal mask; the kernel writes exact zeros there
        no_key = torch.arange(S, device="cuda") >= kw.get("seq_q", S)
        if kw.get("window", 0) > 0 and not kw.get("causal", True):
            no_key |= torch.arange(S, device="cuda") - kw["window"] + 1 \
                >= kw.get("seq_k", S)
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, S, hd, device="cuda").to(dt)
            k = torch.randn(B, KV, S, hd, device="cuda").to(dt)
            v = torch.randn(B, KV, S, hd, device="cuda").to(dt)
            got = fa.flash_attention_bhsd(q, k, v, **kw)
            want = fa.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            expect(bool((got[:, :, no_key] == 0).all()),
                   "flash: rows without a live key are not exactly zero")
            check(f"flash {label} {dtype_name(dt)}", max_err(got, want),
                  TOL[dtype_name(dt)])
            if dt == torch.bfloat16:   # the mma form's own algebra
                check(f"flash {label} bf16 vs attention_tiled_ref",
                      max_err(got, fa.attention_tiled_ref(q, k, v, **kw)),
                      TOL["bfloat16"])

    # timings at the main path's shapes, in bf16 as the path runs them;
    # paged decode also at a design length (256 slots x 320 tokens: a
    # 64-row backbone + BOS + 255 residues), with its pools past the L2
    print(f"  launch floor (a 1-element add_, CUDA-graph replay): "
          f"{launch_floor_ms(torch):.4f} ms", flush=True)
    smem = fa.decode_smem_bytes
    print(f"  decode body (paged and flash decode): dynamic shared memory a "
          f"block {smem(32, 2)} B at hd 32 bf16, {smem(32, 4)} B fp32, "
          f"{smem(256, 2)} B at hd 256 bf16, {smem(256, 4)} B fp32",
          flush=True)
    records = []
    for name, B, n_tok, maxp, cold in (
            ("paged_decode_bkgh", 24, 43, 11, False),
            ("paged_decode_bkgh_256x320", 256, 320, 40, True)):
        r = time_paged(torch, pa, rng, B, n_tok, maxp, cold=cold)
        n_split = pa.paged_decode_splits(
            B, 4, 2, maxp, 8,
            torch.cuda.get_device_properties(0).multi_processor_count)
        cold_note = ", pools past the L2" if cold else ""
        print(f"  paged_decode at {B} slots x {n_tok} cached tokens bf16 "
              f"({n_split} range a row{cold_note}), device ms per call: "
              f"kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, bound "
              f"{r['bound_ms']:.6f} ({r['bound_by']}, {r['bytes']} B), "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound; wall per "
              f"back-to-back call: kernel {r['wall_ms']:.4f}; err "
              f"{r['max_abs_err']:.3e}", flush=True)
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:120",
            "launches": 0, "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    turns = [(n, time_paged(torch, pa, rng, 24, 43, 11, n_split=n)["ms"])
             for n in (1, 2, 2, 1)]
    print("  paged_decode at 24 slots x 43 tokens bf16, ranges forced (2: "
          "the split kernel and the combine), device ms per call in turns: "
          + ", ".join(f"{n} range{'s' * (n > 1)} {ms:.4f}" for n, ms in turns),
          flush=True)
    dt = torch.bfloat16

    print(f"  flash bf16 sequence form (mma.sync): dynamic shared memory "
          f"a block of {fa.MMA_ROWS} rows {fa.mma_smem_bytes(32)} B at hd 32,"
          f" {fa.mma_smem_bytes(256)} B at hd 256", flush=True)
    for label, (B, H, KV, S, hd) in (
            ("predict_batch 4 rows x 32 tokens", (4, 8, 8, 32, 32)),
            ("prefill 1 row x 31 tokens GQA", (1, 8, 4, 31, 32)),
            ("prefill 1 row x 65 tokens GQA", (1, 8, 4, 65, 32)),
            ("dense generate prefill 6 rows x 31 tokens GQA",
             (6, 8, 4, 31, 32)),
            ("solo predict 1 row x 30 tokens", (1, 8, 8, 30, 32))):
        q = torch.randn(B, H, S, hd, device="cuda", dtype=dt)
        k = torch.randn(B, KV, S, hd, device="cuda", dtype=dt)
        v = torch.randn(B, KV, S, hd, device="cuda", dtype=dt)
        run_k = lambda: fa.flash_attention_bhsd(q, k, v)
        run_p = lambda: fa.attention_ref(q, k, v)
        run_l = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=H != KV)
        err = max_err(run_k(), run_p())
        n_bytes = (2 * q.numel() + k.numel() + v.numel()) * 2
        n_ops = 4 * hd * B * H * S * (S + 1) // 2      # live causal pairs
        b_ms, b_by = bound_ms(n_bytes, n_ops, "bfloat16")
        ms, plain, lib = (graph_ms(torch, run_k), graph_ms(torch, run_p),
                          graph_ms(torch, run_l))
        print(f"  flash {label} bf16, device ms per call: kernel {ms:.4f}, "
              f"plain {plain:.4f}, sdpa {lib:.4f}, bound {b_ms:.6f} "
              f"({b_by}); wall per back-to-back call: kernel "
              f"{wall_ms(torch, run_k):.4f}, sdpa "
              f"{wall_ms(torch, run_l):.4f}; err {err:.3e}", flush=True)
        if len(records) == 2:      # the record holds the predict_batch shape
            records.append({
                "name": "flash_attention_bhsd", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:82",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib})
    return records


def wkv_inputs(torch, g, B, H, T, K, dtype, s0=True, logw_ends=False):
    """wkv6 inputs on the card: r/k/v 0.5 N(0,1) in ``dtype``, logw
    -exp(N(0,1)) in fp32 (or alternating -e^5 and -1e-6, the two ends
    ``rwkv_streams`` clips to), u 0.3 + 0.1 N(0,1), s0 0.1 N(0,1) or zero
    (a fresh prefill's)."""
    import numpy as np
    mk = lambda *s: torch.randn(*s, generator=g, device="cuda")
    r, k, v = ((0.5 * mk(B, H, T, K)).to(dtype) for _ in range(3))
    logw = -torch.exp(mk(B, H, T, K))
    if logw_ends:
        logw[..., ::2] = -float(np.exp(5.0))
        logw[..., 1::2] = -1e-6
    s = 0.1 * mk(B, H, K, K) if s0 else torch.zeros(B, H, K, K,
                                                     device="cuda")
    return r, k, v, logw, 0.3 + 0.1 * mk(H, K), s


def wkv_bound(B, H, T, K, elem):
    """(bound ms, what bounds it, bytes) of one wkv6 call. Bytes: r/k/v
    read and y written in the compute dtype, logw read in fp32, u read, s0
    read and s_T written in fp32. Operations: two fp32 multiply-adds per
    state element per token (the output and the state update)."""
    n = B * H * T * K
    n_bytes = 4 * n * elem + 4 * n + 4 * H * K + 2 * 4 * B * H * K * K
    return (*bound_ms(n_bytes, 4 * B * H * T * K * K, "float32"), n_bytes)


def phase_wkv6(torch):
    """Parity of the wkv6 kernels (prefill, T > 1, and decode, T = 1)
    against the plain version on the card, the prefill kernel also against
    its own algebra (``wkv6_serial_ref``) where T is short, then their and
    the plain version's device time at the serving path's prefill and
    decode shapes. Returns the two forms' JSON records."""
    from repro_torch.kernels import rwkv6

    print("phase 2b: wkv6 parity on the card", flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, H, K = SERVE_BATCH, 64, 64
    cases = [  # label, (B, H, T, K), kwargs
        ("prefill 8x64x512x64, s0 = 0", (B, H, SERVE_PROMPT, K),
         {"s0": False}),
        ("decode 8x64x1x64", (B, H, 1, K), {}),
        ("ragged T=33", (2, 8, 33, K), {}),
        ("prime T=31", (2, 8, 31, K), {}),
        ("reduced K=16, T=70", (2, 4, 70, 16), {}),
        ("nonzero s0, T=100", (4, 16, 100, K), {}),
        ("logw at -e^5 and -1e-6, T=40", (2, 8, 40, K), {"logw_ends": True}),
        ("T=2", (2, 8, 2, K), {}),
        ("reduced K=16, logw at the ends, T=33", (2, 4, 33, 16),
         {"logw_ends": True}),
    ]
    for label, shape, kw in cases:
        for dt in (torch.float32, torch.bfloat16):
            args = wkv_inputs(torch, g, *shape, dt, **kw)
            y, s = rwkv6.wkv6_bhtk(*args)
            y_ref, s_ref = rwkv6.wkv6_ref(*args)
            torch.cuda.synchronize()
            expect(y.dtype == dt and s.dtype == torch.float32,
                   f"wkv6 dtypes {y.dtype} {s.dtype}")
            name = dtype_name(dt)
            check_close(f"wkv6 {label} {name} y", y, y_ref, TOL[name],
                        TOL[name])
            check_close(f"wkv6 {label} {name} s_T", s, s_ref,
                        **WKV_STATE_TOL)
            if 1 < shape[2] <= 100:
                y_ser, s_ser = rwkv6.wkv6_serial_ref(*args)
                check_close(f"wkv6 {label} {name} y vs wkv6_serial_ref", y,
                            y_ser, TOL[name], TOL[name])
                check_close(f"wkv6 {label} {name} s_T vs wkv6_serial_ref", s,
                            s_ser, **WKV_STATE_TOL)

    # timings at the serving path's shapes, in bf16 as the path runs them.
    # Calls rotate over enough input sets to fill twice the 50 MB L2, as
    # the path's calls find their state cold (a layer's weights pass
    # through L2 between two calls).
    dt, records = torch.bfloat16, []
    for label, T in (("prefill", SERVE_PROMPT), ("decode", 1)):
        b_ms, b_by, n_bytes = wkv_bound(B, H, T, K, 2)
        sets = [wkv_inputs(torch, g, B, H, T, K, dt, s0=T == 1)
                for _ in range(-(-100_000_000 // n_bytes))]
        err = max_err(rwkv6.wkv6_bhtk(*sets[0])[0],
                      rwkv6.wkv6_ref(*sets[0])[0])
        turn = itertools.cycle(sets)
        run_k = lambda: rwkv6.wkv6_bhtk(*next(turn))
        run_p = lambda: rwkv6.wkv6_ref(*next(turn))
        ms = graph_ms(torch, run_k)
        plain = graph_ms(torch, run_p, iters=4, replays=3)
        print(f"  wkv6 {label} {B}x{H}x{T}x{K} bf16, device ms per call: "
              f"kernel {ms:.4f}, plain {plain:.4f}, bound {b_ms:.6f} "
              f"({b_by}); wall per back-to-back call: kernel "
              f"{wall_ms(torch, run_k):.4f}; err {err:.3e}", flush=True)
        records.append({"name": "wkv6_bhtk" if T > 1 else "wkv6_bhtk_decode",
                        "route": "cuda",
                        "source": "src/repro_torch/kernels/csrc/wkv6.cu",
                        "replaces": "src/repro/kernels/rwkv6.py:69",
                        "launches": 0, "max_abs_err": err, "ms": ms,
                        "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": None})
    return records


def rglru_inputs(torch, g, B, T, C, h0=True):
    """rglru inputs on the card: a = sigmoid(N(0,1)), b = 0.3 N(0,1) (the
    reference kernel test's draws), h0 N(0,1) or zero (a fresh prefill's)."""
    a = torch.sigmoid(torch.randn(B, T, C, generator=g, device="cuda"))
    b = 0.3 * torch.randn(B, T, C, generator=g, device="cuda")
    h = torch.randn(B, C, generator=g, device="cuda") if h0 else \
        torch.zeros(B, C, device="cuda")
    return a, b, h


def live_pairs(Sq, Sk, causal, window):
    """(q, k) pairs a mask leaves live, queries and keys indexed from 0."""
    n = 0
    for r in range(Sq):
        lo = max(0, r - window + 1) if window > 0 else 0
        hi = min(r, Sk - 1) if causal else Sk - 1
        n += max(0, hi - lo + 1)
    return n


def ring_view(torch, g, B, L, KV, n, hd, dtype):
    """The first n slots of a (B, L, KV, hd) ring cache as the (B, KV, n,
    hd) strided view ``ops.flash_attention`` hands the decode form."""
    ring = torch.randn(B, L, KV, hd, generator=g, device="cuda").to(dtype)
    return ring[:, :n].transpose(1, 2)


def flash_form_parity(torch, g):
    """The flash kernel's decode form and fp32 sequence form against the
    plain version: the decode form over strided ring views, as
    ``attn_decode`` calls it, at every head dim; the sequence form at
    every head dim with ragged lengths, a window, softcap and no mask."""
    from repro_torch.kernels import flash_attention as fa

    f32, bf16 = torch.float32, torch.bfloat16
    decode_cases = [  # (B, H, KV, L, n, hd): n of a ring of L slots
        (8, 10, 1, 2048, 2048, 256),   # recurrentgemma-2b, ring filled
        (2, 10, 1, 2048, 1, 256),      # 1 key, 64 ranges
        (3, 2, 1, 2048, 127, 256),     # G 2
        (2, 4, 4, 2048, 1337, 256),    # G 1
        (1, 20, 1, 300, 300, 256),     # G 20: two blocks of query rows
        (2, 8, 4, 96, 43, 32), (2, 4, 2, 64, 64, 16), (3, 4, 1, 500, 333, 64),
        (2, 6, 3, 200, 150, 128),
    ]
    for B, H, KV, L, n, hd in decode_cases:
        for qdt, kvdt in ((f32, bf16), (f32, f32), (bf16, bf16)):
            q = torch.randn(B, H, 1, hd, generator=g, device="cuda").to(qdt)
            k, v = (ring_view(torch, g, B, L, KV, n, hd, kvdt)
                    for _ in range(2))
            got = fa.flash_attention_bhsd(q, k, v, causal=False)
            want = fa.attention_ref(q, k, v, causal=False)
            torch.cuda.synchronize()
            check(f"flash decode {B}x{H}/{KV} over {n} of {L} keys hd {hd}, "
                  f"q {dtype_name(qdt)} K/V {dtype_name(kvdt)}",
                  max_err(got, want), TOL[dtype_name(qdt)])
    q = torch.randn(2, 4, 1, 64, generator=g, device="cuda")
    k = ring_view(torch, g, 2, 90, 2, 90, 64, f32)
    for kw in ({"softcap": 5.0, "causal": False}, {}, {"seq_q": 0}):
        check(f"flash decode {kw}", max_err(
            fa.flash_attention_bhsd(q, k, k, **kw),
            fa.attention_ref(q, k, k, **kw)), TOL["float32"])

    seq_cases = [  # label, (B, H, KV, S), kwargs
        ("seq_q 70, seq_k 61 of 77", (2, 4, 2, 77),
         {"seq_q": 70, "seq_k": 61}),
        ("window 33, softcap 10", (1, 4, 1, 130), {"window": 33,
                                                   "softcap": 10.0}),
        ("non-causal", (2, 2, 2, 65), {"causal": False}),
        ("non-causal seq_k 40 window 9", (1, 3, 1, 100),
         {"causal": False, "seq_k": 40, "window": 9}),
    ]
    for hd in fa.HEAD_DIMS:
        for label, (B, H, KV, S), kw in seq_cases:
            q = torch.randn(B, H, S, hd, generator=g, device="cuda")
            k = torch.randn(B, KV, S, hd, generator=g, device="cuda")
            v = torch.randn(B, KV, S, hd, generator=g, device="cuda")
            got = fa.flash_attention_bhsd(q, k, v, **kw)
            want = fa.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            if "seq_q" in kw:
                expect(bool((got[:, :, kw["seq_q"]:] == 0).all()),
                       "flash: rows past seq_q are not exactly zero")
            check(f"flash fp32 sequence hd {hd} {label}", max_err(got, want),
                  TOL["float32"])


def time_flash_decode(torch, g, B, H, L, hd):
    """The decode form as the recurrentgemma-2b path calls it: an fp32
    query a head over the bf16 ring's L filled slots, read in place; then
    the same over fp32 K/V. Device time of the kernel, the plain version
    and sdpa (fp32, no mask: every key is live, so it is the same
    function; sdpa takes one dtype, so it gets the ring widened to fp32).
    Returns the kernel's JSON record."""
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    record = None
    for kvdt in (torch.bfloat16, torch.float32):
        kv_elem = 2 if kvdt == torch.bfloat16 else 4
        n_bytes = 2 * B * H * hd * 4 + 2 * B * L * hd * kv_elem
        b_ms, b_by = bound_ms(n_bytes, 4 * hd * B * H * L, "float32")
        sets = []
        for _ in range(-(-100_000_000 // n_bytes)):
            q = torch.randn(B, H, 1, hd, generator=g, device="cuda")
            k, v = (ring_view(torch, g, B, L, 1, L, hd, kvdt)
                    for _ in range(2))
            sets.append((q, k, v, k.float(), v.float()))
        err = max_err(fa.flash_attention_bhsd(*sets[0][:3], causal=False),
                      fa.attention_ref(*sets[0][:3], causal=False))
        turn = itertools.cycle(sets)
        run_k = lambda: fa.flash_attention_bhsd(*next(turn)[:3],
                                                causal=False)
        run_p = lambda: fa.attention_ref(*next(turn)[:3], causal=False)

        def run_l():
            q, _, _, k32, v32 = next(turn)
            return F.scaled_dot_product_attention(q, k32, v32,
                                                  enable_gqa=True)
        ms, plain, lib = (graph_ms(torch, run_k), graph_ms(torch, run_p),
                          graph_ms(torch, run_l))
        print(f"  flash hd 256 decode {B}x{H}x1 over {L} {dtype_name(kvdt)} "
              f"ring keys in place, fp32 q (split-KV form), device ms per "
              f"call: kernel {ms:.4f}, plain {plain:.4f}, sdpa (fp32 K/V, no "
              f"mask) {lib:.4f}, bound {b_ms:.6f} ({b_by}); wall per "
              f"back-to-back call: kernel {wall_ms(torch, run_k):.4f}, sdpa "
              f"{wall_ms(torch, run_l):.4f}; err {err:.3e}", flush=True)
        if record is None:             # the record holds the path's dtypes
            record = {
                "name": "flash_attention_bhsd_hd256_decode", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
                "replaces": "src/repro/kernels/flash_attention.py:82",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib}
        del sets, turn
    return record


def phase_dense_decode(torch):
    """Phase 2d: flash's decode form at the dense sampler's shape, as a
    campaign's ``generate`` calls it (6 candidates of one backbone, 8/4
    heads of 32, one query over the first n slots of a (6, 89, 4, 32)
    cache: 64 + 1 + 24 slots; a 30-row backbone + BOS fills 31, and the 23
    decode steps read 32..54), held to the plain version at 1, 2 and the
    automatic number of key ranges in bf16 (q and cache, as the path runs
    it) and fp32, then timed by CUDA-graph replay beside sdpa
    (``enable_gqa``) on the same strided views and its byte bound. Returns
    the kernel's JSON record."""
    import torch.nn.functional as F
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import flash_attention as fa

    B, H, KV, hd = N_CAND, 8, 4, 32
    L = 64 + 1 + RECEPTOR
    auto = fa.decode_splits(B * KV * -(-(H // KV) // fa.DECODE_GROUP),
                            _cuda.sm_count(torch.device("cuda", 0)))
    print(f"phase 2d: flash decode form at the dense sampler's shape: "
          f"{B} x {H}/{KV} heads of {hd}, one query over n of {L} cache "
          f"slots (strided views), {auto} key ranges by decode_splits",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(4)

    def run(q, k, v, n_split):
        return fa._launch_decode(q, k, v, False, 0.0, 1, k.shape[2],
                                 n_split=n_split)

    for dt in (torch.bfloat16, torch.float32):
        for n in (32, 43, 54):          # the first, middle and last step
            q = torch.randn(B, H, 1, hd, generator=g, device="cuda").to(dt)
            k, v = (ring_view(torch, g, B, L, KV, n, hd, dt)
                    for _ in range(2))
            want = fa.attention_ref(q, k, v, causal=False)
            for n_split in (1, 2, auto):
                got = run(q, k, v, n_split)
                torch.cuda.synchronize()
                check(f"flash decode {B}x{H}/{KV} over {n} of {L} keys "
                      f"{dtype_name(dt)}, {n_split} range"
                      f"{'s' * (n_split > 1)}", max_err(got, want),
                      TOL[dtype_name(dt)])
    n = 43
    dt = torch.bfloat16
    q = torch.randn(B, H, 1, hd, generator=g, device="cuda").to(dt)
    k, v = (ring_view(torch, g, B, L, KV, n, hd, dt) for _ in range(2))
    err = max_err(fa.flash_attention_bhsd(q, k, v, causal=False),
                  fa.attention_ref(q, k, v, causal=False))
    n_bytes = 2 * q.numel() * 2 + 2 * B * KV * n * hd * 2
    b_ms, b_by = bound_ms(n_bytes, 4 * hd * B * H * n, "bfloat16")
    run_k = lambda: fa.flash_attention_bhsd(q, k, v, causal=False)
    run_p = lambda: fa.attention_ref(q, k, v, causal=False)
    run_l = lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    ms, plain, lib = (graph_ms(torch, run_k), graph_ms(torch, run_p),
                      graph_ms(torch, run_l))
    turns = [(ns, graph_ms(torch, lambda: run(q, k, v, ns)))
             for ns in (1, 2, auto, auto, 2, 1)]
    print(f"  flash decode {B}x{H}/{KV}x1 over {n} of {L} bf16 cache keys "
          f"in place, bf16 q ({auto} ranges), device ms per call: kernel "
          f"{ms:.4f}, plain {plain:.4f}, sdpa {lib:.4f}, bound {b_ms:.6f} "
          f"({b_by}, {n_bytes} B); wall per back-to-back call: kernel "
          f"{wall_ms(torch, run_k):.4f}, sdpa {wall_ms(torch, run_l):.4f}; "
          f"err {err:.3e}", flush=True)
    print("  same call, ranges forced, device ms per call in turns: "
          + ", ".join(f"{ns} {t:.4f}" for ns, t in turns), flush=True)
    return {"name": "flash_attention_bhsd_decode", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_decode.cu",
            "replaces": "src/repro/kernels/flash_attention.py:82",
            "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib}


def phase_rglru_flash256(torch):
    """Parity of the rglru kernel and of the flash kernel at head dim 256
    against their plain versions on the card, then their device times at
    recurrentgemma-2b's prefill and decode shapes, in fp32 as the path runs
    them. Returns the two kernel records for the JSON line."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru
    from repro_torch.models.attention import make_mask

    print("phase 2c: rglru and flash head dim 256 parity on the card",
          flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)
    B, P, C = RG_BATCH, RG_PROMPT, 2560
    cases = [  # label, (B, T, C), kwargs
        (f"prefill {B}x{P}x{C}, h0 = 0", (B, P, C), {"h0": False}),
        (f"decode {B}x1x{C}", (B, 1, C), {}),
        ("T=32 C=8", (1, 32, 8), {}), ("T=96 C=40", (2, 96, 40), {}),
        ("T=64 C=128", (2, 64, 128), {}), ("T=50 C=24", (1, 50, 24), {}),
        ("ragged T=17 C=130", (3, 17, 130), {}),
    ]
    for label, shape, kw in cases:
        args = rglru_inputs(torch, g, *shape, **kw)
        h, h_T = rglru.rglru_btc(*args)
        h_ref, hT_ref = rglru.rglru_ref(*args)
        torch.cuda.synchronize()
        same = bool(torch.equal(h, h_ref) and torch.equal(h_T, hT_ref))
        check_close(f"rglru {label} h (bitwise equal: {same})", h, h_ref,
                    RGLRU_TOL, RGLRU_TOL)
        check_close(f"rglru {label} h_T", h_T, hT_ref, RGLRU_TOL, RGLRU_TOL)

    W, H = 2048, 10
    flash_cases = [  # label, (B, Sq, Sk), kwargs
        (f"prefill {B}x{H}x{P} MQA window {W}", (B, P, P), {"window": W}),
        ("causal 2x600 MQA", (2, 600, 600), {}),
        ("window 100, 2x333", (2, 333, 333), {"window": 100}),
        (f"decode {B}x{H}x1 over {W} keys", (B, 1, W), {"causal": False}),
        ("decode 3x1 over 1337 keys", (3, 1, 1337), {"causal": False}),
        ("decode 2x1 over 1 key", (2, 1, 1), {"causal": False}),
    ]
    for label, (b, Sq, Sk), kw in flash_cases:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(b, H, Sq, 256, generator=g, device="cuda").to(dt)
            k = torch.randn(b, 1, Sk, 256, generator=g, device="cuda").to(dt)
            v = torch.randn(b, 1, Sk, 256, generator=g, device="cuda").to(dt)
            got = fa.flash_attention_bhsd(q, k, v, **kw)
            want = fa.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            check(f"flash hd 256 {label} {dtype_name(dt)}",
                  max_err(got, want), TOL[dtype_name(dt)])
            del q, k, v, got, want
    flash_form_parity(torch, g)

    # timings, in fp32 as the path runs them; inputs rotate past 100 MB as
    # in phase 2b
    records = []
    for label, T in (("prefill", P), ("decode", 1)):
        n_bytes = 4 * (3 * B * T * C + 2 * B * C)
        b_ms, b_by = bound_ms(n_bytes, 2 * B * T * C, "float32")
        sets = [rglru_inputs(torch, g, B, T, C, h0=T == 1)
                for _ in range(-(-100_000_000 // n_bytes))]
        err = max_err(rglru.rglru_btc(*sets[0])[0],
                      rglru.rglru_ref(*sets[0])[0])
        turn = itertools.cycle(sets)
        run_k = lambda: rglru.rglru_btc(*next(turn))
        run_p = lambda: rglru.rglru_ref(*next(turn))
        ms = graph_ms(torch, run_k)
        plain = graph_ms(torch, run_p, iters=2, replays=2)
        print(f"  rglru {label} {B}x{T}x{C} fp32, device ms per call: kernel "
              f"{ms:.4f}, plain {plain:.4f}, bound {b_ms:.6f} ({b_by}); wall "
              f"per back-to-back call: kernel {wall_ms(torch, run_k):.4f}; "
              f"err {err:.3e}", flush=True)
        if not records:                # the record holds the prefill shape
            records.append({"name": "rglru_btc", "route": "cuda",
                            "source": "src/repro_torch/kernels/csrc/rglru.cu",
                            "replaces": "src/repro/kernels/rglru.py:44",
                            "launches": 0, "max_abs_err": err, "ms": ms,
                            "plain_ms": plain, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": None})
        del sets

    # the fp32 sequence form at the prefill: 8 x 10 x 2560, MQA, window 2048
    hd, S = 256, P
    n_bytes = 4 * (2 * B * H * S * hd + 2 * B * S * hd)
    n_ops = 4 * hd * B * H * live_pairs(S, S, True, W)
    b_ms, b_by = bound_ms(n_bytes, n_ops, "float32")
    sets = [tuple(torch.randn(B, n, S, hd, generator=g, device="cuda")
                  for n in (H, 1, 1))
            for _ in range(-(-100_000_000 // n_bytes))]
    mask = make_mask(torch.arange(S, device="cuda"),
                     torch.arange(S, device="cuda"), True, W)
    kw = dict(causal=True, window=W)
    err = max_err(fa.flash_attention_bhsd(*sets[0], **kw),
                  fa.attention_ref(*sets[0], **kw))
    turn = itertools.cycle(sets)
    run_k = lambda: fa.flash_attention_bhsd(*next(turn), **kw)
    run_p = lambda: fa.attention_ref(*next(turn), **kw)
    run_l = lambda: F.scaled_dot_product_attention(
        *next(turn), attn_mask=mask, enable_gqa=True)
    reps = dict(iters=2, replays=2)
    ms, plain, lib = (graph_ms(torch, run_k, **reps),
                      graph_ms(torch, run_p, **reps),
                      graph_ms(torch, run_l, **reps))
    print(f"  flash hd 256 prefill {B}x{H}x{S} window {W} MQA fp32 "
          f"(register-tiled form), device ms per call: kernel {ms:.4f}, "
          f"plain {plain:.4f}, sdpa {lib:.4f}, bound {b_ms:.6f} ({b_by}); "
          f"err {err:.3e}", flush=True)
    records.append({
        "name": "flash_attention_bhsd_hd256", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:82",
        "launches": 0, "max_abs_err": err, "ms": ms, "plain_ms": plain,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib})
    del sets, turn
    records.append(time_flash_decode(torch, g, B, H, W, hd))
    gc.collect()
    torch.cuda.empty_cache()
    return records


def greedy(torch, params, prompts, cfg, steps):
    """Greedy tokens (B, steps) through prefill + decode_step, and the
    logits of the last decode step."""
    from repro_torch.models import lm
    logits, caches, t = lm.prefill(params, {"inputs": prompts}, cfg,
                                   cache_len=prompts.shape[1] + steps)
    toks = [lm.sample_tokens(logits, 0.0)]
    for i in range(1, steps):
        logits, caches = lm.decode_step(params, caches, toks[-1], t + i - 1,
                                        cfg)
        toks.append(lm.sample_tokens(logits, 0.0))
    return torch.cat(toks, dim=1), logits


def layer_consistency(torch, params, seq, n_prompt, cfg):
    """Every layer fed the input the prefill gives it: its outputs at the
    positions after ``n_prompt`` through its own prefill over the first
    ``n_prompt`` tokens and T=1 decode steps, against its outputs in one
    prefill over all of ``seq``. Returns the largest error, each layer's
    relative to the largest magnitude of its prefill output."""
    from repro_torch.models import blocks
    from repro_torch.models.common import embed_tokens
    B, S = seq.shape
    x = embed_tokens(params.embedding, seq, cfg)
    positions = torch.arange(S, device=x.device)
    worst = 0.0
    for layer, kind in zip(params.layers, cfg.layer_kinds):
        def fresh():
            return blocks.init_layer_cache(kind, cfg, B, S, device=x.device)
        full, _ = blocks.layer_prefill(kind, layer, x,
                                       {"positions": positions}, cfg,
                                       fresh())
        _, state = blocks.layer_prefill(
            kind, layer, x[:, :n_prompt],
            {"positions": positions[:n_prompt]}, cfg, fresh())
        for i in range(n_prompt, S):
            h, state = blocks.layer_decode(kind, layer, x[:, i:i + 1], i, cfg,
                                           state)
            worst = max(worst, max_err(h[:, 0], full[:, i])
                        / float(full.abs().max()))
        x = full
    return worst


def phase_lm_agreement(torch, label, arch, prompt_len):
    """A reduced LM in fp32: one model built on the CPU and copied to the
    card, the same prompts, greedy decoding on the card (kernels) and on
    the CPU (plain versions)."""
    import copy

    import numpy as np
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import lm

    cfg = get_reduced(arch).replace(compute_dtype="float32")
    print(f"{label}: small-input agreement, {arch} card vs CPU (reduced, "
          f"fp32, {prompt_len}-token prompts)", flush=True)
    cpu = lm.init_lm(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to("cuda")
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, size=(4, prompt_len)))
    with torch.inference_mode():
        toks_g, last_g = greedy(torch, card, prompts.cuda(), cfg, 12)
        toks_c, last_c = greedy(torch, cpu, prompts, cfg, 12)
        gen_g = lm.generate(card, {"inputs": prompts.cuda()}, cfg, 12)
    expect(torch.equal(toks_g.cpu(), toks_c), "greedy tokens differ, card vs "
           "CPU")
    expect(torch.equal(gen_g.cpu(), toks_c), "lm.generate differs from the "
           "prefill + decode_step loop")
    check("last-step logits card vs CPU", max_err(last_g.cpu(), last_c), 1e-4)


def new_pipelines(rng, n):
    """Design tasks shaped as the session makes them: a backbone of
    receptor + peptide rows, a target descriptor, no accepted design."""
    return [{"backbone": rng.normal(size=(RECEPTOR + PEPTIDE, 16)).astype(
                 "float32"),
             "target": rng.normal(size=16).astype("float32"),
             "prev": None, "accepted": []} for _ in range(n)]


def design_cycle(torch, pp, mesh, pipes, cycle, aa_emb, peptide, noise=None,
                 times=None):
    """One IMPRESS cycle for every pipeline: one fused paged generate_batch,
    rank by log-likelihood, masked predict_batch on the top 3 (peptide
    appended), accept the first candidate whose fitness improves (the
    accepted sequence pulls the receptor backbone toward its embedding).
    Checks every output's shape and range. With ``times`` (a dict), adds
    the synchronized wall time of each call kind to it. Returns the
    generate result and the number of predict_batch calls."""
    import numpy as np
    from repro_torch.core.protocol import fitness

    def timed(kind, fn, *args):
        if times is None:
            return fn(*args)
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        times[kind] = times.get(kind, 0.0) + time.perf_counter() - t
        return out

    payload = {"backbones": np.stack([p["backbone"] for p in pipes]),
               "seeds": [1000 * i + cycle for i in range(len(pipes))],
               "n": N_CAND, "length": RECEPTOR, "temperature": 1.0,
               "decode": "paged"}
    if noise is not None:
        payload["noise"] = noise
    gen = timed("generate_batch", pp.generate_batch, mesh, payload)
    for p, (seqs, lls) in zip(pipes, gen["rows"]):
        expect(seqs.shape == (N_CAND, RECEPTOR), f"seqs {seqs.shape}")
        expect(((seqs >= 0) & (seqs < pp.gen_cfg.vocab_size)).all(),
               "sampled a pad-vocabulary token")
        expect(np.isfinite(lls).all() and (lls <= 0).all(), f"lls {lls}")
        top = seqs[np.argsort(-lls, kind="stable")[:TOP_K]]
        stack = np.concatenate([top, np.tile(peptide, (len(top), 1))], 1)
        out = timed("predict_batch", pp.predict_batch, mesh, {
            "sequences": stack, "target": p["target"],
            "receptor_len": RECEPTOR,
            "seq_lens": np.full(len(top), stack.shape[1], np.int32),
            "chain_splits": np.full(len(top), RECEPTOR, np.int32)})
        for seq, m in zip(top, out["rows"]):
            expect(0 <= m["plddt"] <= 100 and 0 <= m["ptm"] <= 1
                   and 0 <= m["pae"] <= 30, f"metrics out of range: {m}")
            fit = fitness(m)
            if p["prev"] is None or fit > p["prev"]:
                p["prev"] = fit
                p["accepted"].append((cycle, seq.tolist(), fit))
                p["backbone"][:RECEPTOR] = 0.75 * p["backbone"][:RECEPTOR] \
                    + 0.25 * aa_emb[seq]
                break
    return gen, len(pipes)


def phase_agreement(torch):
    """The reduced payload, fp32, on the card and on the CPU from one seed
    and one noise block: kernels vs plain versions through the whole slice
    at a small size."""
    import numpy as np
    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.payload import ProteinPayload
    from repro_torch.runtime.allocator import SubMesh

    print("phase 3: small-input agreement, card vs CPU (reduced, fp32): the "
          "paged design loop, the dense generate and generate_batch",
          flush=True)
    gcfg = get_reduced("progen-s").replace(compute_dtype="float32")
    fcfg = get_reduced("foldscore-s").replace(compute_dtype="float32")
    noise = np.random.default_rng(1).gumbel(
        size=(2, N_CAND, RECEPTOR, gcfg.padded_vocab))
    backbones = np.random.default_rng(4).normal(
        size=(2, RECEPTOR + PEPTIDE, 16)).astype(np.float32)
    runs, dense = [], []
    for dev in ("cuda", "cpu"):
        pp = ProteinPayload(seed=0, gen_cfg=gcfg, fold_cfg=fcfg, device=dev)
        mesh = SubMesh((pp.device,))
        pipes = new_pipelines(np.random.default_rng(2), 2)
        aa_emb = np.random.default_rng(3).normal(size=(32, 16))
        scores = []
        for cycle in range(2):
            gen, _ = design_cycle(torch, pp, mesh, pipes, cycle, aa_emb,
                                  np.arange(1, 7), noise=noise)
            scores.append(gen["rows"])
        runs.append((scores, [p["accepted"] for p in pipes]))
        # the dense sampler: a solo generate and a dense generate_batch of
        # two rows, on the same noise
        one = pp.generate(mesh, {"backbone": backbones[0], "n": N_CAND,
                                 "length": RECEPTOR, "seed": 5,
                                 "noise": noise[0]})
        two = pp.generate_batch(mesh, {"backbones": backbones,
                                       "seeds": [5, 6], "n": N_CAND,
                                       "length": RECEPTOR, "noise": noise})
        dense.append([(one["seqs"], one["lls"])] + two["rows"])
    (gpu_rows, gpu_acc), (cpu_rows, cpu_acc) = runs
    err = 0.0
    for rows_a, rows_b in zip(gpu_rows, cpu_rows):
        for (s1, l1), (s2, l2) in zip(rows_a, rows_b):
            expect((s1 == s2).all(), "sampled tokens differ, card vs CPU")
            err = max(err, float(np.abs(l1 - l2).max()))
    check("log-likelihoods card vs CPU", err, 1e-3)
    err = 0.0
    for (s1, l1), (s2, l2) in zip(*dense):
        expect(s1.shape == (N_CAND, RECEPTOR) and (s1 == s2).all(),
               "dense generate / generate_batch: tokens differ, card vs CPU")
        err = max(err, float(np.abs(l1 - l2).max()))
    check("dense generate + generate_batch log-likelihoods card vs CPU",
          err, 1e-3)
    expect([[a[:2] for a in acc] for acc in gpu_acc]
           == [[a[:2] for a in acc] for acc in cpu_acc],
           "card and CPU accepted different designs")
    check("accepted fitness card vs CPU",
          max(abs(a[2] - b[2]) for x, y in zip(gpu_acc, cpu_acc)
              for a, b in zip(x, y)), 1e-3)


def phase_main_path(torch, pp):
    """The design loop at full width through the kernels; returns the
    launch counts of the counted window."""
    import numpy as np
    from repro_torch.kernels import ops
    from repro_torch.runtime.allocator import SubMesh

    n_pipes, n_cycles = 4, 2
    g, f = pp.gen_cfg, pp.fold_cfg
    print(f"phase 4: main path, {n_cycles} design cycles x {n_pipes} "
          f"pipelines; {g.name} ({g.n_layers} layers, d {g.d_model}, "
          f"{g.n_heads}/{g.n_kv_heads} heads of {g.head_dim}, "
          f"{g.compute_dtype}) + {f.name} ({f.n_layers} layers, d "
          f"{f.d_model}) on {pp.device}", flush=True)
    mesh = SubMesh((pp.device,))
    rng = np.random.default_rng(0)
    peptide = rng.integers(1, 21, size=PEPTIDE).astype(np.int32)
    aa_emb = rng.normal(size=(g.vocab_size, 16)).astype(np.float32)
    # one cycle before the counted window: first-call allocations, library
    # handles and the engine of this (slots, length)
    design_cycle(torch, pp, mesh, new_pipelines(rng, n_pipes), 0, aa_emb,
                 peptide)
    pipes = new_pipelines(rng, n_pipes)
    times = {}
    steps = admits = n_pred = 0
    torch.cuda.synchronize()
    ops.reset_launches()
    for cycle in range(n_cycles):
        gen, n = design_cycle(torch, pp, mesh, pipes, cycle, aa_emb, peptide,
                              times=times)
        steps += gen["batch"]["steps"]
        admits += gen["batch"]["admits"]
        n_pred += n
    torch.cuda.synchronize()
    counts = dict(ops.launches)
    n_tok = n_cycles * n_pipes * N_CAND * RECEPTOR
    t_gen, t_pred = times["generate_batch"], times["predict_batch"]
    print(f"  generate_batch: {n_cycles} calls of {n_pipes} rows x {N_CAND} "
          f"candidates x {RECEPTOR} tokens, {admits} admissions, {steps} "
          f"decode steps: {t_gen / n_cycles * 1e3:.1f} ms per call, "
          f"{n_tok / t_gen:.0f} tokens/s, {t_gen / steps * 1e3:.2f} ms per "
          f"decode step (admissions included)", flush=True)
    print(f"  predict_batch: {n_pred} calls of {TOP_K} rows x "
          f"{RECEPTOR + PEPTIDE} tokens (bucket 4 x 32): "
          f"{t_pred / n_pred * 1e3:.2f} ms per call", flush=True)
    for i, p in enumerate(pipes):
        print(f"  pipeline {i}: accepted (cycle, fitness) "
              f"{[(c, round(fit, 4)) for c, _, fit in p['accepted']]}",
              flush=True)
    print(f"  launches {counts}: {steps} decode steps, {admits} admissions, "
          f"{n_pred} predict_batch calls", flush=True)
    expect(admits == n_cycles * n_pipes * N_CAND and steps > 0,
           f"{admits} admissions, {steps} steps")
    expect(all(p["accepted"] and p["accepted"][0][0] == 0 for p in pipes),
           "a pipeline accepted nothing in its first cycle")
    want = {"paged_decode_bkgh": g.n_layers * steps,
            "flash_attention_bhsd": g.n_layers * admits + f.n_layers * n_pred,
            "wkv6_bhtk": 0, "rglru_btc": 0}
    expect(counts == want, f"launches {counts}, expected {want}")
    forms = dict(ops.forms["flash_attention_bhsd"])
    print(f"  flash launches by form {forms}", flush=True)
    expect(forms == {"decode": 0, "seq_f32": 0,
                     "seq_bf16": want["flash_attention_bhsd"]},
           f"flash forms {forms}: the protein path runs bf16 sequences")
    return counts


def phase_profile(torch, pp):
    """One design cycle under torch.profiler: device time by kernel and the
    device's busy share of the cycle's wall time."""
    import numpy as np
    from repro_torch.runtime.allocator import SubMesh

    print("phase 5: where the time goes (one design cycle, torch.profiler)",
          flush=True)
    mesh = SubMesh((pp.device,))
    rng = np.random.default_rng(5)
    peptide = rng.integers(1, 21, size=PEPTIDE).astype(np.int32)
    aa_emb = rng.normal(size=(32, 16)).astype(np.float32)
    pipes = new_pipelines(rng, 4)
    gens = []
    kernels = profile_step(torch, lambda: gens.append(design_cycle(
        torch, pp, mesh, pipes, 0, aa_emb, peptide)[0]), "cycle")
    steps = gens[0]["batch"]["steps"]
    paged = [e for e in kernels if "PagedKeys" in e.key]
    n_paged = sum(e.count for e in paged)
    n_comb = sum(e.count for e in kernels if "decode_attention_combine"
                 in e.key)
    print(f"  paged decode: {n_paged} device kernels, "
          f"{sum(e.self_device_time_total for e in paged) / 1e3:.3f} ms, "
          f"for {steps} decode steps x {pp.gen_cfg.n_layers} layers; "
          f"{n_comb} combine kernels", flush=True)
    expect(n_paged == steps * pp.gen_cfg.n_layers and n_comb == 0,
           "paged decode is not one device kernel a layer a step")


def run_campaign(torch, pp, form, n_cycles):
    """One im-rp campaign through the port's campaign engine on the card:
    ``protein_design_tasks(4, receptor_len=24, peptide_len=6)``,
    ``ImpressProtocol`` with the session's defaults (6 candidates, at most
    4 sub-pipelines, one device a generate and a predict) in ``form``, the
    ``Coordinator`` over an ``AsyncExecutor`` (2 workers) over a
    ``DeviceAllocator`` of the card. Checks that it ran to its end with no
    failed or retried task, that every pipeline made a trajectory and that
    every accepted design's metrics are in range. Returns (report, the
    executor's completed tasks)."""
    from repro_torch.core.coordinator import Coordinator
    from repro_torch.core.pipeline import TaskState
    from repro_torch.core.protocol import ImpressProtocol, ProtocolConfig
    from repro_torch.data.synthetic import protein_design_tasks
    from repro_torch.runtime.allocator import DeviceAllocator
    from repro_torch.runtime.executor import AsyncExecutor

    kw = CAMPAIGN_FORMS[form]
    proto = ImpressProtocol(ProtocolConfig(
        n_candidates=N_CAND, n_cycles=n_cycles, max_sub_pipelines=4,
        gen_devices=1, predict_devices=1, **kw))
    ex = AsyncExecutor(DeviceAllocator([pp.device]), max_workers=2)
    try:
        pp.register_all(ex, generate_batch_rows=kw.get("generate_batch_size"),
                        decode_kernel=kw.get("decode_kernel", False))
        coord = Coordinator(ex, proto)
        for t in protein_design_tasks(4, receptor_len=RECEPTOR,
                                      peptide_len=PEPTIDE):
            coord.add_pipeline(proto.new_pipeline(
                t["name"], t["backbone"], t["target"], t["receptor_len"],
                t["peptide_tokens"]))
        rep = coord.run(timeout=300)
        torch.cuda.synchronize()
        # the executor's task table: every task it ran, in every state
        done = [t for t in ex._tasks.values() if t.state == TaskState.DONE]
    finally:
        ex.shutdown()
    pls = list(coord.pipelines.values())
    expect(not any(p.active for p in pls),
           f"{form} campaign: pipelines still active after "
           f"{rep['makespan_s']:.1f} s")
    expect(rep["executor"]["n_failed"] == 0
           and rep["executor"]["n_retried"] == 0,
           f"{form} campaign: {rep['executor']['n_failed']} failed, "
           f"{rep['executor']['n_retried']} retried")
    expect(all(p.meta["trajectories"] > 0 for p in pls),
           f"{form} campaign: a pipeline made no trajectory")
    for p in pls:
        for h in p.history:
            expect(0 <= h["plddt"] <= 100 and 0 <= h["ptm"] <= 1
                   and 0 <= h["pae"] <= 30 and len(h["sequence"]) == RECEPTOR
                   and all(0 <= a < pp.gen_cfg.vocab_size
                           for a in h["sequence"]),
                   f"{form} campaign: design out of range: {h}")
    return rep, done


def implied_launches(form, done, g, f):
    """The kernel launches the completed tasks of a campaign imply, by
    kernel and flash form. Default form: a ``generate`` prefills its 6 rows
    (one flash sequence launch a layer) and takes length - 1 decode steps
    (one decode-form launch a layer each); a solo ``predict`` is one flash
    sequence launch a scorer layer. Batched form: a dispatch's leader
    carries the paged engine's admissions (one prefill a layer each) and
    decode steps (one paged launch a layer each); a ``predict_batch``
    dispatch is one flash launch a scorer layer."""
    kinds = collections.Counter(t.kind for t in done)
    if form == "default":
        gen, pred = kinds["generate"], kinds["predict"]
        seq, dec, paged = (g.n_layers * gen + f.n_layers * pred,
                           g.n_layers * (RECEPTOR - 1) * gen, 0)
        info = f"{gen} generate, {pred} predict"
    else:
        leaders = [t for t in done if t.kind in ("generate_batch",
                                                 "predict_batch")
                   and t.result["batch"].get("leader", True)]
        steps = sum(t.result["batch"]["steps"] for t in leaders
                    if t.kind == "generate_batch")
        admits = sum(t.result["batch"]["admits"] for t in leaders
                     if t.kind == "generate_batch")
        disp = collections.Counter(t.kind for t in leaders)
        expect(admits == N_CAND * kinds["generate_batch"],
               f"{admits} admissions for {kinds['generate_batch']} rows")
        seq, dec, paged = (g.n_layers * admits
                           + f.n_layers * disp["predict_batch"], 0,
                           g.n_layers * steps)
        info = (f"{kinds['generate_batch']} generate_batch rows in "
                f"{disp['generate_batch']} dispatches ({admits} admissions, "
                f"{steps} decode steps), {kinds['predict_batch']} "
                f"predict_batch tasks in {disp['predict_batch']} dispatches")
    return ({"paged_decode_bkgh": paged, "flash_attention_bhsd": seq + dec,
             "wkv6_bhtk": 0, "rglru_btc": 0},
            {"decode": dec, "seq_f32": 0, "seq_bf16": seq}, info)


def phase_campaign(torch, pp):
    """Phase 5b: the paper's main path, an im-rp campaign through the
    port's Coordinator, AsyncExecutor, DeviceAllocator and ProteinPayload
    at full progen-s / foldscore-s width, in each form: the counters zeroed
    just before and read just after, and held to what the completed tasks
    imply. Then one cycle of each form under torch.profiler. Returns each
    form's flash launches by form."""
    from repro_torch.core import payload as payload_mod
    from repro_torch.kernels import ops
    from repro_torch.obs import CompileWatcher, MetricsRegistry

    g, f = pp.gen_cfg, pp.fold_cfg
    out = {}
    for form in CAMPAIGN_FORMS:
        print(f"phase 5b: im-rp campaign, {form} form "
              f"{CAMPAIGN_FORMS[form] or '(dense generate, solo predict)'}:"
              f" 4 structures (receptor {RECEPTOR} + peptide {PEPTIDE}), "
              f"{N_CAND} candidates, {CAMPAIGN_CYCLES} cycles, at most 4 "
              f"sub-pipelines; Coordinator -> AsyncExecutor (2 workers) -> "
              f"DeviceAllocator([{pp.device}]) -> ProteinPayload", flush=True)
        reg = MetricsRegistry()
        start = {k: len(v) for k, v in payload_mod.compile_log.items()}
        torch.cuda.synchronize()
        ops.reset_launches()
        with CompileWatcher(reg) as watcher:
            rep, done = run_campaign(torch, pp, form, CAMPAIGN_CYCLES)
            watcher.absorb_compile_log(payload_mod.compile_log, start)
        counts = dict(ops.launches)
        forms = dict(ops.forms["flash_attention_bhsd"])
        want, want_forms, info = implied_launches(form, done, g, f)
        kinds = collections.Counter(t.kind for t in done)
        accepted = {c: v["n"] for c, v in sorted(rep["cycles"].items())}
        first = {k.split("{")[1][5:-1]: round(v["count"] * v["mean"], 3)
                 for k, v in reg.snapshot().items()
                 if k.startswith("torch.payload_first_call_s")}
        print(f"  makespan {rep['makespan_s']:.3f} s; tasks by kind "
              f"{dict(kinds)}; {rep['n_pipelines']} pipelines + "
              f"{rep['n_sub_pipelines']} sub-pipelines, "
              f"{rep['trajectories']} trajectories; designs accepted by "
              f"cycle {accepted}; batch occupancy {rep['batch_occupancy']}, "
              f"generate batch occupancy {rep['gen_batch_occupancy']}; "
              f"device utilization (allocator) {rep['utilization']:.3f}",
              flush=True)
        print(f"  first calls per shape key (s, in the makespan): {first}",
              flush=True)
        print(f"  launches {counts}, flash by form {forms}; implied by the "
              f"completed tasks ({info}): {want}, {want_forms}", flush=True)
        expect(counts == want and forms == want_forms,
               f"{form} campaign: launches {counts} {forms}, the completed "
               f"tasks imply {want} {want_forms}")
        expect(set(kinds) == ({"generate", "predict"} if form == "default"
                              else {"generate_batch", "predict_batch"}),
               f"{form} campaign ran {dict(kinds)}")
        if form == "default":
            expect(forms["decode"] > 0 and counts["paged_decode_bkgh"] == 0,
                   "default form: no dense decode, or paged launches")
        else:
            expect(counts["paged_decode_bkgh"] > 0 and forms["decode"] == 0,
                   "batched form: no paged decode, or dense decode launches")
        out[form] = forms
    for form in CAMPAIGN_FORMS:
        profile_step(torch, lambda: run_campaign(torch, pp, form, 1),
                     f"campaign {form} form, 1 cycle", top=8)
    return out


def profile_step(torch, fn, label, top=12):
    """Run ``fn`` once under torch.profiler: device time by kernel and the
    device's busy share of the wall time. Returns the device kernels'
    profiler events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = kernel_events(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3      # ms
    print(f"  {label} wall {wall * 1e3:.1f} ms (profiled), device busy "
          f"{busy:.2f} ms = {100 * busy / (wall * 1e3):.1f}% of wall, "
          f"{sum(e.count for e in kernels)} kernel launches", flush=True)
    ranked = sorted(kernels, key=lambda e: -e.self_device_time_total)
    for i, e in enumerate(ranked):     # the top ones, and the port's own
        if i < top or any(n in e.key for n in PORT_KERNELS):
            print(f"    {e.self_device_time_total / 1e3:8.3f} ms "
                  f"{e.count:6d}x  {e.key[:100]}", flush=True)
    return kernels


def phase_serving(torch):
    """rwkv6-7b LM serving at full width through ``serve_batch``; returns
    the launch counts of the counted window."""
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm

    import numpy as np

    cfg = get_config("rwkv6-7b")
    B, P, G = SERVE_BATCH, SERVE_PROMPT, SERVE_GEN
    print(f"phase 6: LM serving, {cfg.name} ({cfg.n_layers} layers, d "
          f"{cfg.d_model}, {cfg.d_model // cfg.rwkv_head_dim} heads of "
          f"{cfg.rwkv_head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype} weights, {cfg.compute_dtype} compute): "
          f"{B} x {P} prompt tokens, {G} generated", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"  weights drawn on the card in {time.perf_counter() - t0:.2f} s:"
          f" {sum(p.numel() for p in params.parameters())} parameters, "
          f"{n_bytes / 1e9:.2f} GB", flush=True)
    # one short request first: library handles and first-call allocations
    serve_batch(cfg, batch=B, prompt_len=16, gen=2, params=params)
    torch.cuda.synchronize()
    ops.reset_launches()
    r = serve_batch(cfg, batch=B, prompt_len=P, gen=G, params=params)
    counts = dict(ops.launches)
    toks = r["tokens"]
    print(f"  prefill {r['prefill_s'] * 1e3:.1f} ms ({r['prefill_tok_s']:.0f}"
          f" tokens/s); decode {r['decode_s'] / (G - 1) * 1e3:.1f} ms per "
          f"step ({r['decode_tok_s']:.1f} tokens/s over {G - 1} steps); peak"
          f" memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    print(f"  launches {counts}; row 0 tokens {toks[0, :8].tolist()}",
          flush=True)
    expect(toks.shape == (B, G), f"tokens {tuple(toks.shape)}")
    expect(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
           "a token outside the vocabulary")
    expect(r["logits_finite"], "a logit is not finite")
    want = {"paged_decode_bkgh": 0, "flash_attention_bhsd": 0,
            "wkv6_bhtk": cfg.n_layers * G, "rglru_btc": 0}
    expect(counts == want, f"launches {counts}, expected {want}")
    forms = dict(ops.forms["wkv6_bhtk"])
    print(f"  wkv6 launches by form {forms}", flush=True)
    want = {"prefill": cfg.n_layers, "decode": cfg.n_layers * (G - 1)}
    expect(forms == want, f"wkv6 forms {forms}, expected {want}")
    counts.update(wkv6_bhtk_prefill=forms["prefill"],
                  wkv6_bhtk_decode=forms["decode"])

    # T=1 decode vs one prefill over the same 72 tokens, at full width and
    # depth in fp32: 64 prompt tokens, then 8 greedy decode steps.
    c32 = cfg.replace(compute_dtype="float32")
    prompts = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, size=(2, 64))).cuda()
    with torch.inference_mode():
        toks32, last = greedy(torch, params, prompts, c32, 9)
        seq = torch.cat([prompts, toks32[:, :-1]], dim=1)
        full, _, _ = lm.prefill(params, {"inputs": seq}, c32)
        per_layer = layer_consistency(torch, params, seq, 64, c32)
    expect(bool(torch.isfinite(last).all()), "fp32 logits not finite")
    # Each layer, fed the prefill's input, gives the same outputs through
    # its state at T=1 as in the prefill, to 1e-4 of the layer's largest
    # output (the residual stream grows from ~3 to ~20 over the 32 layers):
    # room for fp32 products over d 4096 and d_ff 14336 summed in another
    # order (cuBLAS picks other kernels for 2 rows than for 144), carried
    # through 8 steps of state.
    check("full-width fp32, every layer: 8 decode steps vs one prefill over "
          "72 tokens, relative to the layer's output scale", per_layer, 1e-4)
    # End to end, the two paths are two fp32 chains through 32 random
    # layers: their rounding differences grow from layer to layer (a head
    # whose output has a small spread is divided by it in the group norm),
    # so the logits are held only to a quarter of their own scale, which a
    # lost or stale state would exceed.
    scale = float(full.abs().max())
    check(f"full-width fp32, end to end: last decode step vs prefill over "
          f"72 tokens (logits up to {scale:.2f})", max_err(last, full),
          0.25 * scale)

    with torch.inference_mode():
        _, caches, t = lm.prefill(params, {"inputs": prompts.new_ones(
            (B, 16))}, cfg)
        tok = prompts.new_ones((B, 1))
        lm.decode_step(params, caches, tok, t, cfg)        # warm
        profile_step(torch, lambda: lm.decode_step(params, caches, tok, t,
                                                   cfg),
                     f"one decode step ({B} rows)")
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def phase_rg_serving(torch):
    """recurrentgemma-2b LM serving at full width through ``serve_batch``;
    returns the launch counts of the counted window."""
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve_batch
    from repro_torch.models import lm

    cfg = get_config("recurrentgemma-2b")
    B, P, G = RG_BATCH, RG_PROMPT, RG_GEN
    kinds = cfg.layer_kinds
    print(f"phase 7: LM serving, {cfg.name} ({cfg.n_layers} layers: "
          f"{kinds.count('rglru')} rglru + {kinds.count('attn_local')} "
          f"attn_local, window {cfg.attn_window}; d {cfg.d_model}, "
          f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
          f"{cfg.d_ff}, lru {cfg.lru_width}, vocab {cfg.vocab_size}, "
          f"{cfg.param_dtype} weights, {cfg.compute_dtype} compute with the "
          f"reference's fp32 residual stream): {B} x {P} prompt tokens, {G} "
          f"generated", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = lm.init_lm(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_bytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"  weights drawn on the card in {time.perf_counter() - t0:.2f} s:"
          f" {sum(p.numel() for p in params.parameters())} parameters, "
          f"{n_bytes / 1e9:.2f} GB", flush=True)
    serve_batch(cfg, batch=B, prompt_len=16, gen=2, params=params)   # warm
    torch.cuda.synchronize()
    ops.reset_launches()
    r = serve_batch(cfg, batch=B, prompt_len=P, gen=G, params=params)
    counts = dict(ops.launches)
    forms = dict(ops.forms["flash_attention_bhsd"])
    toks = r["tokens"]
    print(f"  prefill {r['prefill_s'] * 1e3:.1f} ms ({r['prefill_tok_s']:.0f}"
          f" tokens/s); decode {r['decode_s'] / (G - 1) * 1e3:.1f} ms per "
          f"step ({r['decode_tok_s']:.1f} tokens/s over {G - 1} steps); peak"
          f" memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    print(f"  launches {counts}, flash by form {forms}; row 0 tokens "
          f"{toks[0, :8].tolist()}", flush=True)
    expect(toks.shape == (B, G), f"tokens {tuple(toks.shape)}")
    expect(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
           "a token outside the vocabulary")
    expect(r["logits_finite"], "a logit is not finite")
    want = {"paged_decode_bkgh": 0,
            "flash_attention_bhsd": kinds.count("attn_local") * G,
            "wkv6_bhtk": 0, "rglru_btc": kinds.count("rglru") * G}
    expect(counts == want, f"launches {counts}, expected {want}")
    want = {"decode": kinds.count("attn_local") * (G - 1),
            "seq_f32": kinds.count("attn_local"), "seq_bf16": 0}
    expect(forms == want, f"flash forms {forms}, expected {want}")
    counts.update(flash_attention_bhsd_hd256=forms["seq_f32"],
                  flash_attention_bhsd_hd256_decode=forms["decode"])

    # T=1 decode vs one prefill over the same tokens, at full width and
    # depth in fp32: 2100 prompt tokens (past the window, not a multiple of
    # it), then 8 greedy decode steps.
    n_prompt, n_dec = 2100, 8
    c32 = cfg.replace(compute_dtype="float32")
    prompts = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab_size, size=(2, n_prompt))).cuda()
    with torch.inference_mode():
        toks32, last = greedy(torch, params, prompts, c32, n_dec + 1)
        seq = torch.cat([prompts, toks32[:, :-1]], dim=1)
        full, _, _ = lm.prefill(params, {"inputs": seq}, c32)
        per_layer = layer_consistency(torch, params, seq, n_prompt, c32)
    expect(bool(torch.isfinite(last).all()), "fp32 logits not finite")
    # Each layer, fed the prefill's input, gives the same outputs through
    # its recurrent state or ring cache at T=1 as in the prefill, to 1e-4
    # of the layer's largest output: room for fp32 products summed in
    # another order (other GEMM kernels for 2 rows than for 4,216; the
    # ring's keys in slot order, not position order).
    check(f"full-width fp32, every layer: {n_dec} decode steps vs one "
          f"prefill over {n_prompt + n_dec} tokens, relative to the layer's "
          f"output scale", per_layer, 1e-4)
    # End to end, two fp32 chains through 26 random layers: held to a
    # quarter of the logits' scale, which a lost state or a stale or
    # misplaced ring entry would exceed.
    scale = float(full.abs().max())
    check(f"full-width fp32, end to end: last decode step vs prefill over "
          f"{n_prompt + n_dec} tokens (logits up to {scale:.2f})",
          max_err(last, full), 0.25 * scale)
    del full, last

    # one decode step over a full ring (position P, the 2048 slots filled)
    with torch.inference_mode():
        prompt = torch.from_numpy(np.random.default_rng(1).integers(
            1, cfg.vocab_size, size=(B, P))).cuda()
        _, caches, t = lm.prefill(params, {"inputs": prompt}, cfg,
                                  cache_len=P + 2)
        tok = prompt[:, -1:]
        lm.decode_step(params, caches, tok, t, cfg)        # warm
        profile_step(torch, lambda: lm.decode_step(params, caches, tok, t,
                                                   cfg),
                     f"one decode step ({B} rows, ring of {cfg.attn_window} "
                     f"filled)")
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    return counts


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core.payload import ProteinPayload
    from repro_torch.kernels import _cuda

    t_start = time.perf_counter()
    print("phase 1: device and build", flush=True)
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}",
          flush=True)
    try:
        triton = metadata.version("triton")
    except metadata.PackageNotFoundError:
        triton = "absent"
    nvcc = subprocess.run([_cuda.nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout
    print(f"  triton {triton}; {nvcc.strip().splitlines()[-1]}", flush=True)
    t0 = time.perf_counter()
    _cuda.lib()
    print(f"  kernels built and loaded in {time.perf_counter() - t0:.1f} s",
          flush=True)
    name = spill = ""                 # ptxas -v: entry, frame/spills, usage
    for line in (_cuda.BUILD_DIR / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:   # drop the file's prefix
            name = re.sub(r"^_ZN\d+_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_"
                          r"[0-9a-f]{8}", "", line.split("'")[1])[:72]
        elif "spill stores" in line:
            spill = line.strip()
        elif "registers" in line:
            print(f"  ptxas {name}: {line.split(':', 1)[-1].strip()}; "
                  f"{spill}", flush=True)

    records = phase_kernels(torch)
    records += phase_wkv6(torch)
    records += phase_rglru_flash256(torch)
    records.append(phase_dense_decode(torch))
    phase_agreement(torch)
    phase_lm_agreement(torch, "phase 3b", "rwkv6-7b", 40)
    phase_lm_agreement(torch, "phase 3c", "recurrentgemma-2b", 20)
    t0 = time.perf_counter()
    pp = ProteinPayload(seed=0, device="cuda")
    print(f"  full-width payload built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    counts = phase_main_path(torch, pp)
    phase_profile(torch, pp)
    campaign = phase_campaign(torch, pp)
    counts["flash_attention_bhsd_decode"] = campaign["default"]["decode"]
    del pp
    wkv = phase_serving(torch)
    counts.update(wkv6_bhtk=wkv["wkv6_bhtk_prefill"],
                  wkv6_bhtk_decode=wkv["wkv6_bhtk_decode"])
    rg = phase_rg_serving(torch)
    counts.update(rglru_btc=rg["rglru_btc"],
                  flash_attention_bhsd_hd256=rg["flash_attention_bhsd_hd256"],
                  flash_attention_bhsd_hd256_decode=rg[
                      "flash_attention_bhsd_hd256_decode"])
    # the design-length record is the same kernel, run on the main path at
    # the engine's shape
    counts["paged_decode_bkgh_256x320"] = counts["paged_decode_bkgh"]
    for rec in records:
        rec["launches"] = counts[rec["name"]]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": records}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
