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
   eager calls.
3. Small-input agreement: the reduced payload on the card (kernels) and on
   the CPU (plain versions), same seed and noise, in fp32: the same
   sampled tokens, log-likelihoods, scores and accepted designs.
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
   device time by kernel and the device's busy share.
6. One ``{"kernels": [...]}`` JSON line, the card line, then the last line
   ``{"ok": true, "device": {...}}``.

Imports neither jax nor the reference package. Exits non-zero without a
CUDA device.
"""

from __future__ import annotations

import json
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
# session defaults (repro/session.py): receptor 24 + peptide 6, 6 candidates
RECEPTOR, PEPTIDE, N_CAND, TOP_K = 24, 6, 6, 3


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


def dtype_name(dt):
    return str(dt).split(".")[1]


def paged_inputs(torch, rng, B, dtype, *, KV=4, G=2, hd=32, page=8, maxp=11,
                 lengths=None):
    """Paged decode inputs at progen-s shapes (24-row engine: 11 pages of 8
    per row); random lengths with every fifth slot inactive by default."""
    import numpy as np
    P = B * maxp + 1
    mk = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32),
                                 device="cuda").to(dtype)
    q = mk(B, KV, G, hd)
    kp, vp = mk(P, KV, page, hd), mk(P, KV, page, hd)
    bt = torch.tensor(rng.permutation(P - 1)[:B * maxp].reshape(B, maxp)
                      .astype(np.int32), device="cuda")
    if lengths is None:
        lengths = rng.integers(0, maxp * page + 1, size=B)
        lengths[::5] = 0
    lens = torch.tensor(np.asarray(lengths, np.int32), device="cuda")
    return q, kp, vp, bt, lens, page


def phase_kernels(torch):
    """Parity of both kernels against their plain versions, then timings at
    the main path's shapes. Returns the kernel records for the JSON line."""
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa

    rng = np.random.default_rng(0)
    print("phase 2: kernel parity on the card", flush=True)
    for B in (24, 32):
        for dt in (torch.float32, torch.bfloat16):
            q, kp, vp, bt, lens, page = paged_inputs(torch, rng, B, dt)
            got = pa.paged_decode_bkgh(q, kp, vp, bt, lens, page_size=page)
            want = pa.paged_decode_ref(q, kp, vp, bt, lens, page_size=page)
            torch.cuda.synchronize()
            check(f"paged_decode B={B} {dtype_name(dt)}", max_err(got, want),
                  PAGED_TOL[dtype_name(dt)])
            expect(bool((got[lens == 0] == 0).all()),
                   "paged_decode: inactive rows are not exactly zero")

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
    ]
    for label, (B, H, KV, S, hd), kw in flash_cases:
        for dt in (torch.float32, torch.bfloat16):
            q = torch.randn(B, H, S, hd, device="cuda").to(dt)
            k = torch.randn(B, KV, S, hd, device="cuda").to(dt)
            v = torch.randn(B, KV, S, hd, device="cuda").to(dt)
            got = fa.flash_attention_bhsd(q, k, v, **kw)
            want = fa.attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            if "seq_q" in kw:
                expect(bool((got[:, :, kw["seq_q"]:] == 0).all()),
                       "flash: rows past seq_q are not exactly zero")
            check(f"flash {label} {dtype_name(dt)}", max_err(got, want),
                  TOL[dtype_name(dt)])

    # timings at the main path's shapes, in bf16 as the path runs them
    dt = torch.bfloat16
    q, kp, vp, bt, lens, page = paged_inputs(
        torch, rng, 24, dt, lengths=np.full(24, 43))
    run_k = lambda: pa.paged_decode_bkgh(q, kp, vp, bt, lens, page_size=page)
    run_p = lambda: pa.paged_decode_ref(q, kp, vp, bt, lens, page_size=page)
    err = max_err(run_k(), run_p())
    B, KV, G, hd = q.shape
    live = int(lens.sum())
    n_bytes = (2 * q.numel() + 2 * live * KV * hd) * 2 + (bt.numel()
                                                          + B) * 4
    b_ms, b_by = bound_ms(n_bytes, 4 * hd * G * KV * live, "bfloat16")
    records = [{"name": "paged_decode_bkgh", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
                "replaces": "src/repro/kernels/paged_attention.py:120",
                "launches": 0, "max_abs_err": err,
                "ms": graph_ms(torch, run_k),
                "plain_ms": graph_ms(torch, run_p),
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}]
    print(f"  paged_decode at 24 slots x 43 cached tokens bf16, device ms "
          f"per call: kernel {records[0]['ms']:.4f}, plain "
          f"{records[0]['plain_ms']:.4f}, bound {b_ms:.6f} ({b_by}); wall "
          f"per back-to-back call: kernel {wall_ms(torch, run_k):.4f}, "
          f"plain {wall_ms(torch, run_p):.4f}; err {err:.3e}", flush=True)

    for label, (B, H, KV, S, hd) in (
            ("predict_batch 4 rows x 32 tokens", (4, 8, 8, 32, 32)),
            ("prefill 1 row x 31 tokens GQA", (1, 8, 4, 31, 32))):
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
        if len(records) == 1:      # the record holds the predict_batch shape
            records.append({
                "name": "flash_attention_bhsd", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
                "replaces": "src/repro/kernels/flash_attention.py:82",
                "launches": 0, "max_abs_err": err, "ms": ms,
                "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": lib})
    return records


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

    print("phase 3: small-input agreement, card vs CPU (reduced, fp32)",
          flush=True)
    gcfg = get_reduced("progen-s").replace(compute_dtype="float32")
    fcfg = get_reduced("foldscore-s").replace(compute_dtype="float32")
    noise = np.random.default_rng(1).gumbel(
        size=(2, N_CAND, RECEPTOR, gcfg.padded_vocab))
    runs = []
    for dev in ("cuda", "cpu"):
        pp = ProteinPayload(seed=0, gen_cfg=gcfg, fold_cfg=fcfg, device=dev)
        pipes = new_pipelines(np.random.default_rng(2), 2)
        aa_emb = np.random.default_rng(3).normal(size=(32, 16))
        scores = []
        for cycle in range(2):
            gen, _ = design_cycle(torch, pp, SubMesh((pp.device,)), pipes,
                                  cycle, aa_emb, np.arange(1, 7), noise=noise)
            scores.append(gen["rows"])
        runs.append((scores, [p["accepted"] for p in pipes]))
    (gpu_rows, gpu_acc), (cpu_rows, cpu_acc) = runs
    err = 0.0
    for rows_a, rows_b in zip(gpu_rows, cpu_rows):
        for (s1, l1), (s2, l2) in zip(rows_a, rows_b):
            expect((s1 == s2).all(), "sampled tokens differ, card vs CPU")
            err = max(err, float(np.abs(l1 - l2).max()))
    check("log-likelihoods card vs CPU", err, 1e-3)
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
            "flash_attention_bhsd": g.n_layers * admits + f.n_layers * n_pred}
    expect(counts == want, f"launches {counts}, expected {want}")
    return counts


def phase_profile(torch, pp):
    """One design cycle under torch.profiler: device time by kernel and the
    device's busy share of the cycle's wall time."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.runtime.allocator import SubMesh

    print("phase 5: where the time goes (one design cycle, torch.profiler)",
          flush=True)
    mesh = SubMesh((pp.device,))
    rng = np.random.default_rng(5)
    peptide = rng.integers(1, 21, size=PEPTIDE).astype(np.int32)
    aa_emb = rng.normal(size=(32, 16)).astype(np.float32)
    pipes = new_pipelines(rng, 4)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        design_cycle(torch, pp, mesh, pipes, 0, aa_emb, peptide)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    kernels = kernel_events(prof)
    busy = sum(e.self_device_time_total for e in kernels) / 1e3      # ms
    print(f"  cycle wall {wall * 1e3:.1f} ms (profiled), device busy "
          f"{busy:.2f} ms = {100 * busy / (wall * 1e3):.1f}% of wall, "
          f"{sum(e.count for e in kernels)} kernel launches", flush=True)
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:12]:
        print(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:6d}x "
              f" {e.key[:100]}", flush=True)


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
    for line in (_cuda.BUILD_DIR / "build.log").read_text().splitlines():
        if "registers" in line:
            print("  ptxas:", line.split(":", 1)[-1].strip(), flush=True)

    records = phase_kernels(torch)
    phase_agreement(torch)
    t0 = time.perf_counter()
    pp = ProteinPayload(seed=0, device="cuda")
    print(f"  full-width payload built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    counts = phase_main_path(torch, pp)
    phase_profile(torch, pp)
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
