"""Closed-loop serving in rounds, as ``repro_torch.launch.serve.serve_batch``
serves a batch: each of ``clients`` clients issues a prompt of
``prompt_len`` tokens, the round prefills them together
(``repro_torch.models.lm.prefill``), reads the first tokens on the host, and
generates the other ``gen - 1`` tokens for each greedily through the caches
(``lm.decode_step``) with no read between the steps; the round ends when
its tokens are on the host, and each client issues its next prompt.

Mix parameters: ``clients``, ``prompt_len``, ``gen``, ``check_requests``
(requests the reference checks), ``check_per_round`` (of them, a round's),
``check_rows`` (rows of one reference forward). The checked requests are
drawn from the seed as the window runs: round k keeps the logits of the
clients a permutation drawn from the seed puts at k x ``check_per_round``
onwards, until ``check_requests`` are kept, so that they span the batch.

Set-up draws the seed's weights into the port's module and serves one
round of its own prompts, which warms every shape the window uses. Prompts
are uniform ids in [1, vocab) from a generator on the device seeded from
(seed, round). Time to first token runs from a round's issue to its first
tokens on the host.
"""

from __future__ import annotations

import gc
import statistics
import sys
import time

import torch

from perfbench.lib import judge, portcfg, trace, weights
from perfbench.lib import yardstick as ys


def prompts(seed, i, clients, length, vocab, device):
    g = torch.Generator(device=device).manual_seed(
        weights.piece_seed(seed, 2_000_003 + i))
    return torch.randint(1, vocab, (clients, length), generator=g,
                         device=device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def serve_round(params, cfg, ids, gen, spans=None, keep=None):
    """One round: (first tokens' time from issue, tokens (B, gen) on the
    host, the logits of rows ``keep`` (len(keep), gen, V) or None).
    ``spans`` gathers the prefill's host time, ending in a synchronize, and
    the decode phase's over its steps, ending with the tokens on the
    host."""
    from repro_torch.models import lm
    dev = ids.device
    t0 = time.perf_counter()
    logits, caches, t = lm.prefill(params, {"inputs": ids}, cfg,
                                   cache_len=ids.shape[1] + gen)
    _sync(dev)
    if spans is not None:
        spans["prefill"].append(time.perf_counter() - t0)
    kept = [] if keep is not None else None
    tok = logits.argmax(-1)[:, None]
    if keep is not None:
        kept.append(logits[keep])
    out = [tok]
    tok.cpu()
    ttft = time.perf_counter() - t0
    ts = time.perf_counter()
    for _ in range(gen - 1):
        logits, caches = lm.decode_step(params, caches, tok, t, cfg)
        tok = logits.argmax(-1)[:, None]
        if keep is not None:
            kept.append(logits[keep])
        out.append(tok)
        t += 1
    tokens = torch.cat(out, dim=1).cpu()
    if spans is not None and gen > 1:
        spans["decode_step"].append((time.perf_counter() - ts) / (gen - 1))
    return (ttft, tokens,
            None if keep is None else torch.stack(kept, dim=1))


def run(ctx):
    from repro_torch.models import lm

    mix, c, dev = ctx.mix, ctx.config, ctx.device
    B, P, G = mix["clients"], mix["prompt_len"], mix["gen"]
    V = c["vocab_size"]
    cfg = portcfg.build(c)
    leaves = ctx.reference.leaves(c)
    with torch.device(dev):
        params = lm.LM(cfg)
    weights.fill(dict(params.named_parameters()), leaves, ctx.seed, dev)

    with torch.inference_mode():
        serve_round(params, cfg, prompts(ctx.seed, -1, B, P, V, dev), G)
        _sync(dev)
        setup_s = time.perf_counter() - ctx.t_start

        spans = {"prefill": [], "decode_step": []}
        ttfts, checked = [], []
        g = torch.Generator().manual_seed(weights.piece_seed(ctx.seed, 3))
        order = torch.randperm(B, generator=g).tolist()
        want, per = mix["check_requests"], mix["check_per_round"]
        rounds = 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < ctx.seconds:
            ids = prompts(ctx.seed, rounds, B, P, V, dev)
            n_keep = min(per, want - len(checked))
            keep = [order[(rounds * per + j) % B] for j in range(n_keep)]
            ttft, toks, logits = serve_round(
                params, cfg, ids, G, spans,
                torch.tensor(keep, device=dev) if keep else None)
            ttfts += [ttft] * B
            checked += [(ids[r], toks[r], logits[j])
                        for j, r in enumerate(keep)]
            rounds += 1
        window_s = time.perf_counter() - t0
        n = len(ttfts)
        out = {
            "e2e": {"gen_tokens_per_s": n * G / window_s,
                    "ttft_ms_p90": 1e3 * _p90(ttfts), "setup_s": setup_s},
            "attempted": n, "failed": 0,
            "record": {"window_s": window_s, "requests": n,
                       "model_flops": rounds * ys.serve_flops(
                           leaves, ctx.reference.mixers(c), B, P, G),
                       "spans": spans},
        }
        print(f"[serve] {n} requests in {rounds} rounds, window "
              f"{window_s:.3f} s", file=sys.stderr, flush=True)
        for k, v in spans.items():
            print(f"[serve] {k} ms: median "
                  f"{1e3 * statistics.median(v):.3f}, least "
                  f"{1e3 * min(v):.3f}, most {1e3 * max(v):.3f}",
                  file=sys.stderr, flush=True)
        if ctx.trace:
            ids = prompts(ctx.seed, rounds, B, P, V, dev)

            def one_round():
                serve_round(params, cfg, ids, G)
            out["trace"] = trace.device_pass(one_round)
            out["trace"]["entries"], out["trace"]["gaps"] = \
                trace.entry_pass(one_round, ctx.entries)
    out["memory_peak_bytes"] = ctx.memory_peak()
    asked, answers, logits = (torch.stack([x[i].cpu() for x in checked])
                              for i in range(3))
    del params, checked
    gc.collect()
    ctx.free()
    out["checks"], out["control"] = judge.serve_follow(
        ctx, leaves, asked, answers, logits)
    return out


def _p90(values):
    """The 90th percentile, by linear interpolation between order
    statistics."""
    v = sorted(values)
    if len(v) == 1:
        return v[0]
    x = 0.9 * (len(v) - 1)
    i = int(x)
    return v[i] + (v[min(i + 1, len(v) - 1)] - v[i]) * (x - i)
