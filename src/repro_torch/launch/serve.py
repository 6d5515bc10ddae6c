"""LM token serving: prefill a batch of prompts, then decode greedily
through the layers' decode caches (for rwkv6-7b, the RWKV-6 state; for
recurrentgemma-2b, the RG-LRU states and the local-attention ring caches).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --batch 8 --prompt-len 2560 --gen 32

Runs on ``cuda`` unless ``--device cpu`` is given. The reference's campaign
and gateway modes are not ported yet.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_config, get_reduced
from repro_torch.models import lm


def serve_batch(cfg, *, batch, prompt_len, gen, temperature=0.0, seed=0,
                device="cuda", params=None):
    """Seeded weights (or ``params``, an ``lm.LM`` already on ``device``),
    prompts from ``numpy.random.default_rng(seed + 1)`` in ``[1, vocab)``,
    one prefill of ``batch x prompt_len`` tokens, then ``gen - 1`` decode
    steps, sampling as ``lm.generate`` does (noise from a generator seeded
    ``seed + 2``). Times are wall times that end in a device synchronize.
    Returns the reference's keys (``tokens``
    (batch, gen), ``prefill_s``, ``decode_s``, ``decode_tok_s``,
    ``prefill_tok_s``) and ``logits_finite``: whether every logit of the
    run was finite."""
    if cfg.frontend:
        raise ValueError(f"serve_batch: frontend {cfg.frontend!r} is not "
                         f"ported")
    dev = resolve_device(device)
    if params is None:
        params = lm.init_lm(cfg, seed=seed, device=dev)
    prompts = np.random.default_rng(seed + 1).integers(
        1, cfg.vocab_size, size=(batch, prompt_len))
    b = {"inputs": torch.from_numpy(prompts).to(dev)}
    noise = torch.Generator(device=dev).manual_seed(seed + 2)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, caches, t = lm.prefill(params, b, cfg,
                                       cache_len=prompt_len + gen)
        sync()
        t_prefill = time.perf_counter() - t0
        finite = torch.isfinite(logits).all()
        tok = lm.sample_tokens(logits, temperature, noise)
        out = [tok]
        t0 = time.perf_counter()
        for _ in range(gen - 1):
            logits, caches = lm.decode_step(params, caches, tok, t, cfg)
            finite &= torch.isfinite(logits).all()
            tok = lm.sample_tokens(logits, temperature, noise)
            out.append(tok)
            t += 1
        sync()
        t_decode = time.perf_counter() - t0
    return {
        "tokens": torch.cat(out, dim=1).cpu(),
        "prefill_s": t_prefill,
        "decode_s": t_decode,
        "decode_tok_s": batch * (gen - 1) / max(t_decode, 1e-9),
        "prefill_tok_s": batch * prompt_len / max(t_prefill, 1e-9),
        "logits_finite": bool(finite),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="rwkv6-7b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    r = serve_batch(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    gen=args.gen, device=args.device)
    print(f"[serve] {cfg.name} on {args.device}: prefill "
          f"{r['prefill_s']:.3f}s ({r['prefill_tok_s']:.0f} tok/s), decode "
          f"{r['decode_s']:.3f}s ({r['decode_tok_s']:.1f} tok/s), sample: "
          f"{r['tokens'][0, :8].tolist()}")


if __name__ == "__main__":
    main()
