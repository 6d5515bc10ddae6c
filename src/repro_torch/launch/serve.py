"""Serving entry points: LM token serving and design-campaign serving.

LM mode (default, ``--arch`` smollm-360m) prefills a batch of prompts,
then decodes greedily through the layers' decode caches (the dense K/V
caches of the decoders; for rwkv6-7b, the RWKV-6 state; for
recurrentgemma-2b, the RG-LRU states and the local-attention ring caches;
for whisper-small, the decoder's self caches beside the encoder's cross
caches). llava-next-34b's patches and whisper-small's frames are stubs
drawn with the prompts:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3-8b \\
      --reduced --device cpu --batch 4 --prompt-len 32 --gen 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch recurrentgemma-2b --batch 8 --prompt-len 2560 --gen 32

Every id of ``configs.registry.ARCH_IDS`` serves (whisper-small,
recurrentgemma-2b, rwkv6-7b, nemotron-4-15b, smollm-360m, chatglm3-6b,
llama3-8b, llama4-maverick-400b-a17b, qwen3-moe-30b-a3b, llava-next-34b;
the two MoE ones route each token through their experts' capacity form).

Campaign mode runs a declarative design campaign through the
``ImpressSession`` facade; one flag serves IM-RP, the CONT-V control, the
multi-objective demo, the staged binder, the rescore co-tenant, or any mix
of them concurrently on one executor:

  PYTHONPATH=src python -m repro_torch.launch.serve --campaign im-rp,cont-v \\
      --structures 4 --cycles 3 [--device cpu]

Ctrl-C in campaign mode is graceful: the campaign is checkpointed (to
``--checkpoint-out``) and the partial report printed before exiting.
``--evolution`` adds online model evolution (finetune tasks on idle
devices, the evolved generator hot-swapped).

Gateway mode starts the persistent multi-tenant service instead — one
resident runtime, campaigns submitted over a JSON HTTP API, co-tenant
same-bucket batches fused across campaigns:

  PYTHONPATH=src python -m repro_torch.launch.serve --gateway --port 8642 \\
      [--tokens tok-a=alice,tok-b=bob] [--quota alice=2.0:4] \\
      [--checkpoint-dir DIR] [--reduced --device cpu]

Every behavior lives in ``repro_torch.gateway.GatewayService``; this mode
parses flags, prints curl examples, and turns Ctrl-C into a graceful
drain (every live campaign checkpointed to ``--checkpoint-dir``). Its
payload is at full width unless ``--reduced`` is given; the reference's
``payload_length`` is not taken (its payload never reads it).

Runs on ``cuda`` (campaign and gateway modes: every CUDA device) unless
``--device cpu`` is given.
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
    prompts from ``numpy.random.default_rng(seed + 1)`` in ``[1, vocab)``
    and, where the frontend takes them, stub patches or frames: 0.02 x a
    normal draw of (batch, frontend_seq, d_model), the reference's stub,
    from the same generator; one prefill of ``batch x prompt_len``
    tokens (the encoder's frames first, or the patches prepended, whose
    slots the caches hold beside the prompt and the generated tokens), then
    ``gen - 1`` decode steps, sampling as ``lm.generate`` does (noise from
    a generator seeded ``seed + 2``). Times are wall times that end in a
    device synchronize. Returns the reference's keys (``tokens``
    (batch, gen), ``prefill_s``, ``decode_s``, ``decode_tok_s``,
    ``prefill_tok_s``), ``logits_finite``: whether every logit of the run
    was finite, and ``cache_len``: the slots of each layer's self cache."""
    dev = resolve_device(device)
    if params is None:
        params = lm.init_lm(cfg, seed=seed, device=dev)
    rng = np.random.default_rng(seed + 1)
    prompts = rng.integers(1, cfg.vocab_size, size=(batch, prompt_len))
    b = {"inputs": torch.from_numpy(prompts).to(dev)}
    stub = {"vision_patches": "patches", "audio_frames": "frames"}
    if cfg.frontend in stub:
        draw = 0.02 * rng.normal(size=(batch, cfg.frontend_seq, cfg.d_model))
        b[stub[cfg.frontend]] = torch.from_numpy(draw.astype(np.float32)) \
            .to(dev)
    cache_len = lm.prefix_len(b, cfg) + prompt_len + gen
    noise = torch.Generator(device=dev).manual_seed(seed + 2)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    with torch.inference_mode():
        sync()
        t0 = time.perf_counter()
        logits, caches, t = lm.prefill(params, b, cfg, cache_len=cache_len)
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
        "cache_len": cache_len,
    }


def serve_campaign(*, protocols, structures, cycles, candidates,
                   receptor_len, evolution, device="cuda", timeout=600.0,
                   trace_dir=None, metrics_every=0.0,
                   checkpoint_out="impress-checkpoint.json"):
    """Run a design campaign through the session facade and return its
    versioned report, on every CUDA device for ``device="cuda"``, else on
    ``device`` alone. ``trace_dir`` enables span tracing (Perfetto JSON +
    metrics snapshot written there); ``metrics_every`` > 0 prints a live
    metrics snapshot line every that-many seconds while the campaign runs.

    KeyboardInterrupt is a graceful exit, not a crash: the campaign is
    checkpointed to ``checkpoint_out`` and the partial report over
    whatever completed so far is returned."""
    import json
    import threading

    from repro_torch.session import (CampaignSpec, ImpressSession,
                                     ProtocolSpec)
    spec = CampaignSpec(
        structures=structures, receptor_len=receptor_len,
        protocols=tuple(ProtocolSpec(kind, n_candidates=candidates,
                                     n_cycles=cycles)
                        for kind in protocols),
        evolution=evolution, timeout=timeout, trace_dir=trace_dir)
    devices = None if device == "cuda" else [resolve_device(device)]
    with ImpressSession(spec, devices=devices) as session:
        stop = threading.Event()
        if metrics_every > 0:
            def _live():
                while not stop.wait(metrics_every):
                    snap = session.metrics_snapshot()
                    done = sum(v for k, v in snap.items()
                               if k.startswith("tasks.completed"))
                    depth = sum(v for k, v in snap.items()
                                if k.startswith("queue.depth"))
                    free = snap.get("devices.free", 0)
                    print(f"[serve] live: {int(done)} tasks done, "
                          f"queue depth {int(depth)}, "
                          f"{int(free)} devices free", flush=True)
            threading.Thread(target=_live, daemon=True).start()
        try:
            return session.run()
        except KeyboardInterrupt:
            if checkpoint_out:
                with open(checkpoint_out, "w") as f:
                    json.dump(session.checkpoint(), f)
                print(f"[serve] interrupted: campaign checkpointed to "
                      f"{checkpoint_out} (resume via "
                      f"ImpressSession.from_checkpoint)", flush=True)
            return session.partial_report()
        finally:
            stop.set()


def serve_gateway(*, host="127.0.0.1", port=8642, tokens=None, quotas=None,
                  max_workers=8, reduced=True, device="cuda", trace_dir=None,
                  checkpoint_dir=None):
    """Start the persistent gateway + its HTTP front-end and block until
    Ctrl-C, which drains gracefully: every live campaign is checkpointed
    (written to ``checkpoint_dir`` when given) before the function
    returns. Runs on every CUDA device for ``device="cuda"``, else on
    ``device`` alone."""
    from repro_torch.gateway import GatewayService, make_server
    devices = None if device == "cuda" else [resolve_device(device)]
    gw = GatewayService(devices=devices, max_workers=max_workers,
                        reduced=reduced, quotas=quotas, trace_dir=trace_dir,
                        checkpoint_dir=checkpoint_dir)
    gw.start()
    srv = make_server(gw, host=host, port=port, tokens=tokens)
    bound_host, bound_port = srv.server_address[:2]
    base = f"http://{bound_host}:{bound_port}"
    auth = (f' -H "Authorization: Bearer {next(iter(tokens))}"'
            if tokens else "")
    print(f"[serve] gateway listening on {base}", flush=True)
    print(f"[serve]   submit:  curl{auth} -X POST {base}/campaigns "
          "-d '{\"structures\": 2, \"receptor_len\": [24, 32], "
          "\"protocols\": [{\"kind\": \"binder\"}]}'", flush=True)
    print(f"[serve]   report:  curl{auth} {base}/campaigns/c0000/report",
          flush=True)
    print(f"[serve]   metrics: curl{auth} {base}/metrics", flush=True)
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.shutdown()
        checkpoints = gw.shutdown()
        if checkpoints:
            where = (f" to {checkpoint_dir}" if checkpoint_dir
                     else " (pass --checkpoint-dir to persist)")
            print(f"[serve] checkpointed {len(checkpoints)} live "
                  f"campaign(s){where}: {sorted(checkpoints)}", flush=True)
        print("[serve] gateway stopped", flush=True)


def _parse_kv(arg, what):
    """Parse ``a=x,b=y`` flags (``--tokens``/``--quota``) into a dict."""
    out = {}
    for part in filter(None, (arg or "").split(",")):
        if "=" not in part:
            raise SystemExit(f"[serve] bad --{what} entry {part!r} "
                             f"(want key=value[,key=value...])")
        k, v = part.split("=", 1)
        out[k.strip()] = v.strip()
    return out or None


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--campaign", default=None, metavar="KINDS",
                    help="serve a design campaign instead: comma-separated "
                         "protocol kinds (e.g. im-rp,cont-v)")
    ap.add_argument("--structures", type=int, default=2)
    ap.add_argument("--cycles", type=int, default=3)
    ap.add_argument("--candidates", type=int, default=5)
    ap.add_argument("--receptor-len", type=int, default=20)
    ap.add_argument("--evolution", action="store_true",
                    help="campaign mode: online model evolution")
    ap.add_argument("--trace-dir", default=None,
                    help="campaign mode: enable span tracing and write "
                         "Perfetto trace.json + metrics.json here")
    ap.add_argument("--metrics-every", type=float, default=0.0,
                    help="campaign mode: print a live metrics snapshot "
                         "every N seconds while the campaign runs")
    ap.add_argument("--checkpoint-out", default="impress-checkpoint.json",
                    help="campaign mode: where Ctrl-C writes the campaign "
                         "checkpoint ('' disables)")
    ap.add_argument("--gateway", action="store_true",
                    help="serve the persistent multi-tenant gateway "
                         "(JSON HTTP API) instead")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8642)
    ap.add_argument("--tokens", default=None, metavar="TOK=TENANT,...",
                    help="gateway mode: bearer-token auth table; omit for "
                         "open single-user mode")
    ap.add_argument("--quota", default=None, metavar="TENANT=SHARE[:CAP],..",
                    help="gateway mode: per-tenant fair share and optional "
                         "hard device cap (e.g. alice=2.0:4,bob=1.0)")
    ap.add_argument("--checkpoint-dir", default=None,
                    help="gateway mode: Ctrl-C writes every live "
                         "campaign's checkpoint here")
    args = ap.parse_args(argv)
    if args.gateway:
        from repro_torch.gateway import TenantQuota
        quotas = None
        if args.quota:
            quotas = {}
            for tenant, v in (_parse_kv(args.quota, "quota") or {}).items():
                share, _, cap = v.partition(":")
                quotas[tenant] = TenantQuota(
                    share=float(share or 1.0),
                    max_devices=int(cap) if cap else None)
        serve_gateway(host=args.host, port=args.port,
                      tokens=_parse_kv(args.tokens, "tokens"),
                      quotas=quotas, reduced=args.reduced,
                      device=args.device, trace_dir=args.trace_dir,
                      checkpoint_dir=args.checkpoint_dir)
        return
    if args.campaign:
        rep = serve_campaign(protocols=args.campaign.split(","),
                             structures=args.structures, cycles=args.cycles,
                             candidates=args.candidates,
                             receptor_len=args.receptor_len,
                             evolution=args.evolution, device=args.device,
                             trace_dir=args.trace_dir,
                             metrics_every=args.metrics_every,
                             checkpoint_out=args.checkpoint_out)
        print(f"[serve] campaign schema v{rep.schema_version} on "
              f"{args.device}: {rep.trajectories} trajectories in "
              f"{rep.makespan_s:.1f}s, utilization "
              f"{100 * rep.utilization:.0f}%")
        for name, p in rep.protocols.items():
            print(f"[serve]   {name}: {p['n_pipelines']} pipelines "
                  f"(+{p['n_sub_pipelines']} subs), "
                  f"{p['trajectories']} trajectories")
        evo = rep.evolution
        if evo is not None:
            print(f"[serve]   evolution: enabled {evo['enabled']}, "
                  f"{evo['submitted']} finetunes submitted, "
                  f"{evo['completed']} completed, generator version "
                  f"{evo['param_version']}")
        tel = rep.raw.get("telemetry", {})
        if tel.get("trace_path"):
            print(f"[serve] trace: {tel['trace_path']} "
                  f"(load in ui.perfetto.dev)")
        return
    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    r = serve_batch(cfg, batch=args.batch, prompt_len=args.prompt_len,
                    gen=args.gen, device=args.device)
    print(f"[serve] {cfg.name} on {args.device}: prefill "
          f"{r['prefill_s']:.3f}s ({r['prefill_tok_s']:.0f} tok/s), decode "
          f"{r['decode_s']:.3f}s ({r['decode_tok_s']:.1f} tok/s), sample: "
          f"{r['tokens'][0, :8].tolist()}")


if __name__ == "__main__":
    main()
