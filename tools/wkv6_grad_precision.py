#!/usr/bin/env python3
"""How the order of WKV6's gradient arithmetic moves its precision, on the
CPU.

  PYTHONPATH=src python3 tools/wkv6_grad_precision.py

The gradient kernel (``kernels/csrc/wkv6_bwd.cu``) works in chunks of
``rwkv6.BWD_CHUNK`` tokens in fp32, and ``kernels/rwkv6.py::
wkv6_bwd_chunk_ref`` repeats its algorithm; ``wkv6_bwd_serial_ref`` walks
the recurrence token by token. Two choices in either decide how far it
lands from the exact gradient:

- a decay step as w S, w = exp(logw) rounded to fp32, or as S - d S with
  d = 1 - w taken as -expm1(logw): near logw = -1e-6 the rounding of w is
  up to 3% of 1 - w, with the same sign at every token;
- dlogw's factor as w = exp(logw), or as 1 - d, which rounds a small w
  (2e-9 at logw = -20) to 0.

It prints (1) at the logw ends (-e^5 and -1e-6 on alternating channels,
1 x 4 x 512 x 64) each of the six gradients' max error over its max
against an fp64 token-serial autograd, for the CPU backward's chunked
algebra (autograd through ``wkv6_ref``), the kernel's chunk algorithm,
the token-serial oracle, and the
token-serial forms that take the other choices; (2) ``chip_smoke.py``'s
phase 10b on the CPU: reduced rwkv6-7b in fp32 with remat "full", 5 AdamW
steps with the CPU backward and then with the kernel's algorithm and each
token-serial form, the worst leaf's max weight difference (phase 10b holds
1e-4).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.registry import get_reduced
from repro_torch.data.synthetic import lm_batch
from repro_torch.kernels import rwkv6
from repro_torch.models import lm
from repro_torch.models.common import trainable
from repro_torch.optim import OptConfig, init_opt_state, make_train_step

NAMES = ("r", "k", "v", "logw", "u", "s0")


def serial_grads(r, k, v, logw, u, s0, dy, dS, decay, factor):
    """The six gradients by a plain token-serial walk in fp32 (every state
    kept): decay steps as ``decay`` "w" (w S) or "d" (S - d S), dlogw's
    factor as ``factor`` "w" (exp(logw)) or "1-d"."""
    rf, kf, vf, yf = (x.float() for x in (r, k, v, dy))
    w, d = logw.exp(), -torch.expm1(logw)

    def decayed(X, t):
        if decay == "w":
            return w[:, :, t, :, None] * X
        return X - d[:, :, t, :, None] * X
    S, states = s0.float(), []
    for t in range(r.shape[2]):
        states.append(S)
        S = decayed(S, t) + kf[:, :, t, :, None] * vf[:, :, t, None, :]
    G = dS.float().clone()
    dr, dk, dv, dlw = (torch.empty_like(rf) for _ in range(4))
    vdy = (vf * yf).sum(-1)
    du = torch.zeros_like(u)
    fac = w if factor == "w" else 1 - d
    for t in reversed(range(r.shape[2])):
        Sp = states[t]
        uk = u[None] * kf[:, :, t]
        dr[:, :, t] = (Sp * yf[:, :, t, None, :]).sum(-1) + uk * vdy[..., t,
                                                                     None]
        dk[:, :, t] = (G * vf[:, :, t, None, :]).sum(-1) \
            + u[None] * rf[:, :, t] * vdy[..., t, None]
        dv[:, :, t] = (G * kf[:, :, t, :, None]).sum(-2) \
            + (rf[:, :, t] * uk).sum(-1, keepdim=True) * yf[:, :, t]
        dlw[:, :, t] = fac[:, :, t] * (G * Sp).sum(-1)
        du = du + (rf[:, :, t] * kf[:, :, t] * vdy[..., t, None]).sum(0)
        G = decayed(G, t) + rf[:, :, t, :, None] * yf[:, :, t, None, :]
    return dr, dk, dv, dlw, du, G


def exact_grads(r, k, v, logw, u, s0, dy, dS):
    """Autograd through a token-serial forward in fp64."""
    xs = [x.double().requires_grad_() for x in (r, k, v, logw, u, s0)]
    rr, kk, vv, lw, uu, S = xs
    ys = []
    with torch.enable_grad():
        for t in range(rr.shape[2]):
            kv = kk[:, :, t, :, None] * vv[:, :, t, None, :]
            ys.append((rr[:, :, t, :, None]
                       * (S + uu[None, :, :, None] * kv)).sum(2))
            S = lw[:, :, t, :, None].exp() * S + kv
        return torch.autograd.grad([torch.stack(ys, 2), S], xs,
                                   [dy.double(), dS.double()])


def at_the_logw_ends():
    B, H, T, K = 1, 4, 512, 64
    g = torch.Generator().manual_seed(3)
    mk = lambda *s: torch.randn(*s, generator=g)              # noqa: E731
    r, k, v = (0.5 * mk(B, H, T, K) for _ in range(3))
    logw = -torch.exp(mk(B, H, T, K))
    logw[..., ::2] = -float(np.exp(5.0))
    logw[..., 1::2] = -1e-6
    args = [r, k, v, logw, 0.3 + 0.1 * mk(H, K), 0.1 * mk(B, H, K, K)]
    dy, dS = mk(B, H, T, K), mk(B, H, K, K)
    exact = exact_grads(*args, dy, dS)
    xs = [x.clone().requires_grad_() for x in args]
    with torch.enable_grad():
        chunked = torch.autograd.grad(rwkv6.wkv6_ref(*xs), xs, (dy, dS))
    forms = {"chunked (the CPU backward's algebra)": chunked}
    forms["the kernel's algorithm (wkv6_bwd_chunk_ref)"] = \
        rwkv6.wkv6_bwd_chunk_ref(*args, dy, dS)
    forms["the token-serial oracle (wkv6_bwd_serial_ref)"] = \
        rwkv6.wkv6_bwd_serial_ref(*args, dy, dS)
    for decay, factor in (("w", "w"), ("d", "w"), ("d", "1-d")):
        forms[f"token-serial, decay {decay} S, dlogw's factor {factor}"] = \
            serial_grads(*args, dy, dS, decay, factor)
    print(f"(1) logw at -e^5 and -1e-6, {B} x {H} x {T} x {K}: each "
          f"gradient's max error over its max against fp64")
    for name, got in forms.items():
        errs = [float((a.double() - b).abs().max() / b.abs().max())
                for a, b in zip(got, exact)]
        print(f"  {name}: " + ", ".join(f"d{n} {e:.2e}"
                                        for n, e in zip(NAMES, errs)))


def phase_10b_on_the_cpu():
    opt = OptConfig(lr=5e-4, warmup_steps=0, total_steps=10)
    cfg = get_reduced("rwkv6-7b").replace(compute_dtype="float32",
                                          remat="full")
    base = lm.init_lm(cfg, seed=0, device="cpu")
    batches = [lm_batch(cfg, 4, 40, seed=3, step=i) for i in range(5)]
    plain = rwkv6._bwd_plain

    def train(bwd):
        rwkv6._bwd_plain = bwd
        try:
            params = trainable(base, "cpu")
            state = init_opt_state(dict(params.named_parameters()), opt)
            step = make_train_step(cfg, opt)
            for b in batches:
                params, state, _ = step(params, state, b)
        finally:
            rwkv6._bwd_plain = plain
        return {n: p.detach() for n, p in params.named_parameters()}

    def serial(decay, factor):
        def bwd(r, k, v, logw, u, s0, dy, dS):
            dy = torch.zeros_like(r) if dy is None else dy
            dS = torch.zeros_like(s0) if dS is None else dS
            out = serial_grads(r, k, v, logw, u, s0, dy, dS, decay, factor)
            return tuple(g.to(x.dtype) for g, x in
                         zip(out, (r, k, v, logw, u, s0)))
        return bwd
    want = train(plain)
    print("(2) phase 10b on the CPU: reduced rwkv6-7b, 5 fp32 AdamW steps, "
          "each form against the CPU backward's, the worst leaf's max "
          "weight difference")
    for name, bwd in (("the kernel's algorithm",
                       lambda *a: rwkv6.wkv6_bwd_chunk_ref(*a)),
                      ("the token-serial oracle",
                       lambda *a: rwkv6.wkv6_bwd_serial_ref(*a)),
                      ("decay d S, dlogw's factor w", serial("d", "w")),
                      ("decay d S, dlogw's factor 1-d", serial("d", "1-d")),
                      ("decay w S, dlogw's factor w", serial("w", "w"))):
        got = train(bwd)
        err, leaf = max((float((got[n] - want[n]).abs().max()), n)
                        for n in want)
        print(f"  {name}: {err:.3e} ({leaf})")


if __name__ == "__main__":
    torch.set_num_threads(4)
    at_the_logw_ends()
    phase_10b_on_the_cpu()
