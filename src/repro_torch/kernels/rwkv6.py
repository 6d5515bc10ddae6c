"""RWKV-6 (Finch) WKV recurrence.

  y_t = r_t · (S_{t-1} + diag(u) k_t v_tᵀ)
  S_t = diag(exp(logw_t)) S_{t-1} + k_t v_tᵀ

Layouts (the TPU kernel's):
  r/k/v  (B, H, T, K)   compute dtype (fp32 or bf16)
  logw   (B, H, T, K)   fp32 log-decay, <= -1e-6
  u      (H, K)         fp32 bonus for the current token
  s0     (B, H, K, K)   fp32 incoming state
Returns y (B, H, T, K) in r's dtype and s_T (B, H, K, K) in fp32.

``wkv6_bhtk`` takes the plain version for CPU tensors and launches a CUDA
kernel (``csrc/wkv6.cu``, token-serial) for CUDA tensors: the decode kernel
at T = 1, the prefill kernel at T > 1 (``wkv6_serial_ref`` repeats its
order of operations). ``wkv6_grad`` is the same function with a gradient
(``WKV6``): the kernel's forward, and a backward (``wkv6_bwd_bhtk``) that
launches the gradient kernel (``csrc/wkv6_bwd.cu``: chunks of
``BWD_CHUNK`` tokens, the states at their boundaries carried by one pass,
then every chunk's gradients at once, the products through a state on the
tensor cores; ``wkv6_bwd_chunk_ref`` repeats its algorithm) on CUDA
tensors and recomputes ``wkv6_ref``'s chunks under autograd on CPU
tensors; ``wkv6_bwd_serial_ref`` is a token-serial oracle of the same
gradients. ``_cuda.forms``
counts the three forms apart: decode, prefill and backward.

Cost accounting (``distributed.cost``): each forward call reports
``cost.wkv6_work`` and each backward ``cost.wkv6_bwd_work`` under the
``wkvscan`` tag to an active counter, whatever implements them, and on the
``meta`` device both return empty outputs of the right shapes and dtypes
(the dry run's path).
"""

from __future__ import annotations

import torch

from repro_torch.distributed import cost
from repro_torch.kernels import _cuda

HEAD_DIMS = (16, 64)   # the CUDA kernel's templates: reduced and full rwkv6
ROW_GROUPS = {16: 4, 64: 8}   # the prefill kernel's lanes a state column
CHUNK = 16             # tokens the prefill kernel stages at a time


def wkv6_ref(r, k, v, logw, u, s0, chunk=32):
    """Plain version of ``wkv6_bhtk``: the reference's chunked fp32 form
    (``repro.models.ssm.wkv6_chunked``). Within a chunk the pairwise decay
    from token j to token t is exp of the sum of logw over the tokens
    between them (exponent <= 0); the state is carried from chunk to chunk.
    The last chunk is short where ``chunk`` does not divide T.

    Each decay exponent is summed over its own tokens (reverse cumulative
    sums), not taken as a difference of prefix sums as the reference does:
    near logw = -e^5 a prefix sum reaches ~-4700 within 32 tokens, and
    differences of such sums lose ~5e-4 to fp32 rounding."""
    S = s0.float()
    uf = u.float()[None, :, None, :]                              # (1,H,1,K)
    ys = []
    for t0 in range(0, r.shape[2], chunk):
        y, S = _chunk_fwd(*_chunk(r, k, v, logw, t0, chunk), uf, S)
        ys.append(y)
    return torch.cat(ys, dim=2).to(r.dtype), S


def _chunk(r, k, v, logw, t0, chunk):
    """Tokens t0 .. t0 + chunk - 1 of r, k, v and logw, in fp32."""
    return (x[:, :, t0:t0 + chunk].float() for x in (r, k, v, logw))


def _chunk_state(kk, vv, lw, S):
    """The state after one chunk: S decays over the whole chunk, k_j over
    the tokens after j."""
    after = lw.flip(2).cumsum(2).flip(2)
    after = torch.cat([after[:, :, 1:], torch.zeros_like(lw[:, :, :1])],
                      dim=2)
    return S * lw.sum(2)[..., None].exp() \
        + (kk * after.exp()).transpose(-1, -2) @ vv


def _chunk_fwd(rr, kk, vv, lw, uf, S):
    """One chunk of ``wkv6_ref`` on fp32 (B,H,C,K) pieces from state S:
    returns (y (B,H,C,K) fp32, the state after the chunk)."""
    C = rr.shape[2]
    before = torch.ones(C, C, dtype=torch.bool, device=rr.device).tril(-1)
    # carry-in: r_t decayed over the chunk's tokens before t
    ecl = torch.cat([torch.zeros_like(lw[:, :, :1]),
                     lw.cumsum(2)[:, :, :-1]], dim=2)
    y = (rr * ecl.exp()) @ S
    # D[t, j] = exp(sum of logw_i, j < i < t), for j < t
    m = lw[:, :, None, :, :] * before[:, :, None]                # [t, i<t]
    tail = m.flip(3).cumsum(3).flip(3)                        # sum over i>=j
    D = torch.cat([tail[:, :, :, 1:], torch.zeros_like(tail[:, :, :, :1])],
                  dim=3).exp()
    scores = (rr[:, :, :, None, :] * kk[:, :, None, :, :] * D).sum(-1)
    scores = scores * before
    bonus = (rr * uf * kk).sum(-1, keepdim=True)                  # (B,H,C,1)
    y = y + scores @ vv + bonus * vv
    return y, _chunk_state(kk, vv, lw, S)


def wkv6_serial_ref(r, k, v, logw, u, s0, *, chunk=CHUNK, groups=None):
    """The prefill kernel's order of operations in plain PyTorch, token by
    token in fp32: chunks of ``chunk`` tokens staged with exp(logw) and the
    bonus beta_t = sum_i r_i u_i k_i computed once a (token, row); then per
    token y_t[j] = sum_i r_i S_ij + beta_t v_j, the rows of a column summed
    in ``groups`` row groups (group g holds rows 4 g + 4 groups q + e, e <
    4: a lane's rows in the kernel), each on its own, and the group sums
    added pairwise, groups g and g + groups/2 first, as the kernel's
    shuffles add them; then
    S = exp(logw_t) S + k_t v_t^T. The same function as ``wkv6_ref``; the
    tests hold one to the other."""
    B, H, T, K = r.shape
    groups = groups or ROW_GROUPS.get(K, 4)
    rows = torch.tensor([q * groups * 4 + g * 4 + e for g in range(groups)
                         for q in range(K // (groups * 4)) for e in range(4)],
                        device=r.device)
    S = s0.float().clone()
    uf = u.float()[None, :, None, :]
    ys = []
    for t0 in range(0, T, chunk):
        rr, kk, vv = (x[:, :, t0:t0 + chunk].float() for x in (r, k, v))
        w = logw[:, :, t0:t0 + chunk].float().exp()
        beta = (rr * uf * kk).sum(-1, keepdim=True)               # (B,H,C,1)
        for t in range(rr.shape[2]):
            part = (rr[:, :, t, :, None] * S)[:, :, rows] \
                .reshape(B, H, groups, K // groups, K).sum(3)
            while part.shape[2] > 1:
                half = part.shape[2] // 2
                part = part[:, :, :half] + part[:, :, half:]
            ys.append(part[:, :, 0] + beta[:, :, t] * vv[:, :, t])
            S = w[:, :, t, :, None] * S \
                + kk[:, :, t, :, None] * vv[:, :, t, None, :]
    return torch.stack(ys, dim=2).to(r.dtype), S


def wkv6_bhtk(r, k, v, logw, u, s0):
    """r/k/v/logw (B,H,T,K); u (H,K); s0 (B,H,K,K) fp32. Returns y
    (B,H,T,K) in r's dtype and s_T (B,H,K,K) fp32."""
    B, H, T, K = r.shape
    with cost.counted("wkvscan",
                      lambda: cost.wkv6_work(B, H, T, K, r.element_size())):
        if r.device.type == "meta":
            return torch.empty_like(r), torch.empty_like(s0,
                                                         dtype=torch.float32)
        if r.device.type == "cpu":
            return wkv6_ref(r, k, v, logw, u, s0)
        if r.device.type != "cuda":
            raise ValueError(f"wkv6_bhtk: no kernel for {r.device}")
        return _launch(r, k, v, logw, u, s0)


def _launch(r, k, v, logw, u, s0):
    name = "wkv6_bhtk"
    f32 = (torch.float32,)
    dev = _cuda.check_cuda_tensors(
        name, (r, k, v, logw, u, s0),
        ((torch.float32, torch.bfloat16), (r.dtype,), (r.dtype,), f32, f32,
         f32))
    B, H, T, K = r.shape
    if k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape \
            or u.shape != (H, K) or s0.shape != (B, H, K, K):
        raise ValueError(
            f"{name}: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v "
            f"{tuple(v.shape)}, logw {tuple(logw.shape)}, u {tuple(u.shape)},"
            f" s0 {tuple(s0.shape)}")
    if K not in HEAD_DIMS or T < 1:
        raise ValueError(f"{name}: head dim {K} not in {HEAD_DIMS} or T={T}")
    if T > 1 and any(x.data_ptr() % 16 for x in (r, k, v, logw, s0)):
        raise ValueError(f"{name}: the prefill kernel copies in 16-byte "
                         f"pieces: r, k, v, logw and s0 must start 16-byte "
                         f"aligned")
    y = torch.empty_like(r)
    s_T = torch.empty_like(s0)
    if B * H == 0:
        return y, s_T
    err = _cuda.lib().repro_wkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), s0.data_ptr(), y.data_ptr(), s_T.data_ptr(), B, H, T, K,
        _cuda.DTYPE_CODES[r.dtype], *_cuda.device_and_stream(dev))
    _cuda.check_launch(name, err, "decode" if T == 1 else "prefill")
    return y, s_T


# ---------------------------------------------------------------------------
# training: the gradient
# ---------------------------------------------------------------------------

GRAD_CHUNK = 32     # tokens the plain backward recomputes at a time
BWD_CHUNK = 16      # tokens a chunk of the gradient kernel (its CHUNK)


def bwd_chunks(T):
    """Chunks of ``BWD_CHUNK`` tokens the gradient kernel cuts T into, the
    last one padded: its carry writes the state at each."""
    return -(-T // BWD_CHUNK)


def _chain(x, dim):
    """Sum over ``dim`` in order: ((x0 + x1) + x2) + ..."""
    out = x.select(dim, 0)
    for i in range(1, x.shape[dim]):
        out = out + x.select(dim, i)
    return out


def wkv6_bwd_serial_ref(r, k, v, logw, u, s0, dy, dS):
    """A token-serial oracle of ``wkv6_bwd_bhtk``'s six gradients in fp32
    at the upstream (dy, dS), either None for zero: every state S_{t-1}
    kept from a forward walk, then G = dL/dS_t walked back from dS, dr_t =
    S_{t-1} dy_t + (u k_t)(v_t . dy_t), dk_t = G v_t + (u r_t)(v_t . dy_t),
    dv_t = G^T k_t + beta_t dy_t, dlogw_t = w_t rowsum(G S_{t-1}), G =
    (G - d_t G) + r_t dy_t^T; a decay step S - d S with d = -expm1(logw),
    dlogw's factor w = exp(logw) itself. du adds r_t k_t (v_t . dy_t) over
    the tokens backwards, then over b in order; ds0 is the last G."""
    B, H, T, K = r.shape
    rf, kf, vf = r.float(), k.float(), v.float()
    w = logw.float().exp()
    d = -torch.expm1(logw.float())
    yf = torch.zeros_like(rf) if dy is None else dy.float()
    uf = u.float()[None, :, None, :]
    vdy = (vf * yf).sum(-1, keepdim=True)
    S, prev = s0.float(), []
    for t in range(T):
        prev.append(S)
        S = (S - d[:, :, t, :, None] * S) \
            + kf[:, :, t, :, None] * vf[:, :, t, None, :]
    G = torch.zeros_like(S) if dS is None else dS.float().clone()
    dr, dk, dlw, dvs = (torch.empty_like(rf) for _ in range(4))
    du = torch.zeros(B, H, K, dtype=torch.float32, device=r.device)
    for t in reversed(range(T)):
        Sp = prev[t]
        dr[:, :, t] = (Sp * yf[:, :, t, None, :]).sum(-1)
        dk[:, :, t] = (G * vf[:, :, t, None, :]).sum(-1)
        dvs[:, :, t] = (G * kf[:, :, t, :, None]).sum(-2)
        dlw[:, :, t] = w[:, :, t] * (G * Sp).sum(-1)
        du = du + rf[:, :, t] * kf[:, :, t] * vdy[:, :, t]
        G = (G - d[:, :, t, :, None] * G) \
            + rf[:, :, t, :, None] * yf[:, :, t, None, :]
    dr = dr + uf * kf * vdy
    dk = dk + uf * rf * vdy
    dv = dvs + (rf * uf * kf).sum(-1, keepdim=True) * yf
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlw,
            _chain(du, 0), G)


def _deficit(y, d):
    """1 - (1 - y)(1 - d), the deficit of a decay product one token on: y +
    d - y d; exactly 1 once a factor is 0 (d = 1)."""
    return torch.where((d == 1) | (y == 1), 1.0, (y + d) - y * d)


def wkv6_bwd_chunk_ref(r, k, v, logw, u, s0, dy, dS):
    """The gradient kernel's algorithm in plain PyTorch, fp32: the six
    gradients of ``wkv6_bhtk`` at the upstream (dy, dS), either None for
    zero, in chunks of ``BWD_CHUNK`` tokens, the last padded
    with zero tokens (w = 1).

    The carry: S before every chunk, walked forward, S <- A S + (B k)^T V
    (B_t the decay after token t in the chunk, A the whole chunk's), and G
    after every chunk, walked back from dS, G <- A G + (A' r)^T dY (A'_t
    the decay before t); ds0 is G before the first. A is carried as its
    deficit y = 1 - A (``_deficit``) and applied as S - y S: A itself near
    1 would lose the low bits of 1 - A in fp32 alike at every chunk. Then every chunk at
    once from its S and G: M[b, a] = dy_b . v_a, S dy_t and G v_t; on
    each channel (i) a walk over a < b for every b: H_b = H_b - d_a H_b +
    k_a M[b, a] (kept before each a: H_b(a)), gamma_b likewise through G
    v_a, A'_b; (ii) a walk over b > t for every t with f = F[t, b] (the
    decay of the tokens between), adding f r_b times H_b(t) (pi), S dy_b
    (alpha) and M[b, t] (dk's pair term), and P[t, b] = sum_i k_t f r_b;
    f ends as B_t. Then dr = A' S dy_t + H + u k_t (v_t . dy_t), dk = B G
    v_t + dk's pair term + u r_t (v_t . dy_t), dlogw = w_t (A' (B X +
    alpha) + B gamma + pi) with X = rowsum(S G), dv = (B k) G + P dY +
    beta_t dy_t, du the chunks' sums over b and chunks. Every decay is a
    run of steps x - d x, d = -expm1(logw), one token at a time; dlogw's
    factor w = exp(logw)."""
    B, H, T, K = r.shape
    C = BWD_CHUNK
    n = bwd_chunks(T)
    pad = n * C - T

    def padded(x):
        return torch.nn.functional.pad(x.float(), (0, 0, 0, pad))
    rf, kf, vf, lw = (padded(x) for x in (r, k, v, logw))
    yf = torch.zeros_like(rf) if dy is None else padded(dy)
    rc, kc, vc, yc, dc, wc = (x.unflatten(2, (n, C)) for x in (
        rf, kf, vf, yf, -torch.expm1(lw), lw.exp()))     # (B,H,n,C,K)
    S = [s0.float()]
    for c in range(n - 1):
        x, kb = torch.ones_like(S[0][..., 0]), torch.empty_like(kc[:, :, c])
        y = torch.zeros_like(x)
        for t in reversed(range(C)):
            kb[:, :, t] = x * kc[:, :, c, t]
            x = x - dc[:, :, c, t] * x
            y = _deficit(y, dc[:, :, c, t])
        S.append((S[-1] - y[..., None] * S[-1])
                 + kb.transpose(-1, -2) @ vc[:, :, c])
    G = [torch.zeros_like(S[0]) if dS is None else dS.float()]
    for c in reversed(range(n)):
        x, ra = torch.ones_like(S[0][..., 0]), torch.empty_like(rc[:, :, c])
        y = torch.zeros_like(x)
        for t in range(C):
            ra[:, :, t] = x * rc[:, :, c, t]
            x = x - dc[:, :, c, t] * x
            y = _deficit(y, dc[:, :, c, t])
        G.append((G[-1] - y[..., None] * G[-1])
                 + ra.transpose(-1, -2) @ yc[:, :, c])
    ds0 = G.pop()
    S, G = torch.stack(S, 2), torch.stack(G[::-1], 2)  # (B,H,n,K,K)
    M = yc @ vc.transpose(-1, -2)                      # [b][a]
    SdY, GV = yc @ S.transpose(-1, -2), vc @ G.transpose(-1, -2)  # [t][i]
    lane = torch.arange(C, device=r.device)[:, None]
    hh, gam, ap = torch.zeros_like(rc), torch.zeros_like(rc), \
        torch.ones_like(rc)
    kept = []
    for a in range(C):
        m = lane > a
        kept.append(hh)
        da, ka = dc[:, :, :, a, None], kc[:, :, :, a, None]
        hh = torch.where(m, (hh - da * hh) + ka * M[..., a, None], hh)
        gam = torch.where(m, (gam - da * gam) + ka * GV[:, :, :, a, None],
                          gam)
        ap = torch.where(m, ap - da * ap, ap)
    kept = torch.stack(kept, 3)                        # [.., a][b][i]
    f = torch.ones_like(rc)
    pi, alpha, dki = (torch.zeros_like(rc) for _ in range(3))
    P = torch.zeros_like(M)                            # [t][b]
    for b in range(C):
        m = lane < b
        rfb = torch.where(m, f * rc[:, :, :, b, None], 0.0)
        pi = pi + rfb * kept[:, :, :, :, b]
        alpha = alpha + rfb * SdY[:, :, :, b, None]
        dki = dki + rfb * M[:, :, :, b, :, None]
        P[..., b] = (kc * rfb).sum(-1)
        f = torch.where(m, f - dc[:, :, :, b, None] * f, f)
    uc = u.float()[None, :, None, None, :]
    vdy = torch.diagonal(M, dim1=-2, dim2=-1)[..., None]
    X = (S * G).sum(-1)[:, :, :, None]
    dr = ap * SdY + hh + uc * kc * vdy
    dk = f * GV + dki + uc * rc * vdy
    dlw = wc * (ap * (f * X + alpha) + f * gam + pi)
    dv = (f * kc) @ G + P @ yc + (rc * uc * kc).sum(-1, keepdim=True) * yc
    du = _chain(_chain((rc * kc * vdy).sum(3), 2), 0)
    dr, dk, dv, dlw = (x.flatten(2, 3)[:, :, :T] for x in (dr, dk, dv, dlw))
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), dlw, du, ds0)


def wkv6_bwd_bhtk(r, k, v, logw, u, s0, dy, dS):
    """The six gradients (dr, dk, dv, dlogw, du, ds0) of ``wkv6_bhtk`` at
    the upstream dy (B,H,T,K) and dS (B,H,K,K), either None for zero; each
    in its input's dtype. CPU tensors: ``wkv6_ref``'s chunks recomputed
    under autograd (``_bwd_plain``); CUDA tensors: the gradient kernel, one
    launch counted under the ``backward`` form (three kernels: the carry of
    the chunks' boundary states, the chunk pass, du's sum over b and the
    chunks).""" 
    B, H, T, K = r.shape
    with cost.counted("wkvscan",
                      lambda: cost.wkv6_bwd_work(B, H, T, K,
                                                 r.element_size())):
        if r.device.type == "meta":
            return (torch.empty_like(r), torch.empty_like(k),
                    torch.empty_like(v), torch.empty_like(logw),
                    torch.empty_like(u), torch.empty_like(s0))
        if r.device.type == "cpu":
            return _bwd_plain(r, k, v, logw, u, s0, dy, dS)
        if r.device.type != "cuda":
            raise ValueError(f"wkv6_bwd_bhtk: no kernel for {r.device}")
        return _launch_bwd(r, k, v, logw, u, s0, dy, dS)


def _bwd_plain(r, k, v, logw, u, s0, dy, dS):
    """The CPU backward: the state at each chunk's start from one no-grad
    pass of ``_chunk_state``, then ``wkv6_ref``'s chunks recomputed under
    autograd one at a time, last to first, each given dy and the gradient
    of the state it hands on: the (B,H,C,C,K) pieces of one chunk are
    alive at a time, not those of the whole sequence."""
    starts = range(0, r.shape[2], GRAD_CHUNK)
    S = [s0.float()]
    with torch.no_grad():
        for t0 in starts[:-1]:
            _, kk, vv, lw = _chunk(r, k, v, logw, t0, GRAD_CHUNK)
            S.append(_chunk_state(kk, vv, lw, S[-1]))
    dS = torch.zeros_like(S[0]) if dS is None else dS.float()
    du = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    parts = []
    for t0, S0 in zip(reversed(starts), reversed(S)):
        leaves = [x.detach().requires_grad_() for x in
                  _chunk(r, k, v, logw, t0, GRAD_CHUNK)]
        ul = u.detach().float().requires_grad_()
        S0 = S0.detach().requires_grad_()
        with torch.enable_grad():
            y, S1 = _chunk_fwd(*leaves, ul[None, :, None, :], S0)
            outs, grads = [S1], [dS]
            if dy is not None:
                outs.append(y)
                grads.append(dy[:, :, t0:t0 + GRAD_CHUNK].float())
            *g, gu, dS = torch.autograd.grad(
                outs, leaves + [ul, S0], grads, allow_unused=True)
        parts.append([torch.zeros_like(x) if gx is None else gx
                      for x, gx in zip(leaves, g)])
        if gu is not None:          # u reaches only y: None without dy
            du = du + gu
    dr, dk, dv, dlogw = (torch.cat(p[::-1], dim=2).to(x.dtype)
                         for p, x in zip(zip(*parts), (r, k, v, logw)))
    return dr, dk, dv, dlogw, du.to(u.dtype), dS.to(s0.dtype)


def _launch_bwd(r, k, v, logw, u, s0, dy, dS):
    name = "wkv6_bhtk"
    f32 = (torch.float32,)
    dt = (r.dtype,)
    tensors = [r, k, v, logw, u, s0]
    dtypes = [(torch.float32, torch.bfloat16), dt, dt, f32, f32, f32]
    for x, d in ((dy, dt), (dS, f32)):
        if x is not None:
            tensors.append(x)
            dtypes.append(d)
    dev = _cuda.check_cuda_tensors(name, tensors, dtypes)
    B, H, T, K = r.shape
    if k.shape != r.shape or v.shape != r.shape or logw.shape != r.shape \
            or u.shape != (H, K) or s0.shape != (B, H, K, K) \
            or (dy is not None and dy.shape != r.shape) \
            or (dS is not None and dS.shape != s0.shape):
        raise ValueError(
            f"{name} backward: shapes r {tuple(r.shape)}, k "
            f"{tuple(k.shape)}, v {tuple(v.shape)}, logw "
            f"{tuple(logw.shape)}, u {tuple(u.shape)}, s0 "
            f"{tuple(s0.shape)}, dy {None if dy is None else tuple(dy.shape)}"
            f", dS {None if dS is None else tuple(dS.shape)}")
    if K not in HEAD_DIMS or T < 1:
        raise ValueError(f"{name} backward: head dim {K} not in {HEAD_DIMS} "
                         f"or T={T}")
    if any(x.data_ptr() % 16 for x in tensors if x.dim() > 2):
        raise ValueError(f"{name} backward: the kernel copies its inputs in "
                         f"16-byte pieces: r, k, v, logw, s0, dy and dS must "
                         f"start 16-byte aligned")
    f = dict(dtype=torch.float32, device=dev)
    dr, dk, dv = (torch.empty_like(r) for _ in range(3))
    dlogw, ds0 = torch.empty_like(logw), torch.empty_like(s0)
    if B * H == 0:
        return dr, dk, dv, dlogw, torch.zeros(H, K, **f), ds0
    n_ch = bwd_chunks(T)
    du = torch.empty(H, K, **f)
    # the states at the chunk boundaries: 2 x 4 K^2 / BWD_CHUNK bytes a
    # token and head (537 MB at 8 x 64 x 512 x 64), linear in T
    S_at = torch.empty(B, H, n_ch, K, K, **f)
    G_at = torch.empty(B, H, n_ch, K, K, **f)
    du_part = torch.empty(B, H, n_ch, K, **f)
    err = _cuda.lib().repro_wkv6_bwd(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(),
        u.data_ptr(), s0.data_ptr(), None if dy is None else dy.data_ptr(),
        None if dS is None else dS.data_ptr(), dr.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dlogw.data_ptr(), du.data_ptr(), ds0.data_ptr(),
        S_at.data_ptr(), G_at.data_ptr(), du_part.data_ptr(), B, H, T, K,
        _cuda.DTYPE_CODES[r.dtype], *_cuda.device_and_stream(dev))
    _cuda.check_launch(name, err, "backward")
    return dr, dk, dv, dlogw, du, ds0


class WKV6(torch.autograd.Function):
    """``wkv6_bhtk`` with a gradient: the forward is the wrapper as it is
    (one kernel launch on CUDA tensors), the backward ``wkv6_bwd_bhtk`` (on
    CUDA tensors one launch of the gradient kernel, on CPU tensors the
    plain chunked recompute). Autograd runs a CUDA backward on a thread of
    its own; its launch counts where the forward's did (``_cuda.resume``)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        y, s_T = wkv6_bhtk(r, k, v, logw, u, s0)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        ctx.running = _cuda.running()
        return y, s_T

    @staticmethod
    def backward(ctx, dy, dS):
        saved = ctx.saved_tensors
        if saved[0].device.type == "cuda":
            saved = [_cuda.fresh(x) for x in saved]
            dy = None if dy is None else _cuda.fresh(dy.to(saved[0].dtype))
            dS = None if dS is None else _cuda.fresh(dS.float())
        with _cuda.resume(ctx.running):
            return wkv6_bwd_bhtk(*saved, dy, dS)


def wkv6_grad(r, k, v, logw, u, s0):
    """``wkv6_bhtk``'s contract, differentiable in every input."""
    return WKV6.apply(r, k, v, logw, u, s0)
