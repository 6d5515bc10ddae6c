"""Plain reference of the benchmark's language models: RWKV-6 (Finch) and
the Llama-shaped decoder (SmolLM), in fp32 PyTorch with TF32 off, layer by
layer, with no kernel, cache or batching of the program's.

It reads its sizes from the configuration file alone and imports nothing of
the program. The equations are the port's stated ones (``models/ssm.py``,
``models/attention.py``, ``models/mlp.py``, ``optim/``), which follow the
published models with these departures, kept because the program has them:
RMS norms where Finch has LayerNorms (and no ``ln0``), the group norm's eps
equal to the layer norms', and the LoRA widths ``time_mix_extra_dim`` /
``time_decay_extra_dim`` as the configuration states them.

``precision="fp8"`` is the control: every matmul's two operands rounded to
float8 e4m3 with one scale a tensor (straight through in the backward), the
rest in fp32.

Leaves are ``(name, shape, kind, mean, std)``: ``kind`` is ``"mm"`` for a
matmul weight, ``"head"`` for the head (tied or not), ``"emb"`` for a
lookup table that is not also the head, ``"vec"`` otherwise; the benchmark
draws each as ``mean + std * z``. The draw keeps a deep stack well
conditioned, so that its gradients measure the arithmetic and not an
explosion: matrices at 1 / sqrt(fan-in), each residual branch's output
projection also at 1 / sqrt(2 x layers) (GPT-2's rule), an untied embedding
at 1 (a tied one at 0.02, Llama's initializer range, since it is also the
head), vectors near the port's initial values.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

E4M3_MAX = 448.0
WKV_CHUNK = 16          # tokens of the WKV's chunked form
ATTN_ROWS = 4           # rows of one attention block under autograd
CE_TOKENS = 8192        # tokens of one cross-entropy block


def padded_vocab(c):
    return 128 * math.ceil(c["vocab_size"] / 128)


def kind_of(c):
    if c["layer_type"] not in ("rwkv6", "llama"):
        raise ValueError(f"no reference for layer type {c['layer_type']!r}")
    return c["layer_type"]


def leaves(c):
    """Every leaf of the model, in the reference's order."""
    d, f, L, V = (c["hidden_size"], c["intermediate_size"],
                  c["num_hidden_layers"], padded_vocab(c))
    tied = c["tie_word_embeddings"]
    out = [("embedding.tok", (V, d), "head" if tied else "emb", 0.0,
            0.02 if tied else 1.0)]
    for i in range(L):
        p = f"layers.{i}."
        out += [(p + "norm1.scale", (d,), "vec", 1.0, 0.1),
                (p + "norm2.scale", (d,), "vec", 1.0, 0.1)]
        if kind_of(c) == "rwkv6":
            out += _rwkv_leaves(c, p + "tm.")
        else:
            out += _llama_leaves(c, p)
    out.append(("final_norm.scale", (d,), "vec", 1.0, 0.1))
    if not tied:
        out.append(("lm_head.w", (d, V), "head", 0.0, d ** -0.5))
    return out


def _branch(c):
    """The extra scale of a residual branch's output projection."""
    return (2 * c["num_hidden_layers"]) ** -0.5


def _rwkv_leaves(c, p):
    d, f = c["hidden_size"], c["intermediate_size"]
    mix, dec = c["time_mix_extra_dim"], c["time_decay_extra_dim"]
    out_std = _branch(c) * d ** -0.5
    out = [(p + "mu_x", (d,), "vec", 0.5, 0.1),
           (p + "u", (d,), "vec", 0.5, 0.1),
           (p + "w0", (d,), "vec", 1.0, 1.0),
           (p + "aw", (d, dec), "mm", 0.0, 0.1 * d ** -0.5),
           (p + "bw", (dec, d), "mm", 0.0, 0.1 * dec ** -0.5)]
    out += [(p + w, (d, d), "mm", 0.0, d ** -0.5)
            for w in ("wr", "wk", "wv", "wg", "wcr")]
    out += [(p + "wo", (d, d), "mm", 0.0, out_std),
            (p + "gn_scale", (d,), "vec", 1.0, 0.1),
            (p + "gn_bias", (d,), "vec", 0.0, 0.1),
            (p + "mu_ck", (d,), "vec", 0.5, 0.1),
            (p + "mu_cr", (d,), "vec", 0.5, 0.1),
            (p + "wck", (d, f), "mm", 0.0, d ** -0.5),
            (p + "wcv", (f, d), "mm", 0.0, _branch(c) * f ** -0.5)]
    for s in "rkvgw":
        out += [(p + f"mu_{s}", (d,), "vec", 0.5, 0.1),
                (p + f"a_{s}", (d, mix), "mm", 0.0, 0.1 * d ** -0.5),
                (p + f"b_{s}", (mix, d), "mm", 0.0, 0.1 * mix ** -0.5)]
    return out


def _llama_leaves(c, p):
    d, f = c["hidden_size"], c["intermediate_size"]
    H, KV = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c["head_dim"]
    return [(p + "attn.wq", (d, H, hd), "mm", 0.0, d ** -0.5),
            (p + "attn.wk", (d, KV, hd), "mm", 0.0, d ** -0.5),
            (p + "attn.wv", (d, KV, hd), "mm", 0.0, d ** -0.5),
            (p + "attn.wo", (H, hd, d), "mm", 0.0,
             _branch(c) * (H * hd) ** -0.5),
            (p + "mlp.wi", (d, f), "mm", 0.0, d ** -0.5),
            (p + "mlp.wg", (d, f), "mm", 0.0, d ** -0.5),
            (p + "mlp.wo", (f, d), "mm", 0.0, _branch(c) * f ** -0.5)]


def mixers(c):
    """The sequence mixing of every layer, for the model-FLOP count."""
    if kind_of(c) == "rwkv6":
        m = {"kind": "wkv", "heads": c["hidden_size"] // c["head_size"],
             "head_dim": c["head_size"]}
    else:
        m = {"kind": "attention", "heads": c["num_attention_heads"],
             "head_dim": c["head_dim"]}
    return [m] * c["num_hidden_layers"]


def decayed(name, shape):
    """Whether AdamW's weight decay applies: the port stacks every layer's
    leaves on a leading axis, as the JAX package does, so each layer leaf
    counts as a matrix; a top-level leaf is one at rank 2 or more."""
    return name.startswith("layers.") or len(shape) >= 2


# ---------------------------------------------------------------------------
# pieces
# ---------------------------------------------------------------------------


class _Round8(torch.autograd.Function):
    """x rounded to float8 e4m3 with one scale for the tensor; the gradient
    passes straight through."""

    @staticmethod
    def forward(ctx, x):
        s = x.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
        return (x / s).to(torch.float8_e4m3fn).to(x.dtype) * s

    @staticmethod
    def backward(ctx, g):
        return g


def mm(a, w, precision):
    """a (..., i) @ w (i, o), in fp32 or with fp8 operands."""
    if precision == "fp8":
        a, w = _Round8.apply(a), _Round8.apply(w)
    elif precision != "fp32":
        raise ValueError(f"precision {precision!r}")
    return a @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def shifted(x):
    """x moved one token later along the sequence, zeros first."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv(r, k, v, logw, u, chunk=WKV_CHUNK):
    """y_t = r_t (S_{t-1} + diag(u) k_t v_t^T), S_t = diag(exp(logw_t))
    S_{t-1} + k_t v_t^T from S_0 = 0, on fp32 (B,H,T,K) inputs. Chunks of
    ``chunk`` tokens; every decay exponent is the sum of logw over its own
    tokens, never a difference of prefix sums."""
    B, H, T, K = r.shape
    S = r.new_zeros(B, H, K, K)
    ys = []
    for t0 in range(0, T, chunk):
        rr, kk, vv, lw = (x[:, :, t0:t0 + chunk] for x in (r, k, v, logw))
        C = rr.shape[2]
        before = torch.ones(C, C, dtype=torch.bool, device=r.device).tril(-1)
        into = torch.cat([torch.zeros_like(lw[:, :, :1]),
                          lw.cumsum(2)[:, :, :-1]], dim=2)     # sum over i < t
        y = (rr * into.exp()) @ S
        # tail[t, j] = sum of logw_i over j <= i < t
        m = lw[:, :, None] * before[:, :, None]                 # (B,H,t,i,K)
        tail = m.flip(3).cumsum(3).flip(3)
        between = torch.cat([tail[:, :, :, 1:],
                             torch.zeros_like(tail[:, :, :, :1])], dim=3)
        att = (rr[:, :, :, None] * kk[:, :, None] * between.exp()).sum(-1)
        att = att * before
        bonus = (rr * u[None, :, None] * kk).sum(-1, keepdim=True)
        ys.append(y + att @ vv + bonus * vv)
        after = lw.flip(2).cumsum(2).flip(2)                     # i >= j
        after = torch.cat([after[:, :, 1:], torch.zeros_like(lw[:, :, :1])],
                          dim=2)
        S = S * lw.sum(2)[..., None].exp() \
            + (kk * after.exp()).transpose(-1, -2) @ vv
    return torch.cat(ys, dim=2)


def rwkv_layer(W, p, x, c, precision):
    """One Finch layer (time mix, then channel mix) on fp32 x (B,T,d)."""
    eps, K = c["layer_norm_epsilon"], c["head_size"]
    B, T, d = x.shape
    H = d // K
    h = rms_norm(x, W[p + "norm1.scale"], eps)
    t = p + "tm."
    dx = shifted(h) - h
    xx = h + dx * W[t + "mu_x"]

    def lerp(s):
        lora = mm(torch.tanh(mm(xx, W[t + f"a_{s}"], precision)),
                  W[t + f"b_{s}"], precision)
        return h + dx * (W[t + f"mu_{s}"] + lora)
    r, k, v, g = (mm(lerp(s), W[t + w], precision)
                  for s, w in zip("rkvg", ("wr", "wk", "wv", "wg")))
    g = F.silu(g)
    decay = mm(torch.tanh(mm(lerp("w"), W[t + "aw"], precision)),
               W[t + "bw"], precision)
    logw = (-torch.exp(torch.clamp(W[t + "w0"] + decay, -12.0, 5.0))
            ).clamp(max=-1e-6)

    def heads(z):
        return z.reshape(B, T, H, K).transpose(1, 2)
    y = wkv(heads(r), heads(k), heads(v), heads(logw),
            W[t + "u"].reshape(H, K)).transpose(1, 2)           # (B,T,H,K)
    mu = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = ((y - mu) * torch.rsqrt(var + eps)).reshape(B, T, d)
    y = y * W[t + "gn_scale"] + W[t + "gn_bias"]
    x = x + mm(y * g, W[t + "wo"], precision)
    h = rms_norm(x, W[p + "norm2.scale"], eps)
    dx = shifted(h) - h
    kk = torch.relu(mm(h + dx * W[t + "mu_ck"], W[t + "wck"], precision))
    kv = mm(kk.square(), W[t + "wcv"], precision)
    rr = torch.sigmoid(mm(h + dx * W[t + "mu_cr"], W[t + "wcr"], precision))
    return x + rr * kv


def rope(x, theta):
    """Llama's rotation of the two halves of each head, x (B,S,H,hd),
    positions 0..S-1."""
    S, hd = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    ang = (torch.arange(S, dtype=torch.float64)[:, None] * inv).float()
    ang = ang.to(x.device)[None, :, None]
    sin, cos = ang.sin(), ang.cos()
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v):
    """Causal softmax attention of q (b,S,H,hd) over k/v (b,S,KV,hd)."""
    H, KV, hd = q.shape[2], k.shape[2], q.shape[3]
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(hd)
    S = q.shape[1]
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def llama_layer(W, p, x, c, precision):
    """One pre-norm attention + SwiGLU layer on fp32 x (B,S,d)."""
    eps = c["rms_norm_eps"]
    B, S, d = x.shape
    H, KV, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                 c["head_dim"])
    h = rms_norm(x, W[p + "norm1.scale"], eps)
    a = p + "attn."
    q = mm(h, W[a + "wq"].reshape(d, H * hd), precision).reshape(B, S, H, hd)
    k = mm(h, W[a + "wk"].reshape(d, KV * hd), precision) \
        .reshape(B, S, KV, hd)
    v = mm(h, W[a + "wv"].reshape(d, KV * hd), precision) \
        .reshape(B, S, KV, hd)
    q, k = rope(q, c["rope_theta"]), rope(k, c["rope_theta"])
    if torch.is_grad_enabled():
        o = torch.cat([torch.utils.checkpoint.checkpoint(
            _attend, q[i:i + ATTN_ROWS], k[i:i + ATTN_ROWS],
            v[i:i + ATTN_ROWS], use_reentrant=False)
            for i in range(0, B, ATTN_ROWS)])
    else:
        o = torch.cat([_attend(q[i:i + 1], k[i:i + 1], v[i:i + 1])
                       for i in range(B)])
    x = x + mm(o.reshape(B, S, H * hd), W[a + "wo"].reshape(H * hd, d),
               precision)
    h = rms_norm(x, W[p + "norm2.scale"], eps)
    m = p + "mlp."
    gate = F.silu(mm(h, W[m + "wg"], precision)) * mm(h, W[m + "wi"],
                                                        precision)
    return x + mm(gate, W[m + "wo"], precision)


def _norm_eps(c):
    return c["layer_norm_epsilon"] if kind_of(c) == "rwkv6" \
        else c["rms_norm_eps"]


def hidden(W, ids, c, precision="fp32", remat=False):
    """The final hidden states (B,T,d) of tokens ``ids`` (B,T), fp32;
    ``remat`` recomputes each layer in the backward."""
    layer = rwkv_layer if kind_of(c) == "rwkv6" else llama_layer
    x = W["embedding.tok"][ids.long()]
    for i in range(c["num_hidden_layers"]):
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                layer, W, f"layers.{i}.", x, c, precision,
                use_reentrant=False)
        else:
            x = layer(W, f"layers.{i}.", x, c, precision)
    return x


def head(W, x, c, precision="fp32"):
    """Final norm and LM head: logits over the padded vocabulary."""
    x = rms_norm(x, W["final_norm.scale"], _norm_eps(c))
    w = W["embedding.tok"].t() if c["tie_word_embeddings"] \
        else W["lm_head.w"]
    return mm(x, w, precision)


def _ce_block(W, x, targets, c, precision):
    logits = head(W, x, c, precision)
    return F.cross_entropy(logits, targets.long(), reduction="sum")


def loss(W, inputs, targets, c, precision="fp32"):
    """Mean next-token cross-entropy over every target (all valid here)."""
    x = hidden(W, inputs, c, precision, remat=True).reshape(
        -1, c["hidden_size"])
    t = targets.reshape(-1)
    total = 0.0
    for i in range(0, x.shape[0], CE_TOKENS):
        total = total + torch.utils.checkpoint.checkpoint(
            _ce_block, W, x[i:i + CE_TOKENS], t[i:i + CE_TOKENS], c,
            precision, use_reentrant=False)
    return total / t.numel()


def follow_training(W, c, opt, batches, steps, precision="fp32"):
    """Follow ``steps`` AdamW steps from the leaves ``W`` (fp32 tensors,
    updated in place) on ``batches(i)`` -> (inputs, targets), as the
    configuration's optimizer states them: the global norm clipped to
    ``clip_norm``, linear warm-up of the rate, bias-corrected moments,
    decoupled weight decay on ``decayed`` leaves. Returns the losses, the
    first step's global norm before clipping, and the first step's
    gradient as the optimizer takes it, each leaf's norm."""
    for w in W.values():
        w.requires_grad_(True)
    m = {n: torch.zeros_like(w) for n, w in W.items()}
    v = {n: torch.zeros_like(w) for n, w in W.items()}
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    losses, first = [], {}
    gnorm0 = None
    for step in range(steps):
        if step >= opt["warmup_steps"]:
            raise ValueError("the reference follows warm-up steps only")
        inputs, targets = batches(step)
        value = loss(W, inputs, targets, c, precision)
        grads = torch.autograd.grad(value, list(W.values()))
        losses.append(float(value.detach()))
        with torch.no_grad():
            gn = torch.stack([g.double().square().sum()
                              for g in grads]).sum().sqrt()
            scale = min(1.0, opt["clip_norm"] / max(float(gn), 1e-9))
            lr = opt["lr"] * (step + 1) / opt["warmup_steps"]
            c1, c2 = 1 - b1 ** (step + 1), 1 - b2 ** (step + 1)
            for (n, w), g in zip(W.items(), grads):
                g = g * scale
                if step == 0:
                    first[n] = float(g.double().norm())
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (m[n] / c1) / (torch.sqrt(v[n] / c2) + eps)
                if decayed(n, w.shape):
                    upd = upd + wd * w
                w.sub_(lr * upd)
            if step == 0:
                gnorm0 = float(gn)
        del grads
    for w in W.values():
        w.requires_grad_(False)
    return {"loss": losses, "gnorm": gnorm0, "grad": first}


@torch.no_grad()
def logits_at(W, ids, first, c, precision="fp32"):
    """Logits (B, T - first, V) at positions first..T-1 of a full forward
    over ``ids`` (B,T) from a fresh state."""
    x = hidden(W, ids, c, precision)
    return head(W, x[:, first:], c, precision)
