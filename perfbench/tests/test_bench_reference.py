"""The plain reference against the port at tiny sizes on the CPU, in fp32:
the loss and every gradient of a training step, and prefill plus decode
through the caches against the reference's full forward."""

from __future__ import annotations

import pytest
import torch

from perfbench.lib import portcfg, weights
from perfbench.lib.manifest import Manifest
from perfbench.ref import lm as ref
from perfbench.tests import tiny

CONFIGS = ("rwkv6-3b", "smollm-360m")


def _setup(name, seed=5):
    from repro_torch.models import lm
    c = tiny.config(Manifest().config(name), "float32")
    cfg = portcfg.build(c)
    leaves = ref.leaves(c)
    with torch.device("cpu"):
        module = lm.LM(cfg)
    weights.fill(dict(module.named_parameters()), leaves, seed, "cpu")
    return c, cfg, leaves, module


@pytest.mark.parametrize("name", CONFIGS)
def test_loss_and_gradients_match_the_port(name):
    from repro_torch.models import lm
    from repro_torch.models.common import trainable
    c, cfg, leaves, module = _setup(name)
    params = trainable(module)
    g = torch.Generator().manual_seed(3)
    ids = torch.randint(0, c["vocab_size"], (2, 17), generator=g)
    batch = {"inputs": ids[:, :-1], "targets": ids[:, 1:]}
    loss, _ = lm.lm_loss(params, batch, cfg)
    named = dict(params.named_parameters())
    got = dict(zip(named, torch.autograd.grad(loss, list(named.values()))))
    W = weights.draw(leaves, 5, "cpu")
    for w in W.values():
        w.requires_grad_(True)
    want_loss = ref.loss(W, batch["inputs"], batch["targets"], c)
    want = dict(zip(W, torch.autograd.grad(want_loss, list(W.values()))))
    assert float(loss.detach()) == pytest.approx(float(want_loss.detach()),
                                                 rel=1e-5)
    scale = max(float(x.abs().max()) for x in want.values())
    for n in want:
        assert torch.allclose(got[n], want[n], atol=2e-5 * scale), n


@pytest.mark.parametrize("name", CONFIGS)
def test_prefill_and_decode_match_the_full_forward(name):
    from repro_torch.models import lm
    c, cfg, leaves, module = _setup(name)
    g = torch.Generator().manual_seed(4)
    ids = torch.randint(1, c["vocab_size"], (3, 14), generator=g)
    P, G = 10, 4
    with torch.inference_mode():
        logits, caches, t = lm.prefill(module, {"inputs": ids[:, :P]}, cfg,
                                       cache_len=P + G)
        got = [logits]
        for j in range(G - 1):
            logits, caches = lm.decode_step(module, caches,
                                            ids[:, P + j:P + j + 1], t, cfg)
            got.append(logits)
            t += 1
        want = ref.logits_at(weights.draw(leaves, 5, "cpu"),
                             ids[:, :P + G - 1], P - 1, c)
    got = torch.stack(got, dim=1)
    assert torch.allclose(got, want, atol=2e-5 * float(want.abs().max()))


def test_chunked_wkv_matches_a_token_serial_loop():
    g = torch.Generator().manual_seed(0)
    B, H, T, K = 2, 3, 37, 8
    r, k, v = (torch.randn(B, H, T, K, generator=g) for _ in range(3))
    logw = -torch.exp(torch.randn(B, H, T, K, generator=g))
    u = torch.randn(H, K, generator=g)
    S = torch.zeros(B, H, K, K, dtype=torch.float64)
    ys = []
    for t in range(T):
        rt, kt, vt = (x[:, :, t].double() for x in (r, k, v))
        kv = kt[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               S + u.double()[None, :, :, None] * kv))
        S = logw[:, :, t].double().exp()[..., None] * S + kv
    want = torch.stack(ys, dim=2)
    got = ref.wkv(r, k, v, logw, u, chunk=16)
    assert torch.allclose(got.double(), want, atol=1e-4, rtol=1e-4)
