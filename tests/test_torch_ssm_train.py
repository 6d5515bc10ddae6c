"""Training the two SSM archs, port vs the JAX reference on the CPU:
rwkv6-7b (``rwkv`` layers: the wkv6 scan) and recurrentgemma-2b (``rglru``
and ``attn_local`` layers: the RG-LRU scan and windowed MQA), reduced.

The three kernels on the path have autograd Functions: ``WKV6`` (the
kernel's forward; on the card its gradient kernel, on the CPU a plain
backward recomputed chunk by chunk), ``RGLRU`` (the kernel's forward, a
backward that runs the kernel again on the reversed recurrence) and
``FlashAttention``. On CPU tensors each forward is the plain version, as
the wrapper takes it; the gradient kernel's order of operations is
``tests/test_torch_wkv6_bwd.py``'s. Each gradient is held against
autograd straight through the plain version and against ``jax.vjp`` of the
reference's XLA form (``wkv6_chunked`` on logw away from the floor, where
the reference's prefix sums drift, else its token-serial oracle;
``rglru_scan``; ``_flash_xla``); then both archs' ``lm_loss`` and every
leaf's gradient against ``jax.grad`` with the per-layer remat off, full
and "dots", one ``make_train_step`` step against the reference's
``jax.jit(make_train_step)``, and the train CLI.

Weights come from the reference's own seeded ``init_lm`` through
``repro_torch.bridge``; inputs from numpy seeds; fp32 unless said.
Tolerances are relative to each gradient's max: 2e-5 in fp32 and 2e-2 in
bf16 (``tests/test_kernels.py``'s); losses 1e-5 relative; the train step's
parameters as ``tests/test_torch_optim.py`` holds them.

rwkv6-7b's model is held against the reference with its token-serial
oracle in place of ``wkv6_chunked``: a fifth of the reduced model's decay
channels sit at the logw floor, where the chunked scan's gradients drift
by up to 2.9e-3 of their max (ROADMAP Queue 3; ``test_reference_chunked_
scan_gradient_drifts_in_the_model`` pins it). Its gradients are held to
``RWKV_LM_REL``: on these weights two fp32 token-serial forms, the port's
kernel order (``wkv6_serial_ref``) and the reference's oracle, already
differ by 5.2e-5 of a leaf's max in the leaves upstream of r and k, and
the port's chunked form and the oracle by 7.3e-5."""

import contextlib
import dataclasses
import re
import threading
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.configs.registry import get_reduced as ref_get_reduced  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro.models.attention import _flash_xla  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.kernels import _cuda, ops, rglru, rwkv6  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import trainable  # noqa: E402
from repro_torch.optim import (OptConfig, init_opt_state,  # noqa: E402
                               make_train_step)

ARCHS = ("rwkv6-7b", "recurrentgemma-2b")
REL = {"float32": 2e-5, "bfloat16": 2e-2}
RWKV_LM_REL = 2e-4
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-4   # tests/test_torch_optim.py's: a fifth of lr 5e-4
# batch rows x tokens: rwkv past one 32-token chunk and not a multiple of
# it; recurrentgemma past its reduced window of 16
SHAPES = {"rwkv6-7b": (2, 40), "recurrentgemma-2b": (2, 24)}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the tensors are small, and parallel
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def np32(x):
    return np.asarray(x, np.float32)


def t(x):
    return torch.from_numpy(np.array(x, copy=True))


def close_rel(got, want, dtype="float32", what=""):
    """|got - want| <= REL[dtype] x max |want|, everywhere."""
    got, want = np32(got), np32(want)
    scale = max(float(np.abs(want).max()), 1e-12)
    err = float(np.abs(got - want).max())
    assert err <= REL[dtype] * scale, (what, err, scale)


# ---------------------------------------------------------------------------
# WKV6
# ---------------------------------------------------------------------------

def wkv_inputs(seed, B, H, T, K, floor=False):
    """r/k/v 0.5 N(0,1); logw -exp(N(0,1)) in fp32, or alternating -e^5
    and -1e-6 (the floor and the top ``rwkv_streams`` clips to); a random
    bonus u, a nonzero s0; the upstream gradients dy and dS."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)      # noqa: E731
    r, k, v = (0.5 * f(B, H, T, K) for _ in range(3))
    logw = -np.exp(f(B, H, T, K))
    if floor:
        logw[..., ::2] = -np.exp(5.0)
        logw[..., 1::2] = -1e-6
    return ((r, k, v, logw, 0.3 + 0.1 * f(H, K), 0.1 * f(B, H, K, K)),
            (f(B, H, T, K), f(B, H, K, K)))


def torch_grads(fn, args, dtype, dy, dS):
    """Gradients of (y, s_T) of ``fn`` at the upstream (dy, dS) (dS None:
    only y used), r/k/v in ``dtype``."""
    xs = [t(a).to(TORCH_DT[dtype]).requires_grad_() for a in args[:3]] + \
        [t(a).requires_grad_() for a in args[3:]]
    y, s = fn(*xs)
    outs, gs = [y], [t(dy).to(y.dtype)]
    if dS is not None:
        outs.append(s)
        gs.append(t(dS))
    return [g.float().numpy() for g in torch.autograd.grad(outs, xs, gs)]


@pytest.mark.parametrize("K,T", [(16, 64), (16, 45), (64, 64), (64, 33)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_grad_matches_autograd_through_the_plain_version(K, T, dtype):
    """``WKV6``'s six gradients, T a multiple of its 32-token chunk and not,
    against autograd through ``wkv6_ref`` (which the forward is on the
    CPU), with a nonzero s0 and with the state's gradient absent."""
    args, (dy, dS) = wkv_inputs(K + T, 2, 3, T, K)
    for dS_ in (dS, None):
        got = torch_grads(rwkv6.wkv6_grad, args, dtype, dy, dS_)
        want = torch_grads(rwkv6.wkv6_ref, args, dtype, dy, dS_)
        for name, a, b in zip(("r", "k", "v", "logw", "u", "s0"), got,
                              want):
            close_rel(a, b, dtype, f"d{name}")


def ref_vjp(fn, args, dy, dS):
    _, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return [np32(g) for g in vjp((jnp.asarray(dy), jnp.asarray(dS)))]


@pytest.mark.parametrize("K,T", [(16, 64), (16, 45), (64, 33)])
def test_wkv6_grad_matches_reference_chunked_vjp(K, T):
    """Against ``jax.vjp`` of the reference's ``wkv6_chunked`` (its training
    path: XLA, chunk 32 shrunk to a divisor of T), logw away from the
    floor."""
    args, (dy, dS) = wkv_inputs(K * T, 2, 3, T, K)
    got = torch_grads(rwkv6.wkv6_grad, args, "float32", dy, dS)
    want = ref_vjp(ref_ssm.wkv6_chunked, args, dy, dS)
    for name, a, b in zip(("r", "k", "v", "logw", "u", "s0"), got, want):
        close_rel(a, b, "float32", f"d{name}")


@pytest.mark.parametrize("K", [16, 64])
def test_wkv6_grad_at_the_logw_floor_matches_the_serial_oracle(K):
    """logw at -e^5 and -1e-6: against ``jax.vjp`` of the reference's
    token-serial oracle (``repro.kernels.ref.wkv6_ref``). The reference's
    chunked scan drifts there (ROADMAP Queue 3) and is left out."""
    args, (dy, dS) = wkv_inputs(K, 2, 2, 40, K, floor=True)
    got = torch_grads(rwkv6.wkv6_grad, args, "float32", dy, dS)
    want = ref_vjp(ref_oracles.wkv6_ref, args, dy, dS)
    for name, a, b in zip(("r", "k", "v", "logw", "u", "s0"), got, want):
        close_rel(a, b, "float32", f"d{name}")


# ---------------------------------------------------------------------------
# RGLRU
# ---------------------------------------------------------------------------

def rglru_case(seed, B, T, C):
    rng = np.random.default_rng(seed)
    a = (1 / (1 + np.exp(-rng.normal(size=(B, T, C))))).astype(np.float32)
    b, gh = (rng.normal(size=(B, T, C)).astype(np.float32) for _ in range(2))
    h0, gT = (rng.normal(size=(B, C)).astype(np.float32) for _ in range(2))
    return (a, b, h0), gh, gT


@pytest.mark.parametrize("T", [1, 7, 300])
@pytest.mark.parametrize("with_hT", [True, False])
def test_rglru_grad_matches_autograd_and_reference_vjp(T, with_hT):
    """``RGLRU``'s reverse scan, T = 1, short and past 256 without being a
    multiple of it, from a nonzero h0, with h_T's gradient given and absent
    (a train step drops h_T): against autograd through ``rglru_ref`` and
    ``jax.vjp`` of the reference's ``rglru_scan``."""
    args, gh, gT = rglru_case(T, 2, T, 8)
    grads = []
    for fn in (rglru.rglru_grad, rglru.rglru_ref):
        xs = [t(a).requires_grad_() for a in args]
        h, h_T = fn(*xs)
        outs, gs = ([h, h_T], [t(gh), t(gT)]) if with_hT else ([h], [t(gh)])
        grads.append([g.numpy() for g in torch.autograd.grad(outs, xs, gs)])
    _, vjp = jax.vjp(ref_ssm.rglru_scan, *map(jnp.asarray, args))
    want = vjp((jnp.asarray(gh), jnp.asarray(gT if with_hT
                                             else np.zeros_like(gT))))
    for name, a, b, c in zip(("a", "b", "h0"), *grads, want):
        close_rel(a, b, what=f"d{name} vs autograd")
        close_rel(a, c, what=f"d{name} vs rglru_scan")


# ---------------------------------------------------------------------------
# flash at reduced recurrentgemma's attention
# ---------------------------------------------------------------------------

def test_flash_grad_at_recurrentgemma_attention_matches_reference():
    """dq, dk, dv of ``flash_attention_grad`` at reduced recurrentgemma's
    ``attn_local`` (MQA 2/1, head dim 32, window 16 shorter than S 40, fp32)
    against ``jax.vjp`` of the reference's ``_flash_xla`` (key blocks of 8)
    and autograd through ``attention_ref``; the forward to 2e-5."""
    B, H, KV, S, hd, window = 2, 2, 1, 40, 32, 16
    rng = np.random.default_rng(5)
    q, g = (rng.normal(size=(B, H, S, hd)).astype(np.float32)
            for _ in range(2))
    k, v = (rng.normal(size=(B, KV, S, hd)).astype(np.float32)
            for _ in range(2))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.flash_attention_grad(tq, tk, tv, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(g))
    auto = torch.autograd.grad(fa.attention_ref(tq, tk, tv, window=window),
                               (tq, tk, tv), torch.tensor(g))
    pos = jnp.arange(S)

    def ref_out(q_, k_, v_):   # the reference's model layout (B,S,H,hd)
        o = _flash_xla(q_.transpose(0, 2, 1, 3), k_.transpose(0, 2, 1, 3),
                       v_.transpose(0, 2, 1, 3), pos, pos, True, window, 8)
        return o.transpose(0, 2, 1, 3)

    ref_o, vjp = jax.vjp(ref_out, *map(jnp.asarray, (q, k, v)))
    assert_allclose(out.detach().numpy(), np32(ref_o), atol=2e-5)
    for name, a, b, c in zip("qkv", got, auto, vjp(jnp.asarray(g))):
        close_rel(a.numpy(), c, what=f"d{name}")
        close_rel(a.numpy(), b.numpy(), what=f"d{name} vs autograd")


# ---------------------------------------------------------------------------
# routing and launch counting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernel", ["wkv6", "rglru"])
def test_ops_routes_only_training_calls_through_the_function(kernel,
                                                             monkeypatch):
    """``ops.wkv6`` / ``ops.rglru`` take their autograd Function only with
    grad on and an input that requires grad; serving calls (inference
    mode, no grad, or plain inputs) take the wrapper as before."""
    mod, name = ((rwkv6, "wkv6_grad") if kernel == "wkv6"
                 else (rglru, "rglru_grad"))
    used, inner = [], getattr(mod, name)
    monkeypatch.setattr(mod, name,
                        lambda *a: used.append(1) or inner(*a))
    if kernel == "wkv6":
        (r, k, v, logw, u, s0), _ = wkv_inputs(0, 1, 2, 5, 16)
        args = [t(x) for x in (r, k, v, logw, u, s0)]
    else:
        args = [t(x) for x in rglru_case(0, 1, 5, 4)[0]]
    fn = getattr(ops, kernel)
    fn(*args)
    with torch.inference_mode():
        fn(*args)
    with torch.no_grad():
        fn(args[0].requires_grad_(), *args[1:])
    assert used == []
    out = fn(*args)
    assert used == [1] and out[0].requires_grad and out[1].requires_grad


def test_a_backward_thread_counts_as_the_forward_thread():
    """A launch made on another thread inside ``_cuda.resume(state)`` counts
    in the tallies and namespace of the thread whose ``running()`` gave
    ``state``, as autograd's CUDA thread does in a Function's backward and a
    rematerialized layer's recompute; outside it, not."""
    saved = (dict(_cuda.launches), {k: dict(v) for k, v in
                                    _cuda.forms.items()})
    try:
        with _cuda.namespace("ns"), ops.tally() as counts:
            state = _cuda.running()

            def backward():
                _cuda.check_launch("rglru_btc", 0)
                with _cuda.resume(state):
                    _cuda.check_launch("rglru_btc", 0)
                    _cuda.check_launch("wkv6_bhtk", 0, "prefill")
                _cuda.check_launch("rglru_btc", 0)
            th = threading.Thread(target=backward)
            th.start()
            th.join()
        assert counts == {"rglru_btc": 1, "wkv6_bhtk": 1,
                          ("wkv6_bhtk", "prefill"): 1}
        assert _cuda.by_namespace["ns"]["rglru_btc"] == 1
        assert _cuda.running() == (None, ())
    finally:
        _cuda.launches.update(saved[0])
        for k, v in saved[1].items():
            _cuda.forms[k].update(v)
        _cuda.by_namespace.pop("ns", None)


# ---------------------------------------------------------------------------
# the two archs: lm_loss, remat, a train step, the CLI
# ---------------------------------------------------------------------------

_PARAMS = {}


def ref_params(arch):
    """The reference's seeded reduced weights, numpy leaves."""
    if arch not in _PARAMS:
        init = jax.jit(ref_lm.init_lm, static_argnums=(1,))
        _PARAMS[arch] = jax.tree.map(np.asarray, init(
            jax.random.PRNGKey(0), ref_get_reduced(arch)))
    return _PARAMS[arch]


def cfgs(arch, dtype="float32", **kw):
    """(reference cfg, port cfg) of the reduced config at ``dtype``."""
    return (dataclasses.replace(ref_get_reduced(arch), compute_dtype=dtype,
                                **kw),
            get_reduced(arch).replace(compute_dtype=dtype, **kw))


def make_batch(arch, seed):
    B, S = SHAPES[arch]
    rng = np.random.default_rng(seed)
    b = {"inputs": rng.integers(1, 256, size=(B, S)).astype(np.int32),
         "targets": rng.integers(1, 256, size=(B, S)).astype(np.int32)}
    b["targets"][0, :3] = -1
    return b


def serial_scan(r, k, v, logw, u, s0, chunk=None):
    """The reference's token-serial oracle in ``wkv6_chunked``'s place."""
    return ref_oracles.wkv6_ref(r, k, v, logw, u, s0)


def reference_scan(arch, chunked=False):
    """The reference as this file holds it: rwkv6-7b with ``serial_scan``
    in place of its chunked scan unless ``chunked``."""
    if arch != "rwkv6-7b" or chunked:
        return contextlib.nullcontext()
    return mock.patch.object(ref_ssm, "wkv6_chunked", serial_scan)


def lm_rel(arch, dtype="float32"):
    return RWKV_LM_REL if arch == "rwkv6-7b" and dtype == "float32" \
        else REL[dtype]


_REF_GRADS = {}


def ref_loss_and_grads(arch, dtype="float32", remat="none", chunked=False):
    """(loss, gradients as numpy leaves) of the reference's ``lm_loss``
    (``reference_scan``) on the seed-7 batch, once a key."""
    key = (arch, dtype, remat, chunked)
    if key not in _REF_GRADS:
        rcfg, _ = cfgs(arch, dtype, remat=remat)
        b = {k: jnp.asarray(v) for k, v in make_batch(arch, 7).items()}
        with reference_scan(arch, chunked):
            fn = jax.jit(jax.value_and_grad(
                lambda p: ref_lm.lm_loss(p, b, rcfg)[0]))
            loss, grads = fn(jax.tree.map(jnp.asarray, ref_params(arch)))
        _REF_GRADS[key] = float(loss), jax.tree.map(np32, grads)
    return _REF_GRADS[key]


def port_loss_and_grads(arch, dtype="float32", remat="none", calls=None):
    """(loss, gradients in the reference's layout) of the port's ``lm_loss``
    on the same weights and batch."""
    _, pcfg = cfgs(arch, dtype, remat=remat)
    params = trainable(bridge.lm_from_ref(ref_params(arch), pcfg))
    b = {k: t(v) for k, v in make_batch(arch, 7).items()}
    loss, _ = lm.lm_loss(params, b, pcfg)
    loss.backward()
    grads = bridge.ref_tree(params, leaf=lambda ts, stacked: (
        torch.stack([p.grad for p in ts]) if stacked else ts[0].grad)
        .numpy())
    return float(loss.detach()), grads


def tree_errors(got, want):
    """{leaf path: max |got - want| / max |want|}."""
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    flat_g = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    return {jax.tree_util.keystr(p): float(np.abs(np32(g) - w).max())
            / max(float(np.abs(w).max()), 1e-12)
            for (p, w), (_, g) in zip(flat_w, flat_g)}


def close_trees(got, want, rel):
    far = {k: e for k, e in tree_errors(got, want).items() if e > rel}
    assert far == {}, far


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("remat", ["none", "full"])
def test_lm_loss_and_every_gradient_match_reference(arch, remat):
    """The loss and every leaf's gradient (the LoRA mixes, ``u``, the group
    norm, the conv, the gates and ``lam`` included) against ``jax.grad``
    of the reference's ``lm_loss``, both sides at the same remat, which
    must not change a gradient."""
    want_loss, want = ref_loss_and_grads(arch, remat=remat)
    got_loss, got = port_loss_and_grads(arch, remat=remat)
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    close_trees(got, want, lm_rel(arch))
    zero = [jax.tree_util.keystr(p) for p, g in
            jax.tree_util.tree_flatten_with_path(got)[0]
            if not np.abs(g).max() > 0]
    assert zero == [], f"leaves the loss does not reach: {zero}"


@pytest.mark.parametrize("arch", ARCHS)
def test_dots_remat_equals_no_remat(arch):
    """remat "dots" (the matrix products' outputs kept, the rest
    recomputed) gives the loss and gradients of remat "none"."""
    want_loss, want = port_loss_and_grads(arch, remat="none")
    got_loss, got = port_loss_and_grads(arch, remat="dots")
    assert got_loss == pytest.approx(want_loss, rel=LOSS_RTOL)
    close_trees(got, want, REL["float32"])


def test_reference_chunked_scan_gradient_drifts_in_the_model():
    """Why rwkv6-7b's model is held against the reference's serial oracle:
    through its chunked scan the reference's gradients sit 1e-3 of a leaf's
    max or more from its own oracle's (reduced rwkv6-7b: a fifth of the
    decay channels at the logw floor), while the port's stay within
    ``RWKV_LM_REL`` of the oracle's. Same loss to 1e-5 either way."""
    arch = "rwkv6-7b"
    oracle_loss, oracle = ref_loss_and_grads(arch)
    chunked_loss, chunked = ref_loss_and_grads(arch, chunked=True)
    assert chunked_loss == pytest.approx(oracle_loss, rel=LOSS_RTOL)
    assert max(tree_errors(chunked, oracle).values()) > 1e-3
    assert max(tree_errors(port_loss_and_grads(arch)[1], oracle).values()) \
        <= RWKV_LM_REL


def test_recurrentgemma_bf16_loss_and_gradients_match_reference():
    """recurrentgemma-2b in bf16 compute (its residual stream stays fp32,
    ROADMAP Watch points), remat full: the loss and every gradient to 2e-2
    of the reference's."""
    arch = "recurrentgemma-2b"
    want_loss, want = ref_loss_and_grads(arch, "bfloat16", "full")
    got_loss, got = port_loss_and_grads(arch, "bfloat16", "full")
    assert got_loss == pytest.approx(want_loss, rel=REL["bfloat16"])
    close_trees(got, want, REL["bfloat16"])


@pytest.mark.parametrize("remat", ["none", "full"])
def test_remat_runs_each_kernel_again_in_the_backward(remat, monkeypatch):
    """The kernels' calls in one ``lm_loss`` forward and backward of each
    arch (the wrappers' CPU path, counted as the card counts launches):
    without remat one wkv6 call a ``rwkv`` layer, two rglru calls an
    ``rglru`` layer (forward, and the backward's ``rglru_bwd``: the
    gradient kernel's launch on the card) and one flash call an
    ``attn_local`` layer; with remat "full" each layer's forward runs again
    in the backward, one more call of each."""
    calls = {"wkv6": 0, "rglru": 0, "flash": 0}
    for mod, name, key in ((rwkv6, "wkv6_bhtk", "wkv6"),
                           (rglru, "rglru_btc", "rglru"),
                           (rglru, "rglru_bwd", "rglru"),
                           (fa, "flash_attention_bhsd", "flash")):
        def counted(*a, _inner=getattr(mod, name), _key=key, **kw):
            calls[_key] += 1
            return _inner(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    again = int(remat == "full")
    for arch in ARCHS:
        _, pcfg = cfgs(arch, remat=remat)
        kinds = pcfg.layer_kinds
        before = dict(calls)
        port_loss_and_grads(arch, remat=remat)
        assert {k: calls[k] - before[k] for k in calls} == {
            "wkv6": (1 + again) * kinds.count("rwkv"),
            "rglru": (2 + again) * kinds.count("rglru"),
            "flash": (1 + again) * kinds.count("attn_local")}, arch


@pytest.mark.parametrize("arch", ARCHS)
def test_one_train_step_matches_reference(arch):
    """One ``make_train_step`` step (remat full) against the reference's
    ``jax.jit(make_train_step)`` (``reference_scan``) on the same weights
    and batch: the loss, the gradient norm and the rate, and every
    parameter (``PARAM_ATOL``, all but 1e-4 of them within 1e-6; 1e-3 for
    rwkv6-7b, whose gradients are held ten times wider)."""
    rcfg, pcfg = cfgs(arch, remat="full")
    opt = OptConfig(lr=5e-4, warmup_steps=0, total_steps=10)
    b = make_batch(arch, 11)
    rp = jax.tree.map(jnp.asarray, ref_params(arch))
    with reference_scan(arch):
        rnew, _, rm = jax.jit(ref_optim.make_train_step(rcfg, opt))(
            rp, ref_optim.init_opt_state(rp, opt),
            {k: jnp.asarray(v) for k, v in b.items()})
    params = trainable(bridge.lm_from_ref(ref_params(arch), pcfg))
    params, state, pm = make_train_step(pcfg, opt)(
        params, init_opt_state(dict(params.named_parameters()), opt),
        {k: t(v) for k, v in b.items()})
    assert state["count"] == 1
    for k in ("loss", "grad_norm", "lr"):
        assert float(pm[k]) == pytest.approx(float(rm[k]), rel=LOSS_RTOL), k
    want = jax.tree.leaves(jax.tree.map(np.asarray, rnew))
    got = jax.tree.leaves(bridge.ref_tree(params))
    far = 0
    for a, g in zip(want, got):
        assert_allclose(g, a, atol=PARAM_ATOL)
        far += int((np.abs(g - a) > 1e-6).sum())
    # a first step moves a parameter by an undetermined share of lr where
    # its gradient is at rounding's scale: as many more of those as the
    # gradients' tolerance is wider (rwkv6-7b: 18 of 173,888 here)
    share = 1e-4 * lm_rel(arch) / REL["float32"]
    assert far <= share * sum(a.size for a in want)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_each_ssm_arch(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch <id> --reduced --device
    cpu`` (``main``) trains the arch the launcher refused before: finite
    losses, the checkpoint holds the arch's own leaves under the
    reference's keys, and ``--restore`` resumes from it."""
    args = ["--arch", arch, "--reduced", "--device", "cpu", "--batch", "2",
            "--seq", "24", "--ckpt-dir", str(tmp_path)]
    train_mod.main(args + ["--steps", "2"])
    train_mod.main(args + ["--steps", "3", "--restore"])
    out = capsys.readouterr().out
    assert "[train] restored step 2" in out
    losses = re.findall(r"\[train\] done\. loss (\S+) -> (\S+)", out)
    assert len(losses) == 2 and all(np.isfinite(float(v)) for pair in losses
                                    for v in pair)
    with np.load(next(tmp_path.rglob("*.npz"))) as z:
        names = set(z.files)
    leaves = (("0_rwkv/tm/u", "0_rwkv/tm/a_w", "0_rwkv/tm/gn_scale")
              if arch == "rwkv6-7b" else
              ("0_rglru/rec/lam", "0_rglru/rec/conv_w", "2_attn_local/attn/wq"))
    for leaf in leaves:
        assert any(n.endswith(f"segments/0/{leaf}") for n in names), \
            (leaf, sorted(names)[:8])
