"""The port's optimizer, schedules, train step and LM loss
(``repro_torch.optim``, ``models.lm.lm_loss``) on the CPU, against the JAX
reference.

Mirrors ``tests/test_substrate.py``'s optimizer tests (the AdamW quadratic,
clipping, schedule shapes, bf16 moments, microbatch accumulation: on the
reduced progen-s with the finetune loss, since smollm is not ported), then
holds the port to the reference on the same inputs: AdamW, clipping and the
schedules on numpy-made trees; one train step of ``FinetunePayload``'s
loss against ``jax.jit(make_train_step)`` on the same bridged weights; the
weight decay's ranks (the reference decays every stacked layer norm and
not the final norm: a reference fault, ROADMAP Queue 3); ``lm_loss`` with
and without CE chunks.

Tolerances: the AdamW / clipping / schedule parity 1e-6 relative (fp32
math on the same values); the train step 1e-5 relative on its metrics, and
``PARAM_ATOL`` on the parameters with all but 1e-4 of them within 1e-6: a
first AdamW step moves a parameter by lr g / (|g| + eps), so +-lr wherever
|g| >> eps, but by an undetermined fraction of lr where g is at fp32
roundoff's scale (a few of 1e5 here); microbatching atol 1e-5 / rtol 1e-4
(the reference test's own); ``lm_loss`` 1e-5."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as ref_optim  # noqa: E402
from repro.core.payload import FinetunePayload as RefFinetune  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.payload import FinetunePayload  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import trainable  # noqa: E402
from repro_torch.optim import (OptConfig, adamw_update,  # noqa: E402
                               clip_by_global_norm, global_norm,
                               init_opt_state, make_schedule,
                               make_train_step)
from test_torch_payload import payloads  # noqa: E402

PARAM_ATOL = 1e-4   # a fifth of the first step's lr (5e-4 at lr 1e-3)


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the tensors here are small, and
    parallel test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _tree(seed):
    """A flat tree of a matrix, a vector and a stacked (2, 3, 4) leaf."""
    rng = np.random.default_rng(seed)
    return {"w": rng.normal(size=(4, 3)).astype(np.float32),
            "b": rng.normal(size=(5,)).astype(np.float32),
            "s": rng.normal(size=(2, 3, 4)).astype(np.float32)}


def _t(tree):
    return {k: torch.tensor(v) for k, v in tree.items()}


def _batch(rng, rows, P, L):
    return {"backbones": rng.normal(size=(rows, P, 16)).astype(np.float32),
            "sequences": rng.integers(1, 20, size=(rows, L)).astype(np.int32),
            "weights": np.linspace(1.0, 0.2, rows).astype(np.float32)}


# ---------------------------------------------------------------------------
# test_substrate.py's optimizer tests, on the port
# ---------------------------------------------------------------------------

def test_adamw_minimizes_quadratic():
    opt = OptConfig(lr=0.1, warmup_steps=0, total_steps=200,
                    schedule="constant", weight_decay=0.0, clip_norm=1e9)
    params = {"w": torch.tensor([3.0, -2.0])}
    state = init_opt_state(params, opt)
    for _ in range(150):
        g = {"w": 2 * params["w"]}
        params, state = adamw_update(g, state, params, opt, 0.05)
    assert float(params["w"].abs().max()) < 0.05
    assert state["count"] == 150


def test_clip_by_global_norm():
    g = {"a": torch.full((4,), 10.0), "b": torch.full((3,), -10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert abs(float(global_norm(clipped)) - 1.0) < 1e-5
    assert float(norm) > 1.0
    small = {"a": torch.full((4,), 0.01), "b": torch.full((3,), 0.01)}
    c2, _ = clip_by_global_norm(small, 1.0)
    assert float((c2["a"] - small["a"]).abs().max()) < 1e-7


def test_schedule_shapes():
    opt = OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                    schedule="cosine", min_lr_frac=0.1)
    s = make_schedule(opt)
    assert s(0) < 1e-3 / 5
    assert abs(s(10) - 1e-3) < 1e-4
    assert s(100) <= 1.05e-4 + 1e-9


def test_bf16_moments():
    opt = OptConfig(moment_dtype="bfloat16")
    state = init_opt_state({"w": torch.ones((4, 4))}, opt)
    assert state["m"]["w"].dtype == torch.bfloat16
    assert state["v"]["w"].dtype == torch.bfloat16


def test_microbatch_grad_accumulation_matches_full_batch():
    """Four microbatches of 2 rows against one batch of 8: the same
    update (the finetune loss normalizes each microbatch by its own weight
    sum, as the reference's does; equal weights keep the two the same)."""
    _, port = payloads("float32")
    cfg = port.gen_cfg
    ft = FinetunePayload(port)
    rng = np.random.default_rng(0)
    b = _batch(rng, 8, cfg.frontend_seq, 6)
    b["weights"] = np.ones(8, np.float32)
    batch = {k: torch.tensor(v) for k, v in b.items()}
    out = []
    for n in (1, 4):
        params = trainable(port.param_store.current()[1])
        opt = OptConfig(microbatches=n, clip_norm=1e9)
        params, _, m = make_train_step(cfg, opt, loss_fn=ft.loss_fn)(
            params, init_opt_state(dict(params.named_parameters()), opt),
            batch)
        out.append(dict(params.named_parameters()))
    for name, p in out[0].items():
        np.testing.assert_allclose(out[1][name].detach().numpy(),
                                   p.detach().numpy(), atol=1e-5, rtol=1e-4)


# ---------------------------------------------------------------------------
# parity with the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_adamw_matches_reference(moment_dtype, weight_decay):
    """Three AdamW steps on the same tree and gradients: parameters and
    moments as the reference's (ranks default to the leaves' own)."""
    opt = OptConfig(weight_decay=weight_decay, moment_dtype=moment_dtype)
    rp = jax.tree.map(jnp.asarray, _tree(0))
    pp = _t(_tree(0))
    rs, ps = ref_optim.init_opt_state(rp, opt), init_opt_state(pp, opt)
    for i in range(3):
        g = _tree(10 + i)
        lr = 1e-2 * (i + 1)
        rp, rs = ref_optim.adamw_update(jax.tree.map(jnp.asarray, g), rs, rp,
                                        opt, lr)
        pp, ps = adamw_update(_t(g), ps, pp, opt, lr)
    assert ps["count"] == int(rs["count"]) == 3
    for k in pp:
        np.testing.assert_allclose(pp[k].numpy(), np.asarray(rp[k]),
                                   rtol=1e-6, atol=1e-7)
        for mom in ("m", "v"):
            np.testing.assert_allclose(
                ps[mom][k].float().numpy(),
                np.asarray(rs[mom][k], np.float32), rtol=1e-6, atol=1e-9)


def test_clip_matches_reference():
    for scale in (0.1, 10.0):
        g = {k: v * scale for k, v in _tree(3).items()}
        rc, rn = ref_optim.clip_by_global_norm(
            jax.tree.map(jnp.asarray, g), 1.0)
        pc, pn = clip_by_global_norm(_t(g), 1.0)
        assert float(pn) == pytest.approx(float(rn), rel=1e-6)
        for k in g:
            np.testing.assert_allclose(pc[k].numpy(), np.asarray(rc[k]),
                                       rtol=1e-6)


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_matches_reference(schedule):
    opt = OptConfig(lr=3e-4, warmup_steps=7, total_steps=50,
                    schedule=schedule, min_lr_frac=0.1)
    ref, port = ref_optim.make_schedule(opt), make_schedule(opt)
    for step in range(60):
        assert port(step) == pytest.approx(
            float(ref(jnp.asarray(step))), rel=1e-6)


def _step_inputs(seed=0, rows=4, L=12):
    ref, port = payloads("float32")
    rng = np.random.default_rng(seed)
    return ref, port, _batch(rng, rows, port.gen_cfg.frontend_seq, L)


def test_one_train_step_matches_reference():
    """One step of each package's ``FinetunePayload`` train step (the
    reference's is ``jax.jit(make_train_step)`` over its finetune loss) on
    the same bridged weights and batch: the same loss, mean
    log-likelihood, gradient norm and rate, and the same parameters."""
    ref, port, b = _step_inputs()
    rft, pft = RefFinetune(ref, lr=1e-3, steps=5), FinetunePayload(
        port, lr=1e-3, steps=5)
    rparams = ref.param_store.current()[1]
    rparams, _, rm = rft._train_step()(
        rparams, ref_optim.init_opt_state(rparams, rft.opt),
        {k: jnp.asarray(v) for k, v in b.items()})
    params = trainable(port.param_store.current()[1])
    params, state, pm = pft._train_step()(
        params, init_opt_state(dict(params.named_parameters()), pft.opt),
        {k: torch.tensor(v) for k, v in b.items()})
    assert state["count"] == 1
    for k in ("loss", "mean_ll", "grad_norm", "lr"):
        assert float(pm[k]) == pytest.approx(float(rm[k]), rel=1e-5), k
    want = jax.tree.leaves(jax.tree.map(np.asarray, rparams))
    got = jax.tree.leaves(bridge.ref_tree(params))
    far = 0
    for a, b_ in zip(want, got):
        np.testing.assert_allclose(b_, a, atol=PARAM_ATOL)
        far += int((np.abs(b_ - a) > 1e-6).sum())
    assert far <= 1e-4 * sum(a.size for a in want)


def test_weight_decay_ranks_follow_the_reference_layout():
    """With weight decay, ``make_train_step`` decays what the reference
    decays: every leaf of rank >= 2 in the reference's stacked layout, so a
    layer's norm scale (d,) here, (repeats, d) there, is decayed and the
    final norm is not. A zero-gradient step moves exactly those."""
    ref, port, _ = _step_inputs()
    cfg = port.gen_cfg
    opt = OptConfig(lr=1e-2, warmup_steps=0, weight_decay=0.5,
                    clip_norm=1e9)
    ranks = bridge.ref_ndims(port.gen_params)
    assert ranks["layers.0.norm1.scale"] == 2
    assert ranks["final_norm.scale"] == 1
    assert ranks["layers.1.attn.wq"] == 4 and ranks["struct_proj.w"] == 2

    def zero_loss(p, batch):
        loss = sum((w * 0).sum() for w in p.parameters())
        return loss, {"loss": loss}

    params = trainable(port.gen_params)
    params, _, _ = make_train_step(cfg, opt, loss_fn=zero_loss)(
        params, init_opt_state(dict(params.named_parameters()), opt), {})
    moved = {n for n, p in params.named_parameters()
             if not torch.equal(p.detach(),
                                dict(port.gen_params.named_parameters())[n])}
    assert moved == {n for n, r in ranks.items() if r >= 2}
    np.testing.assert_allclose(
        params.layers[0].norm1.scale.detach().numpy(),
        np.full(cfg.d_model, 1.0 - 1e-2 * 0.5, np.float32), rtol=1e-6)
    # the reference's own update on its stacked tree decays the same leaves
    rparams = ref.param_store.current()[1]
    zeros = jax.tree.map(jnp.zeros_like, rparams)
    rnew, _ = ref_optim.adamw_update(
        zeros, ref_optim.init_opt_state(rparams, opt), rparams, opt, 1e-2)
    got = bridge.ref_tree(params)
    for (kp, a), (_, b) in zip(
            jax.tree_util.tree_flatten_with_path(
                jax.tree.map(np.asarray, rnew))[0],
            jax.tree_util.tree_flatten_with_path(got)[0]):
        np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=str(kp))


def test_reference_decays_stacked_layer_norms_but_not_the_final_norm():
    """A reference fault (ROADMAP Queue 3): ``adamw_update``'s matrix rule
    (``p.ndim >= 2``, ``repro/optim/optimizers.py``) sees the layer norms'
    scales stacked as (repeats, d) and decays them, while the final norm's
    (d,) scale, the same kind of parameter, is left alone. At
    weight_decay 0.5 and lr 1e-2 a zero-gradient step takes every layer
    norm scale from 1 to 0.995 and leaves the final norm at 1. The port
    mirrors it (``bridge.ref_ndims``); the finetune payload uses
    weight_decay 0 and does not meet it."""
    ref, _, _ = _step_inputs()
    params = ref.param_store.current()[1]
    opt = OptConfig(weight_decay=0.5)
    new, _ = ref_optim.adamw_update(
        jax.tree.map(jnp.zeros_like, params),
        ref_optim.init_opt_state(params, opt), params, opt, 1e-2)
    seg = new["segments"][0]["0_attn"]
    for norm in ("norm1", "norm2"):
        assert seg[norm]["scale"].shape[0] == 2          # stacked, rank 2
        np.testing.assert_allclose(np.asarray(seg[norm]["scale"]), 0.995,
                                   rtol=1e-6)
    assert new["final_norm"]["scale"].ndim == 1
    np.testing.assert_array_equal(np.asarray(new["final_norm"]["scale"]),
                                  1.0)


# ---------------------------------------------------------------------------
# lm_loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ce_chunks", [1, 2])
def test_lm_loss_matches_reference(ce_chunks):
    """The LM loss of the reduced progen-s trunk (no patches) with some
    targets masked (-1), unchunked and in 2 CE chunks, as the reference's
    ``lm_loss``; the chunked form's gradients as the unchunked one's."""
    ref, port = payloads("float32")
    rcfg = dataclasses.replace(ref.gen_cfg, ce_chunks=ce_chunks)
    cfg = port.gen_cfg.replace(ce_chunks=ce_chunks)
    rng = np.random.default_rng(4)
    inputs = rng.integers(0, 20, size=(3, 8)).astype(np.int32)
    targets = rng.integers(0, 20, size=(3, 8)).astype(np.int32)
    targets[0, :3] = -1
    want, _ = ref_lm.lm_loss(ref.gen_params, {
        "inputs": jnp.asarray(inputs), "targets": jnp.asarray(targets)},
        rcfg)
    params = trainable(port.gen_params)
    batch = {"inputs": torch.tensor(inputs), "targets": torch.tensor(targets)}
    got, metrics = lm.lm_loss(params, batch, cfg)
    assert float(got.detach()) == pytest.approx(float(want), rel=1e-5)
    assert metrics["loss"] is got
    assert float(metrics["ce_loss"].detach()) == float(got.detach())
    assert {k: float(metrics[k]) for k in
            ("moe_lb_loss", "moe_z_loss", "moe_drop_frac")} == dict.fromkeys(
        ("moe_lb_loss", "moe_z_loss", "moe_drop_frac"), 0.0)
    trunk = [p for n, p in params.named_parameters()
             if not n.startswith("struct_proj")]        # no patches here
    grads = torch.autograd.grad(got, trunk)
    plain = trainable(port.gen_params)
    g1 = torch.autograd.grad(lm.lm_loss(plain, batch, port.gen_cfg)[0],
                             [p for n, p in plain.named_parameters()
                              if not n.startswith("struct_proj")])
    for a, b in zip(grads, g1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_lm_loss_refuses_moe():
    """A config with experts no longer raises: the MoE aux terms are
    ported. progen-s with ``moe_experts`` set but no expert layer gives
    the reference's loss and metrics (its segment scan pads the aux values
    with zeros), the three aux values zero. The name dates from before MoE
    was ported and is kept so the test's history stays one series; the
    MoE archs' own losses are ``tests/test_torch_moe.py``'s."""
    ref, port = payloads("float32")
    rcfg = dataclasses.replace(ref.gen_cfg, moe_experts=4, moe_top_k=2)
    cfg = port.gen_cfg.replace(moe_experts=4, moe_top_k=2)
    rng = np.random.default_rng(5)
    inputs = rng.integers(0, 20, size=(2, 6)).astype(np.int32)
    targets = rng.integers(0, 20, size=(2, 6)).astype(np.int32)
    want, wm = ref_lm.lm_loss(ref.gen_params, {
        "inputs": jnp.asarray(inputs), "targets": jnp.asarray(targets)},
        rcfg)
    got, gm = lm.lm_loss(port.gen_params, {
        "inputs": torch.tensor(inputs), "targets": torch.tensor(targets)},
        cfg)
    assert set(gm) == set(wm)
    for k in wm:
        assert float(gm[k]) == pytest.approx(float(wm[k]), rel=1e-5), k
    assert float(gm["moe_lb_loss"]) == float(gm["moe_z_loss"]) == \
        float(gm["moe_drop_frac"]) == 0.0
