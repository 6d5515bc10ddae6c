"""PyTorch port vs the JAX reference: the dense sampler (``progen_sample``),
the payload's solo and dense task forms, and the coalesce rules, on the CPU.

Token identity is checked in fp32, by handing the port the Gumbel noise the
reference draws: ``jax.random.categorical(k, x)`` is exactly ``argmax(x +
jax.random.gumbel(k, x.shape))``, and the reference's ``progen_sample``
splits its key once for the first token and then into ``length - 1`` step
keys, each drawing over the whole (B·n, V) logits. Log-likelihoods agree
to 1e-4 (sums of up to 8 fp32 log-probs), metrics to 1e-5 in fp32;
teacher-forced log-probs in bf16 to 2e-2."""

import itertools
from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.core import payload as ref_payload  # noqa: E402
from repro.core import pipeline as ref_pipeline  # noqa: E402
from repro.models import protein as ref_prot  # noqa: E402
from repro_torch.core import payload as port_payload  # noqa: E402
from repro_torch.core import pipeline as port_pipeline  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import protein as prot  # noqa: E402
from test_torch_payload import CPU, VP, _RefMesh, payloads  # noqa: E402

N, L = 3, 6                  # candidates, tokens


def schedule_noise(key, rows, length):
    """The Gumbel draws the reference's ``progen_sample`` makes with
    ``key`` over (rows, VP) logits, as (rows, length, VP)."""
    key, k0 = jax.random.split(jnp.asarray(key, jnp.uint32))
    first = jax.random.gumbel(k0, (rows, VP))
    rest = jax.vmap(lambda k: jax.random.gumbel(k, (rows, VP)))(
        jax.random.split(key, length - 1))
    return np.concatenate([np.asarray(first)[:, None],
                           np.asarray(rest).transpose(1, 0, 2)], axis=1)


def row_key(seed):
    """The per-row key the reference's batched kinds pack from a seed."""
    s = np.uint64(seed)
    return np.asarray([s >> np.uint64(32), s & np.uint64(0xFFFFFFFF)],
                      np.uint32)


def backbones(rng, R, P=8):
    return rng.normal(size=(R, P, 16)).astype(np.float32)


# ---------------------------------------------------------------------------
# the dense sampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,token_lps", [(1, False), (2, True)])
def test_progen_sample_matches_reference(B, token_lps):
    ref, port = payloads("float32")
    bb = backbones(np.random.default_rng(B), B)
    key = jax.random.PRNGKey(11 + B)
    fn = jax.jit(partial(ref_prot.progen_sample, n=N, length=L,
                         cfg=ref.gen_cfg, temperature=0.8,
                         return_token_lps=token_lps))
    want_s, want_lp = fn(ref.gen_params, jnp.asarray(bb), key=key)
    with torch.inference_mode():
        got_s, got_lp = prot.progen_sample(
            port.gen_params, torch.from_numpy(bb), N, L, port.gen_cfg,
            noise=schedule_noise(key, B * N, L), temperature=0.8,
            return_token_lps=token_lps)
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_lp.shape == want_lp.shape
    assert_allclose(got_lp.numpy(), np.asarray(want_lp), atol=1e-4, rtol=0)


def test_progen_sample_seeded_rows_are_independent():
    """Seeded draws: a row's tokens depend on its own seed, not on the other
    rows of the call."""
    _, port = payloads("float32")
    bb = torch.from_numpy(backbones(np.random.default_rng(4), 3))
    with torch.inference_mode():
        s3, l3 = prot.progen_sample(port.gen_params, bb, N, L, port.gen_cfg,
                                    seeds=[7, 8, 9])
        s1, l1 = prot.progen_sample(port.gen_params, bb[1:2], N, L,
                                    port.gen_cfg, seeds=[8])
    np.testing.assert_array_equal(s3[1:2].numpy(), s1.numpy())
    assert_allclose(l3[1:2].numpy(), l1.numpy(), atol=1e-5)
    assert ((s3 >= 0) & (s3 < port.gen_cfg.vocab_size)).all()


def test_backbone_longer_than_frontend_seq_raises():
    """A backbone longer than ``frontend_seq`` makes a prompt longer than
    the dense caches' ``frontend_seq + 1 + length`` slots allow. The port
    raises rather than write past the cache's end (the reference's
    behaviour there is logged in ROADMAP Queue 3; the payload truncates
    backbones, so no task reaches this)."""
    _, port = payloads("float32")
    cfg, params = port.gen_cfg, port.gen_params
    bb = backbones(np.random.default_rng(1), 1, cfg.frontend_seq + 4)
    with pytest.raises(ValueError, match="frontend_seq"):
        prot.progen_sample(params, torch.from_numpy(bb), N, L, cfg,
                           seeds=[1])


def test_attn_dense_cache_prefill_decode_matches_full_forward():
    """Serving invariant on reduced progen-s (fp32): prefill + token-by-token
    decode over the ``attn`` layers' dense caches reproduces the
    full-sequence logits (the port's mirror of test_models.py's)."""
    _, port = payloads("float32")
    cfg, params = port.gen_cfg, port.gen_params
    rng = np.random.default_rng(5)
    B, S, S0 = 2, 12, 8
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, size=(B, S)))
    patches = prot.encode_structure(
        params, torch.from_numpy(backbones(rng, B, cfg.frontend_seq)), cfg)
    with torch.inference_mode():
        full = lm.lm_logits(params, {"inputs": toks, "patches": patches}, cfg)
        logits, caches, t = lm.prefill(
            params, {"inputs": toks[:, :S0], "patches": patches}, cfg,
            cache_len=cfg.frontend_seq + S)
        errs = [float((logits - full[:, S0 - 1]).abs().max())]
        for i in range(S0, S):
            logits, caches = lm.decode_step(params, caches, toks[:, i:i + 1],
                                            t, cfg)
            t += 1
            errs.append(float((logits - full[:, i]).abs().max()))
    assert max(errs) < 5e-4, errs


# ---------------------------------------------------------------------------
# payload forms
# ---------------------------------------------------------------------------

def test_generate_matches_reference():
    ref, port = payloads("float32")
    bb = backbones(np.random.default_rng(6), 1)[0]
    payload = {"backbone": bb, "n": N, "length": L, "seed": 41,
               "temperature": 1.0}
    want = ref.generate(_RefMesh(), payload)
    key = ref_payload._fold_in_keys(41, 1)[0]
    got = port.generate(CPU, dict(payload, noise=schedule_noise(key, N, L)))
    np.testing.assert_array_equal(got["seqs"], want["seqs"])
    assert got["seqs"].dtype == np.int32 and got["lls"].dtype == np.float32
    assert_allclose(got["lls"], want["lls"], atol=1e-4, rtol=0)
    assert got["gen_version"] == want["gen_version"] == 0


@pytest.mark.parametrize("masked", [False, True])
def test_predict_matches_reference(masked):
    ref, port = payloads("float32")
    rng = np.random.default_rng(7)
    payload = {"sequence": rng.integers(1, 21, size=13).astype(np.int32),
               "target": rng.normal(size=16).astype(np.float32),
               "receptor_len": 9}
    if masked:
        payload["seq_len"] = 13
    want = ref.predict(_RefMesh(), payload)
    got = port.predict(CPU, payload)
    assert set(got) == set(want) == {"plddt", "ptm", "pae"}
    assert_allclose([got[k] for k in want], [want[k] for k in want],
                    atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("masked", [False, True])
def test_generate_batch_dense_matches_reference(masked):
    ref, port = payloads("float32")
    seeds = [3, 12, 40]
    payload = {"backbones": backbones(np.random.default_rng(8), 3),
               "seeds": seeds, "n": N, "length": L, "temperature": 1.0}
    if masked:
        payload["row_lens"] = [L, L - 2, L - 1]
    want = ref.generate_batch(_RefMesh(), payload)
    noise = np.stack([schedule_noise(row_key(s), N, L) for s in seeds])
    got = port.generate_batch(CPU, dict(payload, noise=noise))
    assert got["batch"] == want["batch"]
    assert got["gen_version"] == want["gen_version"]
    assert len(got["rows"]) == len(want["rows"]) == 3
    for (gs, gl), (ws, wl) in zip(got["rows"], want["rows"]):
        assert gs.dtype == np.int32 and gl.dtype == np.float32
        np.testing.assert_array_equal(gs, ws)
        assert_allclose(gl, wl, atol=1e-4, rtol=0)


def test_two_device_submesh_splits_like_the_reference():
    """A sub-mesh of two devices (the same CPU device twice, in both
    packages): ``generate`` splits its candidates 2 + 1, device i drawing
    from ``fold_in(seed, i)``, and ``generate_batch`` splits its bucket of
    4 rows 2 + 2, each row on its own key, as the reference does."""
    from repro_torch.runtime.allocator import SubMesh
    ref, port = payloads("float32")
    ref_mesh, port_mesh = _RefMesh(), SubMesh([torch.device("cpu")] * 2)
    ref_mesh.devices = np.asarray(jax.devices()[:1] * 2)
    bb = backbones(np.random.default_rng(15), 3)
    payload = {"backbone": bb[0], "n": N, "length": L, "seed": 5}
    want = ref.generate(ref_mesh, payload)
    k0, k1 = ref_payload._fold_in_keys(5, 2)
    noise = np.concatenate([schedule_noise(k0, 2, L),
                            schedule_noise(k1, 1, L)])
    got = port.generate(port_mesh, dict(payload, noise=noise))
    np.testing.assert_array_equal(got["seqs"], want["seqs"])
    assert_allclose(got["lls"], want["lls"], atol=1e-4, rtol=0)
    seeds = [4, 8, 15]
    payload = {"backbones": bb, "seeds": seeds, "n": N, "length": L}
    want = ref.generate_batch(ref_mesh, payload)
    got = port.generate_batch(port_mesh, dict(payload, noise=np.stack(
        [schedule_noise(row_key(s), N, L) for s in seeds])))
    assert got["batch"] == want["batch"] and got["batch"]["devices"] == 2
    for (gs, gl), (ws, wl) in zip(got["rows"], want["rows"]):
        np.testing.assert_array_equal(gs, ws)
        assert_allclose(gl, wl, atol=1e-4, rtol=0)


def test_generate_batch_composition_independence():
    """A row of the seeded dense generate_batch samples the same tokens
    whichever rows share its dispatch (and its bucket's pad rows)."""
    _, port = payloads("float32")
    bbs = backbones(np.random.default_rng(9), 3)
    base = {"n": N, "length": L, "temperature": 1.0}
    alone = port.generate_batch(CPU, dict(base, backbones=bbs[1:2],
                                          seeds=[77]))["rows"][0]
    fused = port.generate_batch(CPU, dict(base, backbones=bbs,
                                          seeds=[5, 77, 6]))["rows"][1]
    np.testing.assert_array_equal(fused[0], alone[0])
    assert_allclose(fused[1], alone[1], atol=1e-5)


def test_backbone_batch_matches_reference():
    ref, port = payloads("float32")
    rng = np.random.default_rng(10)
    seeds = [2, 9, 31]
    payload = {"bases": rng.normal(size=(3, 10, 16)).astype(np.float32),
               "targets": rng.normal(size=(3, 16)).astype(np.float32),
               "seeds": seeds, "m": 4, "sigma": 0.2}
    want = ref.backbone_batch(_RefMesh(), payload)
    noise = np.stack([np.asarray(jax.random.normal(
        jnp.asarray(row_key(s)), (4, 10, 16))) for s in seeds])
    got = port.backbone_batch(CPU, dict(payload, noise=noise))
    assert got["batch"] == want["batch"]
    for (gc, gs), (wc, ws) in zip(got["rows"], want["rows"]):
        assert_allclose(gc, wc, atol=1e-6, rtol=1e-6)
        assert_allclose(gs, ws, atol=1e-6, rtol=1e-6)
    seeded = port.backbone_batch(CPU, payload)["rows"]
    assert seeded[0][0].shape == (4, 10, 16) and seeded[0][1].shape == (4,)


def test_sampled_candidates_score_alike_in_bf16():
    """The dense sampler's candidates, scored teacher-forced in bf16 by both
    packages' ``progen_logprobs``: within 2e-2."""
    ref, port = payloads("bfloat16")
    bb = backbones(np.random.default_rng(12), 2)
    with torch.inference_mode():
        seqs, _ = prot.progen_sample(port.gen_params, torch.from_numpy(bb),
                                     N, L, port.gen_cfg, seeds=[1, 2])
        seqs = seqs.reshape(2 * N, L)
        bbn = torch.from_numpy(np.repeat(bb, N, 0))
        got = prot.progen_logprobs(port.gen_params, bbn, seqs,
                                   port.gen_cfg).float().numpy()
    want = np.asarray(ref_prot.progen_logprobs(
        ref.gen_params, jnp.asarray(bbn.numpy()),
        jnp.asarray(seqs.numpy(), jnp.int32), ref.gen_cfg), np.float32)
    assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_other_param_namespaces_are_not_ported():
    _, port = payloads("float32")
    payload = {"backbones": backbones(np.random.default_rng(13), 1),
               "seeds": [1], "n": N, "length": L, "params": "binder"}
    with pytest.raises(NotImplementedError):
        port.generate_batch(CPU, payload)
    with pytest.raises(NotImplementedError):
        port.predict(CPU, {"sequence": np.arange(1, 9), "target": np.ones(16),
                           "receptor_len": 4, "params": "multimer"})


# ---------------------------------------------------------------------------
# coalesce rules
# ---------------------------------------------------------------------------

def _rule_tasks(kind, payloads_):
    return ([ref_pipeline.Task(kind=kind, payload=dict(p))
             for p in payloads_],
            [port_pipeline.Task(kind=kind, payload=dict(p))
             for p in payloads_])


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)) and not isinstance(a, np.ndarray):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype
    else:
        assert a == b


def _rule_cases():
    rng = np.random.default_rng(14)
    seq = lambda R, W: rng.integers(1, 21, size=(R, W)).astype(np.int32)
    tgt = rng.normal(size=16).astype(np.float32)
    bb = lambda R, P: rng.normal(size=(R, P, 16)).astype(np.float32)
    gen = {"n": 3, "length": 8, "temperature": 1.0}
    return {
        "predict_legacy": ("predict_batch", {}, [
            {"sequences": seq(2, 14), "target": tgt, "receptor_len": 8},
            {"sequences": seq(3, 14)[0], "target": tgt, "receptor_len": 8},
            {"sequences": seq(1, 15), "target": tgt, "receptor_len": 8}]),
        "predict_masked": ("predict_batch", {"length_buckets": (16, 24)}, [
            {"sequences": seq(2, 14), "target": tgt, "receptor_len": 8,
             "seq_lens": [14, 14], "chain_splits": [8, 8]},
            {"sequences": seq(1, 11), "target": np.tile(tgt, (1, 1)),
             "receptor_len": 5, "seq_lens": [11]},
            {"sequences": seq(1, 20), "target": tgt, "receptor_len": 8,
             "seq_lens": [20]}]),
        "generate_plain": ("generate_batch", {}, [
            dict(gen, backbones=bb(1, 12), seeds=[1]),
            dict(gen, backbones=bb(1, 12)[0], seeds=2),
            dict(gen, backbones=bb(1, 10), seeds=[3])]),
        "generate_masked": ("generate_batch", {"prefix_len": 8}, [
            dict(gen, backbones=bb(1, 12), seeds=[1], row_lens=[7]),
            dict(gen, backbones=bb(2, 10), seeds=[2, 3], row_lens=[8, 6]),
            dict(gen, backbones=bb(1, 12), seeds=[4])]),
        "generate_paged": ("generate_batch", {"prefix_len": 8, "live": True},
                           [dict(gen, backbones=bb(1, 12), seeds=[1],
                                 decode="paged", decode_slots=8),
                            dict(gen, backbones=bb(1, 9), seeds=[2],
                                 decode="paged", row_lens=[5]),
                            dict(gen, backbones=bb(1, 12), seeds=[3],
                                 row_lens=[8])]),
        "backbone": ("backbone_batch", {}, [
            {"bases": bb(1, 10), "targets": tgt, "seeds": [1], "m": 4},
            {"bases": bb(2, 10), "targets": rng.normal(size=(2, 16)).astype(
                np.float32), "seeds": [2, 3], "m": 4, "sigma": 0.1},
            {"bases": bb(1, 10), "targets": tgt, "seeds": [4], "m": 5}]),
    }


_RULES = {"predict_batch": "predict_batch_coalesce_rule",
          "generate_batch": "generate_batch_coalesce_rule",
          "backbone_batch": "backbone_batch_coalesce_rule"}


@pytest.mark.parametrize("case", sorted(_rule_cases()))
def test_coalesce_rules_match_reference(case):
    """Keys, merges of the compatible tasks and splits of a fused result
    are the reference's, field for field."""
    kind, kw, members = _rule_cases()[case]
    ref_rule = getattr(ref_payload, _RULES[kind])(**kw)
    port_rule = getattr(port_payload, _RULES[kind])(**kw)
    for attr in ("max_rows", "admission_window", "live"):
        assert getattr(port_rule, attr) == getattr(ref_rule, attr)
    ref_tasks, port_tasks = _rule_tasks(kind, members)
    keys = [port_rule.key(t) for t in port_tasks]
    assert keys == [ref_rule.key(t) for t in ref_tasks]
    assert [port_rule.rows(t) for t in port_tasks] == \
        [ref_rule.rows(t) for t in ref_tasks]
    fuse = [i for i, k in enumerate(keys) if k == keys[0]]
    assert len(fuse) >= 2
    _same(port_rule.merge([port_tasks[i] for i in fuse]),
          ref_rule.merge([ref_tasks[i] for i in fuse]))
    n_rows = sum(ref_rule.rows(ref_tasks[i]) for i in fuse)
    result = {"rows": [("row", r) for r in range(n_rows)],
              "batch": {"rows": n_rows, "bucket": 4}, "gen_version": 3}
    _same(port_rule.split([port_tasks[i] for i in fuse], result),
          ref_rule.split([ref_tasks[i] for i in fuse], result))


def test_register_all_registers_the_reference_kinds():
    class Recorder:
        def __init__(self):
            self.kinds, self.rules = [], {}

        def register(self, kind, fn):
            self.kinds.append(kind)

        def register_coalescable(self, kind, rule, stage=None):
            self.rules[kind] = rule

    ref, port = payloads("float32")
    got, want = Recorder(), Recorder()
    port.register_all(got, generate_batch_rows=4, decode_kernel=True)
    ref.register_all(want, generate_batch_rows=4, decode_kernel=True)
    assert got.kinds == want.kinds
    assert set(got.rules) == set(want.rules)
    for kind, rule in got.rules.items():
        for attr in ("max_rows", "admission_window", "live"):
            assert getattr(rule, attr) == getattr(want.rules[kind], attr)
    assert [port.coalesce_rule_for(k, max_rows=2).max_rows
            for k in sorted(_RULES)] == [2, 2, 2]
    with pytest.raises(KeyError):
        port.coalesce_rule_for("predict")


def test_fold_in_seed_streams_differ():
    seeds = {port_payload.fold_in_seed(s, i)
             for s, i in itertools.product(range(4), range(4))}
    assert len(seeds) == 16
