"""PyTorch port vs the JAX reference: the paged decode engine, the payload
and one reduced design loop, on the CPU.

Token identity is checked in fp32, by handing the port the Gumbel noise the
reference engine draws: ``jax.random.categorical(k, x)`` is exactly
``argmax(x + jax.random.gumbel(k, x.shape))``, and the reference engine
draws token ``i`` of a row with ``fold_in(row_key, i)``. Log-likelihoods
agree to 1e-4 (sums of up to 8 fp32 log-probs); metrics to 1e-5 in fp32 and
2e-2 in bf16."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs.registry import get_reduced as ref_get_reduced  # noqa: E402
from repro.core import ProteinPayload as RefPayload  # noqa: E402
from repro.core.payload import _fold_in_keys  # noqa: E402
from repro.core.protocol import fitness as ref_fitness  # noqa: E402
from repro.models import protein as ref_prot  # noqa: E402
from repro.runtime import allocator as ref_alloc  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_reduced  # noqa: E402
from repro_torch.core.payload import ProteinPayload  # noqa: E402
from repro_torch.core.protocol import fitness  # noqa: E402
from repro_torch.models import protein as prot  # noqa: E402
from repro_torch.runtime import allocator  # noqa: E402
from repro_torch.runtime.allocator import SubMesh  # noqa: E402

CPU = SubMesh((torch.device("cpu"),))
VP = 128                                        # padded vocab, reduced progen


class _RefMesh:
    def __init__(self):
        self.devices = np.asarray(jax.devices()[:1])


def _cfgs(dtype):
    return (dataclasses.replace(ref_get_reduced("progen-s"),
                                compute_dtype=dtype),
            dataclasses.replace(ref_get_reduced("foldscore-s"),
                                compute_dtype=dtype),
            get_reduced("progen-s").replace(compute_dtype=dtype),
            get_reduced("foldscore-s").replace(compute_dtype=dtype))


_PAYLOADS = {}


def payloads(dtype, length_buckets=None):
    """(reference payload, port payload on the CPU) on the same weights."""
    key = (dtype, length_buckets)
    if key not in _PAYLOADS:
        rg, rf, pg, pf = _cfgs(dtype)
        ref = RefPayload(jax.random.PRNGKey(0), gen_cfg=rg, fold_cfg=rf,
                         reduced=True, length_buckets=length_buckets)
        npy = lambda t: jax.tree.map(np.asarray, t)
        port = ProteinPayload(
            gen_cfg=pg, fold_cfg=pf, length_buckets=length_buckets,
            device="cpu",
            progen=bridge.progen_from_ref(npy(ref.gen_params), pg),
            foldscore=bridge.foldscore_from_ref(npy(ref.fold_params), pf))
        _PAYLOADS[key] = (ref, port)
    return _PAYLOADS[key]


def jax_noise(row_key, length):
    """The Gumbel draws the reference engine makes for one row: token 0 at
    admission over logits (1, V), token i>=1 in the step over (V,)."""
    k = jnp.asarray(row_key, jnp.uint32)
    first = jax.random.gumbel(jax.random.fold_in(k, 0), (1, VP))[0]
    rest = jax.vmap(lambda i: jax.random.gumbel(jax.random.fold_in(k, i),
                                                (VP,)))(
        jnp.arange(1, length))
    return np.concatenate([np.asarray(first)[None], np.asarray(rest)])


def _specs(n, length, frontend_seq):
    rng = np.random.default_rng(23)
    return [dict(backbone=rng.normal(size=(frontend_seq, 16)).astype(
                     np.float32),
                 key=np.asarray(jax.random.PRNGKey(i), np.uint32),
                 length=length, tag=i) for i in range(n)]


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

def test_engine_with_jax_noise_reproduces_reference_tokens():
    """3 rows through a 2-slot engine in both packages (the third admits
    after a retirement): the same tokens, log-likelihoods within 1e-4."""
    ref, port = payloads("float32")
    cfg = port.gen_cfg
    specs = _specs(3, 6, cfg.frontend_seq)
    r_eng = ref_prot.PagedDecodeEngine(ref.gen_cfg, slots=2, max_new=6,
                                       interpret=True)
    want = r_eng.run(ref.gen_params, 1.0, specs)
    p_eng = prot.PagedDecodeEngine(cfg, slots=2, max_new=6, device="cpu")
    got = p_eng.run(port.gen_params, 1.0, [
        dict(backbone=s["backbone"], seed=0, length=s["length"],
             tag=s["tag"], noise=jax_noise(s["key"], s["length"]))
        for s in specs])
    assert set(got) == set(want) == {0, 1, 2}
    for tag in want:
        np.testing.assert_array_equal(got[tag][0], want[tag][0])
        assert abs(got[tag][1] - want[tag][1]) < 1e-4
    assert p_eng.alloc_log == r_eng.alloc_log     # same page choices
    assert p_eng.n_admits == 3


def test_engine_page_pool_round_trip():
    """The third row of a 2-slot engine decodes on pages an earlier row
    returned, and the pool is whole again afterwards."""
    _, port = payloads("float32")
    cfg = port.gen_cfg
    eng = prot.PagedDecodeEngine(cfg, slots=2, max_new=6, device="cpu")
    rng = np.random.default_rng(1)
    specs = [dict(backbone=rng.normal(size=(cfg.frontend_seq, 16)),
                  seed=i, length=6 - i, tag=i) for i in range(3)]
    res = eng.run(port.gen_params, 1.0, specs)
    assert [len(res[i][0]) for i in range(3)] == [6, 5, 4]
    first_two = set(p for _, pg in eng.alloc_log[:2] for p in pg)
    assert set(eng.alloc_log[2][1]) <= first_two
    assert sorted(eng.free_pages) == list(range(eng.n_pages))
    assert (eng.block_tables == eng.trash_page).all()
    assert not eng.true_lens.any()
    # a recycled page gives the same result as a fresh engine
    solo = prot.PagedDecodeEngine(cfg, slots=2, max_new=6, device="cpu").run(
        port.gen_params, 1.0, [specs[2]])[2]
    np.testing.assert_array_equal(solo[0], res[2][0])
    assert abs(solo[1] - res[2][1]) < 1e-4


@pytest.mark.parametrize("rows", [8, 5])
def test_engine_matches_teacher_forced_forward(rows):
    """Every token the engine samples is the argmax of the full forward's
    masked logits plus the row's noise, and its log-likelihood is the full
    forward's, also for a backbone shorter than ``frontend_seq`` decoded on
    recycled pages (the row behind a retired one in a 1-slot engine)."""
    from repro_torch.models import lm
    _, port = payloads("float32")
    cfg, params = port.gen_cfg, port.gen_params
    rng = np.random.default_rng(rows)
    L = 7
    eng = prot.PagedDecodeEngine(cfg, slots=1, max_new=L, device="cpu")
    noise = rng.gumbel(size=(L, VP)).astype(np.float32)
    bb = rng.normal(size=(rows, 16)).astype(np.float32)
    res = eng.run(params, 1.0, [
        dict(backbone=rng.normal(size=(8, 16)), seed=1, length=L, tag="a"),
        dict(backbone=bb, seed=2, length=L, tag="b", noise=noise)])
    toks, ll = res["b"]
    inputs = torch.from_numpy(np.concatenate([[0], toks[:-1]])[None])
    with torch.no_grad():
        logits = lm.lm_logits(params, {
            "inputs": inputs, "patches": prot.encode_structure(
                params, torch.from_numpy(bb)[None], cfg)}, cfg)[0]
    logits[:, cfg.vocab_size:] = -1e30
    want = torch.argmax(logits + torch.from_numpy(noise), -1).numpy()
    np.testing.assert_array_equal(toks, want)
    lp = torch.log_softmax(logits, -1)[torch.arange(L), toks.tolist()]
    assert abs(ll - float(lp.sum())) < 1e-4


def test_engine_composition_independence():
    """A row's tokens are identical whether it decodes alone or is poll-
    injected into a half-finished batch (seeded generators, no shared
    stream)."""
    _, port = payloads("float32")
    cfg = port.gen_cfg
    eng = prot.PagedDecodeEngine(cfg, slots=3, max_new=6, device="cpu")
    rng = np.random.default_rng(2)
    specs = [dict(backbone=rng.normal(size=(cfg.frontend_seq, 16)),
                  seed=100 + i, length=6, tag=i) for i in range(3)]
    solo = eng.run(port.gen_params, 1.0, [specs[2]])[2]
    calls = []

    def poll(free):
        calls.append(free)
        return [specs[2]] if len(calls) == 3 else []

    res = eng.run(port.gen_params, 1.0, specs[:2], poll=poll)
    assert len(calls) >= 3                        # injected mid-flight
    np.testing.assert_array_equal(res[2][0], solo[0])
    assert abs(res[2][1] - solo[1]) < 1e-4


# ---------------------------------------------------------------------------
# payload
# ---------------------------------------------------------------------------

def _score_payload(rng, R, L, masked):
    p = {"sequences": rng.integers(1, 21, size=(R, L)).astype(np.int32),
         "target": rng.normal(size=16).astype(np.float32),
         "receptor_len": L - 6}
    if masked:
        p["seq_lens"] = np.asarray([L - r for r in range(R)], np.int32)
        p["chain_splits"] = np.asarray([L - 6 - r for r in range(R)],
                                       np.int32)
    return p


@pytest.mark.parametrize("dtype,masked", [
    ("float32", True), ("bfloat16", True), ("float32", False)])
def test_predict_batch_matches_reference(dtype, masked):
    ref, port = payloads(dtype)
    payload = _score_payload(np.random.default_rng(3), 3, 14, masked)
    want = ref.predict_batch(_RefMesh(), payload)
    got = port.predict_batch(CPU, payload)
    t = 2e-2 if dtype == "bfloat16" else 1e-5
    for g, w in zip(got["rows"], want["rows"]):
        assert_allclose([g[k] for k in ("plddt", "ptm", "pae")],
                        [w[k] for k in ("plddt", "ptm", "pae")],
                        atol=t, rtol=t)
    assert got["batch"] == want["batch"]


def _gen_payload(seed, n=2, length=6, frontend_seq=8):
    rng = np.random.default_rng(100 + seed)
    return {"backbones": rng.normal(size=(1, frontend_seq + 4, 16)).astype(
                np.float32),
            "seeds": [seed], "n": n, "length": length,
            "temperature": 1.0, "decode": "paged"}


def test_generate_batch_live_admission():
    """A queued task pulled in mid-decode through the admission port: its
    row follows the leader's, and the leader's row is identical to its
    solo dispatch."""
    _, port = payloads("float32")
    solo = port.generate_batch(CPU, _gen_payload(0))
    seqs, lls = solo["rows"][0]
    assert seqs.shape == (2, 6) and lls.shape == (2,)
    assert ((0 <= seqs) & (seqs < port.gen_cfg.vocab_size)).all()
    assert (lls < 0).all()

    class _Port:
        def __init__(self, payloads):
            self.q = [type("T", (), {"payload": p}) for p in payloads]

        def take(self, k):
            out, self.q = self.q[:k], self.q[k:]
            return out

    fused = port.generate_batch(
        CPU, dict(_gen_payload(0), _admit=_Port([_gen_payload(1)])))
    assert len(fused["rows"]) == 2
    assert fused["batch"]["admitted"] == 1
    np.testing.assert_array_equal(fused["rows"][0][0], seqs)
    assert_allclose(fused["rows"][0][1], lls, atol=1e-4)
    later = port.generate_batch(CPU, _gen_payload(1))
    np.testing.assert_array_equal(fused["rows"][1][0], later["rows"][0][0])
    # without ``decode`` the same payload takes the dense sampler, never
    # the engine
    dense = port.generate_batch(CPU, {k: v for k, v in _gen_payload(0).items()
                                      if k != "decode"})
    assert dense["rows"][0][0].shape == (2, 6)
    assert "decode" not in dense["batch"] and "steps" not in dense["batch"]


# ---------------------------------------------------------------------------
# the slice end to end
# ---------------------------------------------------------------------------

def design_loop(pp, mesh, fit_fn, n_pipelines=2, n_cycles=2, n=4, L=8,
                noise_for=None):
    """The executor's and protocol's part of the IMPRESS cycle, reduced:
    one fused paged ``generate_batch`` over all pipelines, rank each row by
    log-likelihood, score the top-3 (peptide appended) with the masked
    ``predict_batch``, accept the first candidate whose fitness improves.
    Returns the accepted (pipeline, cycle, sequence, fitness) records."""
    rng = np.random.default_rng(7)
    pep = np.arange(1, 7, dtype=np.int32)
    backbones = rng.normal(size=(n_pipelines, 12, 16)).astype(np.float32)
    targets = rng.normal(size=(n_pipelines, 16)).astype(np.float32)
    aa_emb = rng.normal(size=(32, 16)).astype(np.float32)
    prev = [None] * n_pipelines
    accepted = []
    for cycle in range(n_cycles):
        seeds = [1000 * p + cycle for p in range(n_pipelines)]
        payload = {"backbones": backbones, "seeds": seeds, "n": n,
                   "length": L, "temperature": 1.0, "decode": "paged"}
        if noise_for is not None:
            payload["noise"] = noise_for(seeds, n, L)
        rows = pp.generate_batch(mesh, payload)["rows"]
        for p, (seqs, lls) in enumerate(rows):
            top = seqs[np.argsort(-lls, kind="stable")[:3]]
            stack = np.concatenate([top, np.tile(pep, (len(top), 1))], 1)
            scores = pp.predict_batch(mesh, {
                "sequences": stack, "target": targets[p], "receptor_len": L,
                "seq_lens": np.full(len(top), stack.shape[1], np.int32),
                "chain_splits": np.full(len(top), L, np.int32)})["rows"]
            for seq, m in zip(top, scores):
                fit = fit_fn(m)
                if prev[p] is None or fit > prev[p]:
                    prev[p] = fit
                    accepted.append((p, cycle, seq.tolist(), fit))
                    backbones[p, :L] = 0.75 * backbones[p, :L] \
                        + 0.25 * aa_emb[seq]
                    break
    return accepted


def _reference_noise(seeds, n, L):
    return np.stack([np.stack([jax_noise(k, L) for k in _fold_in_keys(s, n)])
                     for s in seeds])


def test_design_loop_accepts_same_candidates_as_reference():
    """Two pipelines, two cycles, in both packages, the port fed the
    reference's noise: the same designs are accepted, in the same order,
    with fitness within 1e-5."""
    ref, port = payloads("float32", length_buckets=(16,))
    want = design_loop(ref, _RefMesh(), ref_fitness)
    got = design_loop(port, CPU, fitness, noise_for=_reference_noise)
    assert [a[:3] for a in got] == [a[:3] for a in want]
    assert len(got) >= 2
    assert_allclose([a[3] for a in got], [a[3] for a in want], atol=1e-5,
                    rtol=1e-5)


# ---------------------------------------------------------------------------
# copies of reference helpers, and devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 1, 3, 5, 33, 64, 65, 130])
def test_buckets_and_fitness_match_reference(n):
    assert allocator.bucket_rows(max(n, 1)) == ref_alloc.bucket_rows(max(n, 1))
    assert allocator.bucket_len(n) == ref_alloc.bucket_len(n)
    edges = (16, 40)
    assert allocator.bucket_len(n, edges) == ref_alloc.bucket_len(n, edges)
    m = {"plddt": 10.0 + n, "ptm": 0.5, "pae": n / 10}
    assert fitness(m) == ref_fitness(m)


def test_cuda_requested_without_device_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        repro_torch.resolve_device("cuda")
    with pytest.raises(RuntimeError):
        ProteinPayload(reduced=True)              # default device is cuda
    with pytest.raises(RuntimeError):
        prot.PagedDecodeEngine(get_reduced("progen-s"), slots=2, max_new=4)
    assert repro_torch.resolve_device("cpu") == torch.device("cpu")
