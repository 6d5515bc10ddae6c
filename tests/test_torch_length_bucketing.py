"""``tests/test_length_bucketing.py`` over both packages: bucket tables,
masked-scoring equivalence (a padded mixed-length batch scores bit-close
to each row alone at its true length), coalesce-rule key/merge/split
round-trips over heterogeneous lengths, batch-composition independence of
masked sampling, and the mixed-length campaign end to end through the
session facade, each run on the reference (``repro``) and on the port
(``repro_torch``, CPU tensors, the kernels' plain versions).

Each package runs its own seeded reduced payload (bf16 compute, as the
reference's test builds it); the port's model functions take torch
tensors and hand back torch tensors, read here as numpy arrays. The
port's session has no XLA compilation cache: where the reference applies
``compilation_cache_dir``, the port refuses it before any thread starts.
"""

import importlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import repro.core  # noqa: E402,F401  — resolves the core<->runtime cycle

PKGS = ("repro", "repro_torch")
ATOL = 1e-5


class Pkg:
    """One package's modules and payload, and its array conventions."""

    def __init__(self, name):
        self.name = name
        mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
        self.allocator = mod("runtime.allocator")
        self.payload_mod = mod("core.payload")
        self.pipeline = mod("core.pipeline")
        self.prot = mod("models.protein")
        self.session = mod("session")

    @property
    def port(self):
        return self.name == "repro_torch"

    def arr(self, x):
        """A numpy input as the package's model functions take it."""
        return torch.from_numpy(np.asarray(x)) if self.port else x

    def payload(self):
        if self.port:
            return self.payload_mod.ProteinPayload(reduced=True,
                                                   device="cpu")
        return self.payload_mod.ProteinPayload(jax.random.PRNGKey(0),
                                               reduced=True, length=16)

    def submesh(self):
        devices = [torch.device("cpu")] if self.port else jax.devices()
        sub = self.allocator.DeviceAllocator(devices).request(1)
        assert sub is not None
        return sub

    def session_kw(self):
        """What the port's session needs besides the spec: a reduced payload
        on the CPU and the CPU as its device (it takes every CUDA device
        otherwise); the reference builds its own."""
        if not self.port:
            return {}
        return {"payload": self.payload(), "devices": [torch.device("cpu")]}


_PAYLOADS = {}


@pytest.fixture(params=PKGS)
def pkg(request):
    return Pkg(request.param)


@pytest.fixture
def payload(pkg):
    """The package's reduced payload, built once a package."""
    if pkg.name not in _PAYLOADS:
        _PAYLOADS[pkg.name] = pkg.payload()
    return _PAYLOADS[pkg.name]


# -- bucket tables -----------------------------------------------------------


def test_bucket_len_global_table(pkg):
    a = pkg.allocator
    assert a.bucket_len(1) == a.LENGTH_BUCKETS[0]
    assert a.bucket_len(17) == 24
    assert a.bucket_len(64) == 64
    assert a.bucket_len(65) == 96
    # past the top edge: round up to a multiple of it, never unbounded
    top = a.LENGTH_BUCKETS[-1]
    assert a.bucket_len(top + 1) == 2 * top
    assert a.bucket_len(2 * top + 5) == 3 * top


def test_bucket_len_custom_edges(pkg):
    a = pkg.allocator
    assert a.bucket_len(10, (12, 20)) == 12
    assert a.bucket_len(12, (12, 20)) == 12
    assert a.bucket_len(13, (12, 20)) == 20
    assert a.bucket_len(25, (12, 20)) == 40   # beyond top: multiple of 20


def test_choose_length_buckets_density(pkg):
    a = pkg.allocator
    lengths = [49, 53, 57, 60, 64, 101, 103]
    edges = a.choose_length_buckets(lengths, max_pad=0.125)
    assert edges == tuple(sorted(edges))
    for L in lengths:
        b = a.bucket_len(L, edges)
        assert b in edges
        assert L <= b <= L / (1.0 - 0.125)   # per-row fill >= 1 - max_pad
    assert a.choose_length_buckets([]) is None
    assert a.choose_length_buckets([24, 24, 24]) == (24,)


def test_campaign_length_buckets_from_spec(pkg):
    s, bucket_len = pkg.session, pkg.allocator.bucket_len
    # homogeneous campaign: no buckets -> exact seed paths
    assert s.campaign_length_buckets(s.CampaignSpec(receptor_len=24)) is None
    spec = s.CampaignSpec(receptor_len=(10, 12, 14), peptide_len=4)
    edges = s.campaign_length_buckets(spec)
    for L in (10, 12, 14, 14 + 4):
        assert bucket_len(L, edges) >= L
    # explicit override wins
    spec = s.CampaignSpec(receptor_len=(10, 12), length_buckets=(16, 32))
    assert s.campaign_length_buckets(spec) == (16, 32)


# -- masked model equivalence ------------------------------------------------


def mixed_rows(rng, lens, pad_to):
    seqs = np.zeros((len(lens), pad_to), np.int32)
    rows = []
    for i, L in enumerate(lens):
        row = rng.integers(1, 20, size=L).astype(np.int32)
        seqs[i, :L] = row
        rows.append(row)
    return seqs, rows


def test_masked_foldscore_matches_solo(pkg, payload):
    cfg, prot, t = payload.fold_cfg, pkg.prot, pkg.arr
    rng = np.random.default_rng(3)
    lens, splits = [9, 12, 16], [6, 8, 12]
    seqs, rows = mixed_rows(rng, lens, 16)
    tgt = rng.normal(size=(3, 16)).astype(np.float32)
    m = prot.foldscore_fwd_masked(
        payload.fold_params, t(seqs), t(tgt), t(np.array(lens, np.int32)),
        t(np.array(splits, np.int32)), cfg)
    for i, (L, s) in enumerate(zip(lens, splits)):
        solo = prot.foldscore_fwd(payload.fold_params, t(rows[i][None]),
                                  t(tgt[i][None]), cfg, chain_split=s)
        for k in ("plddt", "ptm", "pae"):
            np.testing.assert_allclose(np.asarray(getattr(m, k)[i]),
                                       np.asarray(getattr(solo, k)[0]),
                                       atol=ATOL)


def test_masked_progen_logprobs_match_solo(pkg, payload):
    cfg, prot, t = payload.gen_cfg, pkg.prot, pkg.arr
    params = (payload.param_store.current()[1] if pkg.port
              else payload.gen_params)
    rng = np.random.default_rng(4)
    lens = [7, 10, 12]
    seqs, rows = mixed_rows(rng, lens, 12)
    bb = rng.normal(size=(3, cfg.frontend_seq, 16)).astype(np.float32)
    with torch.inference_mode():
        lp = prot.progen_logprobs(params, t(bb), t(seqs), cfg,
                                  seq_lens=t(np.array(lens, np.int32)))
        for i, L in enumerate(lens):
            solo = prot.progen_logprobs(params, t(bb[i][None]),
                                        t(rows[i][None]), cfg)
            np.testing.assert_allclose(np.asarray(lp[i]),
                                       np.asarray(solo[0]), atol=ATOL)


def test_predict_batch_masked_matches_per_row_predict(pkg, payload):
    """The acceptance-criterion equivalence: a padded mixed-length
    predict_batch returns metrics bit-close to each row scored alone (via
    the seed ``predict`` task fn) at its true length."""
    submesh = pkg.submesh()
    rng = np.random.default_rng(5)
    lens, splits = [10, 13, 16, 16], [6, 9, 12, 11]
    seqs, rows = mixed_rows(rng, lens, 16)
    tgt = rng.normal(size=16).astype(np.float32)
    out = payload.predict_batch(submesh, {
        "sequences": seqs, "target": tgt, "receptor_len": splits[0],
        "seq_lens": np.array(lens, np.int32),
        "chain_splits": np.array(splits, np.int32)})
    assert out["batch"]["len_occupancy"] == pytest.approx(
        sum(lens) / (4 * 16))
    for i, (L, s) in enumerate(zip(lens, splits)):
        solo = payload.predict(submesh, {
            "sequence": rows[i], "target": tgt, "receptor_len": s})
        for k in ("plddt", "ptm", "pae"):
            assert out["rows"][i][k] == pytest.approx(solo[k], abs=ATOL)


def test_predict_batch_legacy_has_no_len_padding(pkg, payload):
    """Without seq_lens the payload takes the exact path (len_occupancy 1,
    chain_split static) — homogeneous campaigns stay on seed behavior."""
    rng = np.random.default_rng(6)
    seqs = rng.integers(1, 20, size=(2, 10)).astype(np.int32)
    tgt = rng.normal(size=16).astype(np.float32)
    out = payload.predict_batch(pkg.submesh(), {
        "sequences": seqs, "target": tgt, "receptor_len": 7})
    assert out["batch"]["len_occupancy"] == 1.0


def test_generate_batch_masked_composition_independent(pkg, payload):
    """A masked row's samples depend only on (seed, bucket length) — never
    on which other rows share the device batch — and are truncated to the
    row's true length."""
    submesh = pkg.submesh()
    rng = np.random.default_rng(7)
    bbs = rng.normal(size=(3, 8, 16)).astype(np.float32)
    fused = payload.generate_batch(submesh, {
        "backbones": bbs, "seeds": [11, 22, 33], "n": 2, "length": 12,
        "row_lens": [9, 12, 10]})
    assert fused["batch"]["len_occupancy"] == pytest.approx(31 / 36)
    for r, L in enumerate([9, 12, 10]):
        solo = payload.generate_batch(submesh, {
            "backbones": bbs[r][None], "seeds": [[11, 22, 33][r]],
            "n": 2, "length": 12, "row_lens": [L]})
        assert fused["rows"][r][0].shape == (2, L)
        np.testing.assert_array_equal(fused["rows"][r][0], solo["rows"][0][0])
        np.testing.assert_allclose(fused["rows"][r][1], solo["rows"][0][1],
                                   atol=ATOL)


# -- coalesce rules over heterogeneous lengths -------------------------------


def mk_predict_task(pkg, rng, n_rows, L, split, masked):
    p = {"sequences": rng.integers(1, 20, size=(n_rows, L)).astype(np.int32),
         "target": rng.normal(size=16).astype(np.float32),
         "receptor_len": split}
    if masked:
        p["seq_lens"] = np.full(n_rows, L, np.int32)
        p["chain_splits"] = np.full(n_rows, split, np.int32)
    return pkg.pipeline.Task(kind="predict_batch", payload=p)


def test_predict_rule_fuses_heterogeneous_lengths(pkg):
    rule = pkg.payload_mod.predict_batch_coalesce_rule(length_buckets=(16,))
    rng = np.random.default_rng(8)
    a = mk_predict_task(pkg, rng, 2, 12, 8, masked=True)
    b = mk_predict_task(pkg, rng, 3, 16, 11, masked=True)
    c = mk_predict_task(pkg, rng, 2, 14, 9, masked=True)
    assert rule.key(a) == rule.key(b) == rule.key(c) == ("masked", 16, None)
    fused = rule.merge([a, b, c])
    assert fused["sequences"].shape == (7, 16)
    np.testing.assert_array_equal(fused["seq_lens"],
                                  [12, 12, 16, 16, 16, 14, 14])
    np.testing.assert_array_equal(fused["chain_splits"],
                                  [8, 8, 11, 11, 11, 9, 9])
    # member stacks were zero-padded into the bucket, real tokens intact
    np.testing.assert_array_equal(fused["sequences"][0][:12],
                                  a.payload["sequences"][0])
    assert not fused["sequences"][0][12:].any()
    # split fans the fused rows back out per member
    result = {"rows": [{"i": i} for i in range(7)], "batch": {"rows": 7}}
    outs = rule.split([a, b, c], result)
    assert [len(o["rows"]) for o in outs] == [2, 3, 2]
    assert outs[1]["rows"][0] == {"i": 2}
    assert outs[0]["batch"]["leader"] and not outs[1]["batch"]["leader"]


def test_predict_rule_legacy_and_masked_never_fuse(pkg):
    rule = pkg.payload_mod.predict_batch_coalesce_rule(length_buckets=(16,))
    rng = np.random.default_rng(9)
    legacy = mk_predict_task(pkg, rng, 2, 16, 11, masked=False)
    masked = mk_predict_task(pkg, rng, 2, 16, 11, masked=True)
    assert rule.key(legacy) != rule.key(masked)
    # legacy keys stay the exact (L, split) — the seed behavior
    assert rule.key(legacy) == (16, 11, None)
    # legacy-only merges produce the seed payload shape (no seq_lens)
    fused = rule.merge([legacy, mk_predict_task(pkg, rng, 1, 16, 11, False)])
    assert "seq_lens" not in fused and "chain_splits" not in fused


def mk_gen_task(pkg, rng, P, L, seed, masked, buckets=(12,)):
    p = {"backbones": rng.normal(size=(1, P, 16)).astype(np.float32),
         "seeds": [seed], "n": 2, "length": L, "temperature": 1.0}
    if masked:
        p["length"] = pkg.allocator.bucket_len(L, buckets)
        p["row_lens"] = [L]
    return pkg.pipeline.Task(kind="generate_batch", payload=p)


def test_generate_rule_masked_fuses_across_backbone_lengths(pkg):
    rule = pkg.payload_mod.generate_batch_coalesce_rule(prefix_len=8)
    rng = np.random.default_rng(10)
    a = mk_gen_task(pkg, rng, 14, 10, 1, masked=True)
    b = mk_gen_task(pkg, rng, 16, 12, 2, masked=True)
    # different backbone lengths, same bucket: identical masked keys
    assert rule.key(a) == rule.key(b)
    fused = rule.merge([a, b])
    assert fused["backbones"].shape == (2, 8, 16)   # prefix-trimmed
    np.testing.assert_array_equal(fused["row_lens"], [10, 12])
    assert fused["length"] == 12
    # legacy one-row tasks with different backbone shapes keep distinct
    # keys (the seed behavior — shape is part of compatibility)
    la = mk_gen_task(pkg, rng, 14, 12, 3, masked=False)
    lb = mk_gen_task(pkg, rng, 16, 12, 4, masked=False)
    assert rule.key(la) != rule.key(lb)
    assert rule.key(la) != rule.key(a)


# -- metrics_rows vectorization ---------------------------------------------


def test_metrics_rows_matches_scalar_indexing(pkg):
    t, prot = pkg.arr, pkg.prot
    m = prot.FoldMetrics(plddt=t(np.array([50.5, 60.25], np.float32)),
                         ptm=t(np.array([0.5, 0.75], np.float32)),
                         pae=t(np.array([10.0, 12.5], np.float32)))
    rows = prot.metrics_rows(m)
    assert rows == [{"plddt": 50.5, "ptm": 0.5, "pae": 10.0},
                    {"plddt": 60.25, "ptm": 0.75, "pae": 12.5}]
    assert all(isinstance(v, float) for r in rows for v in r.values())
    assert prot.metrics_rows(m, 1) == rows[:1]


# -- end to end --------------------------------------------------------------


def test_mixed_length_campaign_end_to_end(pkg):
    """A mixed-receptor-length campaign (batched scoring + batched
    sampling) completes with dense masked fusion and no failed tasks."""
    s = pkg.session
    spec = s.CampaignSpec(
        structures=4, receptor_len=(10, 12, 14, 16), peptide_len=4,
        protocols=(s.ProtocolSpec("im-rp", n_cycles=2, n_candidates=4,
                                  score_batch=4, generate_batch_size=8),),
        max_workers=4, seed=0)
    with s.ImpressSession(spec, **pkg.session_kw()) as sess:
        assert sess.length_buckets is not None
        rep = sess.run(timeout=300)
    assert rep["executor"]["n_failed"] == 0
    assert rep.trajectories > 0
    assert rep["len_occupancy"] is not None
    assert 0.5 < rep["len_occupancy"] <= 1.0
    assert rep["gen_len_occupancy"] is not None
    assert rep["compile"]["length_buckets"] == list(sess.length_buckets)


def test_compilation_cache_opt_in(pkg, tmp_path):
    """The XLA persistent-cache satellite: a spec-level cache dir is
    applied to jax.config and recorded in the report's compile section.
    The port has no such cache (its kernels build once into
    ``build/kernels/``): it refuses the spec before any thread starts, and
    leaves the directory uncreated."""
    s = pkg.session
    cache = str(tmp_path / "xla-cache")
    spec = s.CampaignSpec(
        structures=1, receptor_len=8, peptide_len=4,
        protocols=(s.ProtocolSpec("im-rp", n_cycles=1, n_candidates=2),),
        max_workers=2, compilation_cache_dir=cache)
    # sessions without the opt-in record None (and leave config alone)
    assert s.CampaignSpec().compilation_cache_dir is None
    if pkg.port:
        with pytest.raises(ValueError, match="compilation_cache_dir"):
            s.ImpressSession(spec, **pkg.session_kw())
        assert not os.path.exists(cache)
        return
    try:
        with s.ImpressSession(spec) as sess:
            assert jax.config.jax_compilation_cache_dir == cache
            assert os.path.isdir(cache)
            rep = sess.run(timeout=120)
    finally:
        jax.config.update("jax_compilation_cache_dir", None)
    assert rep["compile"]["persistent_cache_dir"] == cache
