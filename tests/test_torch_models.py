"""PyTorch port vs the JAX reference, model level, on the CPU.

Weights come from the reference's own ``init_progen``/``init_foldscore``
through ``repro_torch.bridge``; inputs from numpy seeds; configs are the
reduced ones. Tolerances: 1e-5 in fp32 (the algorithm, both sides in full
fp32) and 2e-2 in bf16 (the two frameworks round bf16 at other places),
the reference tests' own."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.configs.registry import get_reduced as ref_get_reduced  # noqa: E402
from repro.models import attention as ref_attn  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import protein as ref_prot  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models import protein as prot  # noqa: E402


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=1e-5, rtol=1e-5)


def cfgs(name, dtype):
    """(reference cfg, port cfg) for a reduced config at ``dtype``."""
    return (dataclasses.replace(ref_get_reduced(name), compute_dtype=dtype),
            get_reduced(name).replace(compute_dtype=dtype))


_PARAMS = {}


def ref_params(name):
    """Reference params (numpy leaves) for a reduced config; compute dtype
    does not change them (parameters are fp32 either way)."""
    if name not in _PARAMS:
        rcfg = ref_get_reduced(name)
        init = ref_prot.init_progen if name == "progen-s" \
            else ref_prot.init_foldscore
        _PARAMS[name] = jax.tree.map(np.asarray,
                                     init(jax.random.PRNGKey(0), rcfg))
    return _PARAMS[name]


def port_module(name, pcfg):
    fn = bridge.progen_from_ref if name == "progen-s" \
        else bridge.foldscore_from_ref
    return fn(ref_params(name), pcfg)


def np32(x):
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("name", ["progen-s", "foldscore-s"])
@pytest.mark.parametrize("reduced", [True, False])
def test_configs_match_reference(name, reduced):
    from repro.configs.registry import get_config as ref_get_config
    ref = (ref_get_reduced if reduced else ref_get_config)(name)
    port = (get_reduced if reduced else get_config)(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.padded_vocab == ref.padded_vocab
    assert len(port.layer_kinds) == ref.n_layers


def test_rope_per_row_positions_and_norm():
    rcfg, pcfg = cfgs("progen-s", "float32")
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 90, size=(2, 5)).astype(np.int32)
    for p in (pos, pos[0]):                       # per-row (B,S) and (S,)
        want = ref_common.apply_rope(jnp.asarray(x), jnp.asarray(p), rcfg)
        got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(p),
                                pcfg)
        assert_allclose(got.numpy(), np32(want), atol=1e-5, rtol=1e-5)
    scale = rng.normal(size=16).astype(np.float32)
    want = ref_common.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    got = common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6)
    assert_allclose(got.numpy(), np32(want), atol=1e-5, rtol=1e-5)


def test_seeded_init_shapes_and_scale():
    _, pcfg = cfgs("progen-s", "float32")
    a = prot.init_progen(pcfg, seed=3, device="cpu")
    b = prot.init_progen(pcfg, seed=3, device="cpu")
    c = prot.init_progen(pcfg, seed=4, device="cpu")
    bridged = port_module("progen-s", pcfg)
    shapes = {n: tuple(p.shape) for n, p in a.named_parameters()}
    assert shapes == {n: tuple(p.shape) for n, p in bridged.named_parameters()}
    for (n, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                               c.parameters()):
        assert torch.equal(pa, pb)
        if "scale" not in n:                      # norms start at ones
            assert not torch.equal(pa, pc)
    wq = a.layers[0].attn.wq                      # fan-in d_model
    assert abs(float(wq.std()) * np.sqrt(pcfg.d_model) - 1.0) < 0.1


def test_lm_logits_matches_reference():
    """fp32 only: bf16 logits carry a few bf16 ulps of framework rounding;
    bf16 is held through teacher-forced log-probs below."""
    rcfg, pcfg = cfgs("progen-s", "float32")
    port = port_module("progen-s", pcfg)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 32, size=(2, 10)).astype(np.int32)
    patches = rng.normal(size=(2, pcfg.frontend_seq, pcfg.d_model)
                         ).astype(np.float32)
    want, _ = ref_lm.lm_logits(
        jax.tree.map(jnp.asarray, ref_params("progen-s")),
        {"inputs": jnp.asarray(toks), "patches": jnp.asarray(patches)}, rcfg)
    got = lm.lm_logits(port, {"inputs": torch.from_numpy(toks),
                              "patches": torch.from_numpy(patches)}, pcfg)
    assert got.shape == want.shape
    assert_allclose(got.numpy(), np32(want), atol=1e-5, rtol=1e-5)


def test_paged_prefill_and_decode_match_reference():
    """Prompts prefilled and decoded greedily through the paged path of
    both packages, with a scrambled page layout (row 0 on even pages, row
    1 on odd ones): per-step logits agree to 1e-5 in fp32."""
    rcfg, pcfg = cfgs("progen-s", "float32")
    rp = jax.tree.map(jnp.asarray, ref_params("progen-s"))
    port = port_module("progen-s", pcfg)
    B, steps, page = 2, 5, 4
    S0 = pcfg.frontend_seq + 1
    rng = np.random.default_rng(11)
    bbs = rng.normal(size=(B, pcfg.frontend_seq, 16)).astype(np.float32)
    maxp = -(-(S0 + steps) // page)
    bt = np.stack([np.arange(0, 2 * maxp, 2, dtype=np.int32),
                   np.arange(1, 2 * maxp, 2, dtype=np.int32)])
    bos = np.zeros((B, 1), np.int32)

    r_caches = ref_lm.init_paged_caches(rcfg, B * maxp + 1, page)
    r_batch = {"inputs": jnp.asarray(bos),
               "patches": ref_prot.encode_structure(rp, jnp.asarray(bbs),
                                                    rcfg)}
    r_logits, r_caches = ref_lm.paged_prefill(rp, r_batch, rcfg, r_caches,
                                              jnp.asarray(bt))
    p_caches = lm.init_paged_caches(pcfg, B * maxp + 1, page)
    p_batch = {"inputs": torch.from_numpy(bos),
               "patches": prot.encode_structure(port, torch.from_numpy(bbs),
                                                pcfg)}
    p_logits, p_caches = lm.paged_prefill(port, p_batch, pcfg, p_caches,
                                          torch.from_numpy(bt))
    assert_allclose(p_logits.numpy(), np32(r_logits), atol=1e-5, rtol=1e-5)

    tok = np.argmax(np32(r_logits)[:, :pcfg.vocab_size], -1)[:, None]
    for i in range(steps):
        pos = np.full((B,), S0 + i, np.int32)
        r_logits, r_caches = ref_lm.paged_decode_step(
            rp, r_caches, jnp.asarray(tok, jnp.int32), jnp.asarray(pos),
            jnp.asarray(bt), jnp.asarray(pos + 1), rcfg, interpret=True)
        p_logits, p_caches = lm.paged_decode_step(
            port, p_caches, torch.from_numpy(tok), torch.from_numpy(pos),
            torch.from_numpy(bt), torch.from_numpy(pos + 1), pcfg)
        assert_allclose(p_logits.numpy(), np32(r_logits), atol=1e-5,
                        rtol=1e-5)
        tok = np.argmax(np32(r_logits)[:, :pcfg.vocab_size], -1)[:, None]
    # the pools hold the same K/V where rows wrote them
    r_k = np32(r_caches[0]["0_attn"]["k_pages"][0])
    assert_allclose(p_caches[0]["k_pages"].numpy()[bt.reshape(-1)],
                    r_k[bt.reshape(-1)], atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_progen_logprobs_with_seq_lens(dtype):
    rcfg, pcfg = cfgs("progen-s", dtype)
    port = port_module("progen-s", pcfg)
    rng = np.random.default_rng(4)
    bb = rng.normal(size=(3, pcfg.frontend_seq, 16)).astype(np.float32)
    seqs = rng.integers(1, 21, size=(3, 12)).astype(np.int32)
    lens = np.asarray([12, 7, 9], np.int32)
    rp = jax.tree.map(jnp.asarray, ref_params("progen-s"))
    for sl in (lens, None):
        want = ref_prot.progen_logprobs(
            rp, jnp.asarray(bb), jnp.asarray(seqs), rcfg,
            seq_lens=None if sl is None else jnp.asarray(sl))
        got = prot.progen_logprobs(
            port, torch.from_numpy(bb), torch.from_numpy(seqs), pcfg,
            seq_lens=None if sl is None else torch.from_numpy(sl))
        assert_allclose(got.numpy(), np32(want), **tol(dtype))


@pytest.mark.parametrize("dtype,attn_impl", [
    ("float32", "xla"), ("float32", "pallas_interpret"), ("bfloat16", "xla")])
def test_foldscore_masked_matches_reference(dtype, attn_impl):
    """The port's trunk always runs the flash kernel's contract; the
    reference is held both through its dense XLA softmax and through its
    Pallas flash kernel in interpret mode."""
    rcfg, pcfg = cfgs("foldscore-s", dtype)
    rcfg = dataclasses.replace(rcfg, attn_impl=attn_impl)
    port = port_module("foldscore-s", pcfg)
    rp = jax.tree.map(jnp.asarray, ref_params("foldscore-s"))
    rng = np.random.default_rng(5)
    seqs = rng.integers(1, 21, size=(3, 16)).astype(np.int32)
    tgt = rng.normal(size=(3, 16)).astype(np.float32)
    lens = np.asarray([16, 11, 13], np.int32)
    splits = np.asarray([10, 6, 9], np.int32)
    want = ref_prot.foldscore_fwd_masked(
        rp, jnp.asarray(seqs), jnp.asarray(tgt), jnp.asarray(lens),
        jnp.asarray(splits), rcfg)
    got = prot.foldscore_fwd_masked(
        port, torch.from_numpy(seqs), torch.from_numpy(tgt),
        torch.from_numpy(lens), torch.from_numpy(splits), pcfg)
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np32(w), **tol(dtype))
    rows = prot.metrics_rows(got, 2)
    assert len(rows) == 2 and set(rows[0]) == {"plddt", "ptm", "pae"}


def test_foldscore_legacy_matches_reference():
    rcfg, pcfg = cfgs("foldscore-s", "float32")
    port = port_module("foldscore-s", pcfg)
    rp = jax.tree.map(jnp.asarray, ref_params("foldscore-s"))
    rng = np.random.default_rng(6)
    seqs = rng.integers(1, 21, size=(2, 14)).astype(np.int32)
    tgt = rng.normal(size=(2, 16)).astype(np.float32)
    want = ref_prot.foldscore_fwd(rp, jnp.asarray(seqs), jnp.asarray(tgt),
                                  rcfg, chain_split=8)
    got = prot.foldscore_fwd(port, torch.from_numpy(seqs),
                             torch.from_numpy(tgt), pcfg, chain_split=8)
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np32(w), atol=1e-5, rtol=1e-5)


def test_attn_fwd_matches_reference_sdpa():
    """One attention layer: the port (flash contract) vs the reference's
    dense XLA path, the function its prompt prefill uses."""
    rcfg, pcfg = cfgs("progen-s", "float32")
    p = ref_params("progen-s")["segments"][0]["0_attn"]["attn"]
    port = port_module("progen-s", pcfg).layers[0].attn
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 9, pcfg.d_model)).astype(np.float32)
    pos = np.arange(9)
    want = ref_attn.attn_fwd(jax.tree.map(lambda a: jnp.asarray(a[0]), p),
                             jnp.asarray(x), jnp.asarray(pos), rcfg)
    got = common_attn_fwd(port, x, pos, pcfg)
    assert_allclose(got, np32(want), atol=1e-5, rtol=1e-5)


def common_attn_fwd(p, x, pos, cfg):
    from repro_torch.models import attention
    return attention.attn_fwd(p, torch.from_numpy(x), torch.from_numpy(pos),
                              cfg).numpy()
