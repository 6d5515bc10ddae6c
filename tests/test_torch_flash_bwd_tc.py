"""Flash's gradient on the tensor cores (``csrc/flash_bwd.cu``), on the CPU:
the forward's lse and the gradient kernel's new algebra.

The forward kernels write each row's log-sum-exp beside o when asked
(``return_lse``), as the reference's ``_flash_xla_fwd`` returns it as a
residual; ``attention_tiled_ref`` and ``attention_ref`` repeat that lse,
held here against the residual of ``_flash_xla_fwd`` (rows with a live
key to 1e-5; rows with none at the port's own NEG_INF + log(1e-20)).
``attention_bwd_tiled_ref`` takes that lse and repeats the kernel's
roundings (P and dS rounded to bf16 before their products in bf16; in
fp32 each product in three TF32 parts, ``_mm_tf32x3``); it is held against
``jax.vjp`` of the reference's ``_flash_xla`` and against autograd through
``attention_ref``, at 2e-5 (fp32) / 2e-2 (bf16) of each gradient's max.
Cases: head dims 16-64 and 256, GQA groups of 1-10, causal and not,
windows, ragged ``seq_k``, a context-parallel chunk's ``q_offset`` and
rows with no live key. Inputs come from numpy seeds. The kernel itself
runs on the card: tests/test_torch_cuda.py.
"""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import _flash_xla, _flash_xla_fwd  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# label -> (B, H, KV, Sq, Sk, hd, q_offset, kwargs)
CASES = {
    "hd 16, G 1, causal": (2, 2, 2, 40, 40, 16, 0, dict(causal=True)),
    "hd 32, G 3, window": (1, 6, 2, 48, 48, 32, 0,
                           dict(causal=True, window=20)),
    "hd 64, G 5, chunk at 64": (1, 5, 1, 32, 96, 64, 64, dict(causal=True)),
    "hd 32, rows with no live key": (1, 3, 1, 16, 24, 32, 20,
                                     dict(causal=False, window=6, seq_k=20)),
    "hd 64, G 2, non-causal, ragged seq_k": (2, 4, 2, 33, 45, 64, 0,
                                             dict(causal=False, seq_k=41)),
    "hd 256, G 10, window, chunk at 48": (1, 10, 1, 32, 80, 256, 48,
                                          dict(causal=True, window=40)),
}
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DEAD = np.float32(fa.NEG_INF + math.log(1e-20))   # a row with no live key


def inputs(seed, B, H, KV, Sq, Sk, hd):
    """q, k, v and the output gradient g, fp32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd),
                      (B, H, Sq, hd))]


def positions(Sq, Sk, off, seq_k):
    """The reference's query and key positions: queries from ``off``,
    keys past ``seq_k`` at -1 (its mask leaves them dead)."""
    k_pos = jnp.arange(Sk)
    if seq_k is not None:
        k_pos = jnp.where(k_pos < seq_k, k_pos, -1)
    return jnp.arange(off, off + Sq), k_pos


def to_ref(x):
    """(B, H, S, hd) numpy -> the reference's (B, S, H, hd) layout."""
    return jnp.asarray(x).transpose(0, 2, 1, 3)


def live_rows(Sq, Sk, off, causal=True, window=0, seq_k=None):
    """(Sq,) whether each query row has a live key."""
    pos = off + np.arange(Sq)[:, None]
    keys = np.arange(Sk)[None, :]
    live = np.broadcast_to(keys < (Sk if seq_k is None else seq_k), (Sq, Sk))
    if causal:
        live = live & (keys <= pos)
    if window > 0:
        live = live & (keys > pos - window)
    return live.any(-1)


def rel_errors(got, want):
    """Each gradient's max abs error over its max magnitude."""
    out = []
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        scale = float(np.abs(b).max()) or 1.0
        out.append(float(np.abs(a - b).max()) / scale)
    return out


def port_forward(q, k, v, off, kw, dtype):
    """o and lse as the forward kernel of ``dtype`` computes them: the bf16
    kernel's algebra (``attention_tiled_ref``) in bf16, the plain softmax
    in fp32 (its kernel keeps P in fp32)."""
    fwd = fa.attention_ref if dtype == torch.float32 else \
        fa.attention_tiled_ref
    return fwd(q, k, v, q_offset=off, return_lse=True, **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_forward_lse_matches_reference_residual(case):
    """The lse of ``attention_tiled_ref`` and ``attention_ref`` (what the
    kernels write) against ``_flash_xla_fwd``'s residual (B, KV, G, S as
    (B, H, S)): to 1e-5 on every row with a live key; a row with none at
    NEG_INF + log(1e-20), both sides."""
    B, H, KV, Sq, Sk, hd, off, kw = CASES[case]
    q, k, v, _ = inputs(len(case), B, H, KV, Sq, Sk, hd)
    q_pos, k_pos = positions(Sq, Sk, off, kw.get("seq_k"))
    block = 8 if Sk % 8 == 0 else 0
    _, res = _flash_xla_fwd(to_ref(q), to_ref(k), to_ref(v), q_pos, k_pos,
                            kw["causal"], kw.get("window", 0), block)
    want = np.asarray(res[-1]).reshape(B, H, Sq)
    live = live_rows(Sq, Sk, off, **kw)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    for fwd in (fa.attention_tiled_ref, fa.attention_ref):
        o, lse = fwd(tq, tk, tv, q_offset=off, return_lse=True, **kw)
        assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
        got = lse.numpy()
        np.testing.assert_allclose(got[:, :, live], want[:, :, live],
                                   atol=1e-5, rtol=0)
        assert (got[:, :, ~live] == DEAD).all()
        assert (want[:, :, ~live] <= DEAD).all()
        assert torch.equal(o, fwd(tq, tk, tv, q_offset=off, **kw))
    assert (~live).any() == (case == "hd 32, rows with no live key")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_gradient_with_lse_matches_reference_vjp(case, dtype):
    """``attention_bwd_tiled_ref`` at the forward's o and lse against
    ``jax.vjp`` of ``_flash_xla`` on the same inputs (in ``dtype``): dq, dk,
    dv each within 2e-5 (fp32) / 2e-2 (bf16) of its max; a row with no
    live key takes zero dq, a key past ``seq_k`` zero dk and dv."""
    B, H, KV, Sq, Sk, hd, off, kw = CASES[case]
    q, k, v, g = inputs(len(case) + 1, B, H, KV, Sq, Sk, hd)
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    o, lse = port_forward(tq, tk, tv, off, kw, dtype)
    got = fa.attention_bwd_tiled_ref(tq, tk, tv, o, tg, lse, q_offset=off,
                                     **kw)
    assert all(x.dtype == dtype for x in got)
    q_pos, k_pos = positions(Sq, Sk, off, kw.get("seq_k"))
    block = 8 if Sk % 8 == 0 else 0
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16

    def f(q_, k_, v_):
        return _flash_xla(q_.transpose(0, 2, 1, 3), k_.transpose(0, 2, 1, 3),
                          v_.transpose(0, 2, 1, 3), q_pos, k_pos,
                          kw["causal"], kw.get("window", 0),
                          block).transpose(0, 2, 1, 3)
    xs = [jnp.asarray(x.float().numpy()).astype(jdt) for x in (tq, tk, tv)]
    _, vjp = jax.vjp(f, *xs)
    want = vjp(jnp.asarray(tg.float().numpy()).astype(jdt))
    errs = rel_errors([x.float().numpy() for x in got],
                      [np.asarray(x, np.float32) for x in want])
    assert max(errs) <= TOL[dtype], dict(zip("qkv", errs))
    live = live_rows(Sq, Sk, off, **kw)
    assert torch.equal(got[0][:, :, ~live], torch.zeros_like(
        got[0][:, :, ~live]))
    n = kw.get("seq_k")
    if n is not None:
        for d in got[1:]:
            assert torch.equal(d[:, :, n:], torch.zeros_like(d[:, :, n:]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(CASES))
def test_tiled_gradient_with_lse_matches_autograd(case, dtype):
    """The same algebra against autograd through ``attention_ref`` on the
    same ``dtype`` inputs, and (fp32) against the plain backward
    (``attention_bwd``) at the same lse, each gradient within 2e-5 / 2e-2
    of its max."""
    B, H, KV, Sq, Sk, hd, off, kw = CASES[case]
    q, k, v, g = inputs(len(case) + 2, B, H, KV, Sq, Sk, hd)
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    o, lse = port_forward(tq, tk, tv, off, kw, dtype)
    got = fa.attention_bwd_tiled_ref(tq, tk, tv, o, tg, lse, q_offset=off,
                                     **kw)
    xs = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    want = [torch.autograd.grad(fa.attention_ref(*xs, q_offset=off, **kw),
                                xs, tg)]
    if dtype == torch.float32:
        want.append(fa.attention_bwd(tq, tk, tv, o, lse, tg, q_offset=off,
                                     **kw))
    for w in want:
        errs = rel_errors([x.float().numpy() for x in got],
                          [x.float().numpy() for x in w])
        assert max(errs) <= TOL[dtype], dict(zip("qkv", errs))


def test_tf32_split_rounds_as_the_kernel_does():
    """``_tf32``: to nearest with ties away from zero (cvt.rna's rounding,
    the kernel's two integer operations) keeps 10 mantissa bits, within
    2^-11 of x; cut, within 2^-10 and toward zero. ``_mm_tf32x3`` of fp32
    operands stays within 2^-19 of the fp64 product's scale, one TF32
    product does not."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy((rng.normal(size=4096) * 2.0 ** rng.integers(
        -20, 20, 4096)).astype(np.float32))
    for rounded, bound in ((True, 2.0 ** -11), (False, 2.0 ** -10)):
        t = fa._tf32(x, rounded)
        assert bool(((t.view(torch.int32) & 0x1fff) == 0).all())
        assert bool(((t - x).abs() <= bound * x.abs()).all())
        if not rounded:
            assert bool((t.abs() <= x.abs()).all())
    ties = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11),
                         1 + 3 * 2.0 ** -11], dtype=torch.float32)
    assert fa._tf32(ties).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10),
                                       1 + 2 * 2.0 ** -10]
    a = torch.from_numpy(rng.normal(size=(16, 256)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(256, 8)).astype(np.float32))
    exact = a.double() @ b.double()
    scale = float((a.double().abs() @ b.double().abs()).max())
    split = fa._mm_tf32x3("ik,kj->ij", a, b).double()
    one = (fa._tf32(a) @ fa._tf32(b)).double()
    assert float((split - exact).abs().max()) <= 2.0 ** -19 * scale
    assert float((one - exact).abs().max()) > 2.0 ** -14 * scale


@pytest.mark.parametrize("case", ["hd 16, G 1, causal",
                                  "hd 32, rows with no live key",
                                  "hd 256, G 10, window, chunk at 48"])
def test_cpu_wrappers_take_and_give_lse(case):
    """On CPU tensors ``flash_attention_bhsd(..., return_lse=True)`` is
    ``attention_ref``'s o and lse, and ``flash_attention_bwd_bhsd`` given
    that lse is ``attention_bwd`` at it (without one, at ``attention_lse``,
    within 1e-6 of it); on the meta device both keep their shapes."""
    B, H, KV, Sq, Sk, hd, off, kw = CASES[case]
    q, k, v, g = map(torch.from_numpy, inputs(9, B, H, KV, Sq, Sk, hd))
    o, lse = fa.flash_attention_bhsd(q, k, v, q_offset=off, return_lse=True,
                                     **kw)
    want_o, want_lse = fa.attention_ref(q, k, v, q_offset=off,
                                        return_lse=True, **kw)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)
    live = torch.from_numpy(live_rows(Sq, Sk, off, **kw))
    plain = fa.attention_lse(q, k, q_offset=off, **kw)
    assert float((lse - plain)[:, :, live].abs().max()) <= 1e-6
    got = fa.flash_attention_bwd_bhsd(q, k, v, o, g, lse=lse, q_offset=off,
                                      **kw)
    want = fa.attention_bwd(q, k, v, o, lse, g, q_offset=off, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    meta = [x.to("meta") for x in (q, k, v)]
    o_m, lse_m = fa.flash_attention_bhsd(*meta, q_offset=off,
                                         return_lse=True, **kw)
    assert o_m.shape == q.shape and lse_m.shape == (B, H, Sq)
    assert lse_m.dtype == torch.float32 and lse_m.is_meta


# (B, KV, Sq, Sk, seq_k, causal, window, q_offset, G, hd, dtype): the main
# paths' gradient shapes (recurrentgemma-2b's train step, a context-parallel
# rank 3 chunk, smollm-360m's, the train launcher's, the finetune's) and a
# rows-with-no-live-key case
SEGMENT_SHAPES = [
    (4, 1, 2560, 2560, 2560, True, 2048, 0, 10, 256, torch.float32),
    (4, 1, 128, 512, 512, True, 2048, 384, 10, 256, torch.float32),
    (8, 5, 512, 512, 512, True, 0, 0, 3, 64, torch.bfloat16),
    (8, 4, 192, 192, 192, True, 0, 0, 2, 32, torch.bfloat16),
    (6, 4, 54, 54, 54, True, 0, 0, 2, 32, torch.bfloat16),
    (1, 1, 16, 24, 20, False, 6, 20, 3, 32, torch.float32),
]


@pytest.mark.parametrize("shape", range(len(SEGMENT_SHAPES)))
def test_bwd_segments_cover_every_walk_in_at_most_four(shape):
    """``bwd_segments``' cuts, which the gradient kernel takes as given:
    every key tile's row walk (``live_query_tiles``) and, where its grid is
    under ``BWD_FILL`` blocks, every row tile's key walk
    (``live_key_tiles``) falls in at most ``BWD_MAX_SEGS`` runs, the
    longest in exactly nseg (qnseg), each run at least 2 tiles; an uncut
    walk is one whole segment."""
    B, KV, Sq, Sk, seq_k, causal, window, off, G, hd, dt = \
        SEGMENT_SHAPES[shape]
    step = fa.bwd_step(hd, dt)
    seg, nseg, qseg, qnseg = fa.bwd_segments(B, KV, Sq, Sk, seq_k, causal,
                                             window, off, G, step)
    walks = [len(fa.live_query_tiles(k0, k0 + fa.BWD_HELD - 1, Sq, seq_k,
                                     causal, window, step, off, G))
             for k0 in range(0, Sk, fa.BWD_HELD)]
    assert seg >= 2 and 1 <= nseg <= fa.BWD_MAX_SEGS
    assert max(-(-n // seg) for n in walks) == max(nseg, 1 if walks else 0)
    n_rows = G * Sq
    qwalks = [len(fa.live_key_tiles(r0 // G, (min(r0 + fa.BWD_HELD, n_rows)
                                              - 1) // G, Sq, seq_k, causal,
                                    window, step, off))
              for r0 in range(0, n_rows, fa.BWD_HELD)]
    if -(-n_rows // fa.BWD_HELD) * KV * B >= fa.BWD_FILL:
        assert (qseg, qnseg) == (fa.BWD_WHOLE, 1)
    elif qnseg == 1:
        assert qseg == fa.BWD_WHOLE
    else:
        assert qseg >= 2 and qnseg <= fa.BWD_MAX_SEGS
        assert max(-(-n // qseg) for n in qwalks) == qnseg
    assert all(-(-n // qseg) <= qnseg for n in qwalks)
