"""Flash attention's gradient kernel (``csrc/flash_bwd.cu``) on the CPU:
its algebra and its tile rules.

``attention_bwd_tiled_ref`` repeats the kernel's tiles, order of sums and
roundings (rows the (query, head) pairs of a KV head; lse from the
forward, delta a row; dK/dV a key tile over ``live_query_tiles``, dq a row
tile over ``live_key_tiles``). It is held against ``jax.vjp`` of the reference's
``_flash_xla`` (its custom VJP, key blocks of 8, queries at their global
positions, keys past ``seq_k`` at position -1) and against autograd through
``attention_ref``, at head dims 16-256, GQA groups of 1, 3, 5 and 10,
causal and not, windows shorter than the sequence, ragged ``seq_k``, a
context-parallel chunk's offset and rows with no live key. Beside it:
``live_query_tiles`` never skips a live pair, ``flash_attention_bwd_bhsd``
is the plain backward on CPU tensors and reports ``cost.flash_bwd_work``
under ``flashattn`` on the CPU and the meta device. The kernel itself runs
on the card: tests/test_torch_cuda.py.

Inputs come from numpy seeds. Tolerances: 2e-5 of each gradient's max in
fp32, 2e-2 in bf16 (``test_kernels.py``'s own for flash).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import _flash_xla  # noqa: E402
from repro_torch.distributed import cost  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402

# label -> (B, H, KV, Sq, Sk, hd, q_offset, kwargs)
CASES = {
    "hd 16, G 1, causal": (2, 2, 2, 40, 40, 16, 0, dict(causal=True)),
    "hd 32, G 3, causal, ragged seq_k": (1, 6, 2, 37, 37, 32, 0,
                                         dict(causal=True, seq_k=30)),
    "hd 64, G 5, non-causal": (1, 5, 1, 33, 45, 64, 0, dict(causal=False)),
    "hd 256, G 10, window": (1, 10, 1, 96, 96, 256, 0,
                             dict(causal=True, window=40)),
    "hd 256, G 10, window, chunk 3 of 4": (1, 10, 1, 32, 128, 256, 96,
                                           dict(causal=True, window=48)),
    "hd 32, G 3, chunk 1 of 4": (2, 6, 2, 16, 64, 32, 16, dict(causal=True)),
    "hd 16, G 1, non-causal window": (1, 4, 4, 24, 40, 16, 0,
                                      dict(causal=False, window=6)),
    "rows with no live key": (1, 3, 1, 16, 24, 16, 20,
                              dict(causal=False, window=6, seq_k=20)),
    "hd 64, G 5, non-causal, ragged seq_k": (2, 10, 2, 20, 50, 64, 0,
                                             dict(causal=False, seq_k=41)),
    "hd 256, G 1, causal, past a row tile": (1, 1, 1, 70, 70, 256, 0,
                                             dict(causal=True)),
}


def inputs(seed, B, H, KV, Sq, Sk, hd):
    """q, k, v and the output gradient g, fp32 numpy."""
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in ((B, H, Sq, hd), (B, KV, Sk, hd), (B, KV, Sk, hd),
                      (B, H, Sq, hd))]


def flash_xla_at(Sq, Sk, off, causal=True, window=0, seq_k=None):
    """A function of (q, k, v) in the port's layout: the reference's
    ``_flash_xla`` (custom VJP, key blocks of 8 where they divide Sk) with
    queries at ``off + arange(Sq)`` and keys past ``seq_k`` at position -1,
    which its mask leaves dead."""
    q_pos = jnp.arange(off, off + Sq)
    k_pos = jnp.arange(Sk)
    if seq_k is not None:
        k_pos = jnp.where(k_pos < seq_k, k_pos, -1)
    block = 8 if Sk % 8 == 0 else 0

    def f(q_, k_, v_):
        o = _flash_xla(q_.transpose(0, 2, 1, 3), k_.transpose(0, 2, 1, 3),
                       v_.transpose(0, 2, 1, 3), q_pos, k_pos, causal,
                       window, block)
        return o.transpose(0, 2, 1, 3)
    return f


def rel_errors(got, want):
    """Each gradient's max abs error over its max magnitude."""
    out = []
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        scale = float(np.abs(b).max()) or 1.0
        out.append(float(np.abs(a - b).max()) / scale)
    return out


def tiled(q, k, v, g, off, kw, dtype=torch.float32):
    """``attention_bwd_tiled_ref`` at the port's forward output and lse
    (the kernel's algebra: ``attention_tiled_ref`` in bf16, ``attention_ref``
    in fp32)."""
    tq, tk, tv, tg = (torch.from_numpy(a).to(dtype) for a in (q, k, v, g))
    fwd = fa.attention_ref if dtype == torch.float32 else \
        fa.attention_tiled_ref
    o, lse = fwd(tq, tk, tv, q_offset=off, return_lse=True, **kw)
    return fa.attention_bwd_tiled_ref(tq, tk, tv, o, tg, lse, q_offset=off,
                                      **kw)


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_gradient_matches_reference_vjp(case):
    """The kernel's algebra against ``jax.vjp`` of the reference's
    ``_flash_xla`` at the same positions: dq, dk, dv each within 2e-5 of
    its max."""
    B, H, KV, Sq, Sk, hd, off, kw = CASES[case]
    q, k, v, g = inputs(len(case), B, H, KV, Sq, Sk, hd)
    got = tiled(q, k, v, g, off, kw)
    for x, want in zip(got, (q, k, v)):
        assert x.dtype == torch.float32 and x.shape == want.shape
    _, vjp = jax.vjp(flash_xla_at(Sq, Sk, off, **kw),
                     *map(jnp.asarray, (q, k, v)))
    want = vjp(jnp.asarray(g))
    errs = rel_errors([x.numpy() for x in got], want)
    assert max(errs) <= 2e-5, dict(zip("qkv", errs))


@pytest.mark.parametrize("case", list(CASES))
def test_tiled_gradient_matches_autograd_and_plain_backward(case):
    """The kernel's algebra against autograd through ``attention_ref`` and
    against the plain backward (``attention_lse`` + ``attention_bwd``, what
    ``flash_attention_bwd_bhsd`` runs on CPU tensors), each gradient within
    2e-5 of its max; keys past ``seq_k`` get exact zeros."""
    B, H, KV, Sq, Sk, hd, off, kw = CASES[case]
    q, k, v, g = inputs(len(case) + 1, B, H, KV, Sq, Sk, hd)
    got = tiled(q, k, v, g, off, kw)
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.attention_ref(tq, tk, tv, q_offset=off, **kw)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    plain = fa.flash_attention_bwd_bhsd(tq.detach(), tk.detach(),
                                        tv.detach(), out.detach(),
                                        torch.from_numpy(g), q_offset=off,
                                        **kw)
    for want in (auto, plain):
        errs = rel_errors([x.numpy() for x in got], [x.numpy() for x in want])
        assert max(errs) <= 2e-5, dict(zip("qkv", errs))
    n = kw.get("seq_k")
    if n is not None:
        for d in got[1:]:
            assert torch.equal(d[:, :, n:], torch.zeros_like(d[:, :, n:]))


@pytest.mark.parametrize("case", ["hd 32, G 3, causal, ragged seq_k",
                                  "hd 256, G 10, window, chunk 3 of 4",
                                  "hd 64, G 5, non-causal, ragged seq_k"])
def test_tiled_gradient_in_bf16(case):
    """bf16 inputs (the protein finetune's dtype): the gradients come out
    in bf16, within 2e-2 of each max of autograd through ``attention_ref``
    on the same bf16 inputs."""
    B, H, KV, Sq, Sk, hd, off, kw = CASES[case]
    q, k, v, g = inputs(len(case) + 2, B, H, KV, Sq, Sk, hd)
    got = tiled(q, k, v, g, off, kw, torch.bfloat16)
    assert all(x.dtype == torch.bfloat16 for x in got)
    xs = [torch.from_numpy(a).bfloat16().requires_grad_() for a in (q, k, v)]
    want = torch.autograd.grad(fa.attention_ref(*xs, q_offset=off, **kw), xs,
                               torch.from_numpy(g).bfloat16())
    errs = rel_errors([x.float().numpy() for x in got],
                      [x.float().numpy() for x in want])
    assert max(errs) <= 2e-2, dict(zip("qkv", errs))


def test_rows_without_live_keys_get_zero_gradients():
    """Rows whose window ends before their first key (positions past
    ``seq_k`` + window) take zero dq, and keys that no row reads zero dk
    and dv, in the kernel's algebra and the plain backward alike."""
    B, H, KV, Sq, Sk, hd, off, kw = CASES["rows with no live key"]
    q, k, v, g = inputs(5, B, H, KV, Sq, Sk, hd)
    dq, dk, dv = tiled(q, k, v, g, off, kw)
    pos = off + np.arange(Sq)
    dead = pos - kw["window"] + 1 >= kw["seq_k"]
    assert dead.any() and not dead.all()
    assert torch.equal(dq[:, :, dead], torch.zeros_like(dq[:, :, dead]))
    assert bool((dq[:, :, ~dead] != 0).any())
    first = int(pos[0]) - kw["window"] + 1         # the first key read
    for d in (dk, dv):
        assert torch.equal(d[:, :, :first], torch.zeros_like(d[:, :, :first]))


@pytest.mark.parametrize("Sq,Sk,off,causal,window,seq_k,G", [
    (40, 40, 0, True, 0, 40, 1),
    (37, 37, 0, True, 0, 30, 3),
    (33, 45, 0, False, 0, 45, 5),
    (96, 96, 0, True, 40, 96, 10),
    (32, 128, 96, True, 48, 128, 10),
    (24, 40, 0, False, 6, 40, 1),
    (16, 24, 20, False, 6, 20, 3),
    (128, 512, 384, True, 2048, 512, 10),
])
def test_live_query_tiles_never_skip_a_live_pair(Sq, Sk, off, causal, window,
                                                 seq_k, G):
    """Every live (row, key) pair's row tile lies in its key tile's
    ``live_query_tiles``, and every tile in the range holds a live row for
    the key tile (the range is tight at row granularity); rows are the
    (query, head) pairs, row r = query r // G; keys in the kernel's held
    tiles, rows in each of its steps (``bwd_step`` of every head dim)."""
    bk = fa.BWD_HELD
    rows = np.arange(G * Sq)
    pos = rows[:, None] // G + off
    keys = np.arange(Sk)[None, :]
    live = np.broadcast_to(keys < seq_k, (G * Sq, Sk))
    if causal:
        live = live & (keys <= pos)
    if window > 0:
        live = live & (keys > pos - window)
    for bq in sorted({fa.bwd_step(hd, dt) for hd in fa.HEAD_DIMS
                      for dt in fa.DTYPES}):
        n_tiles = -(-G * Sq // bq)
        for t in range(-(-Sk // bk)):
            tiles = fa.live_query_tiles(t * bk, (t + 1) * bk - 1, Sq, seq_k,
                                        causal, window, bq, off, G)
            held = live[:, t * bk:(t + 1) * bk].any(-1)
            want = sorted({int(r) // bq for r in rows[held]})
            assert list(tiles) == list(range(want[0], want[-1] + 1)) \
                if want else len(tiles) == 0, (bq, t)
            assert all(0 <= u < n_tiles for u in tiles)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_meta_backward_shapes_and_cost(dtype):
    """On the meta device ``FlashAttention``'s backward returns empty
    gradients of the inputs' shapes and dtypes and reports
    ``cost.flash_bwd_work`` under ``flashattn``; so does the CPU
    backward."""
    B, H, KV, Sq, Sk, hd, off, kw = CASES["hd 32, G 3, chunk 1 of 4"]
    q, k, v, g = (torch.from_numpy(a).to(dtype)
                  for a in inputs(7, B, H, KV, Sq, Sk, hd))
    elem = q.element_size()
    flops, nbytes = cost.flash_bwd_work(B, H, KV, Sq, Sk, hd, elem, elem,
                                        kw["causal"], 0, off)
    pairs = cost.live_pairs(Sq, Sk, kw["causal"], 0, off)
    assert flops == 10 * hd * B * H * pairs
    assert nbytes == (4 * B * H * Sq * hd + 4 * B * KV * cost.live_keys(
        Sq, Sk, kw["causal"], 0, off) * hd) * elem
    for dev in ("meta", "cpu"):
        xs = [x.to(dev).requires_grad_() for x in (q, k, v)]
        out = fa.flash_attention_grad(*xs, q_offset=off, **kw)
        with cost.counting() as c:
            got = torch.autograd.grad(out, xs, g.to(dev))
        for a, x in zip(got, xs):
            assert a.shape == x.shape and a.dtype == x.dtype
            assert a.is_meta == (dev == "meta")
        tagged = c.select("flashattn")
        assert (tagged.flops, tagged.bytes) == (flops, nbytes)
        with cost.counting() as c:
            got = fa.flash_attention_bwd_bhsd(*(x.detach() for x in xs),
                                              out.detach(), g.to(dev),
                                              q_offset=off, **kw)
        assert [x.shape for x in got] == [x.shape for x in xs]
        assert (c.select("flashattn").flops, c.total.flops) == (flops, flops)


@pytest.mark.parametrize("case", ["hd 16, G 1, causal",
                                  "rows with no live key",
                                  "hd 256, G 10, window, chunk 3 of 4"])
def test_cpu_wrapper_is_the_plain_backward(case):
    """On CPU tensors ``flash_attention_bwd_bhsd`` is ``attention_lse`` +
    ``attention_bwd`` to the bit, and ``FlashAttention``'s backward hands
    it autograd's transposed upstream view unchanged in value."""
    B, H, KV, Sq, Sk, hd, off, kw = CASES[case]
    q, k, v, g = map(torch.from_numpy, inputs(9, B, H, KV, Sq, Sk, hd))
    o = fa.attention_ref(q, k, v, q_offset=off, **kw)
    got = fa.flash_attention_bwd_bhsd(q, k, v, o, g, q_offset=off, **kw)
    lse = fa.attention_lse(q, k, q_offset=off, **kw)
    want = fa.attention_bwd(q, k, v, o, lse, g, q_offset=off, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    out = fa.flash_attention_grad(*xs, q_offset=off, **kw)
    view = g.transpose(1, 2).contiguous().transpose(1, 2)
    for a, b in zip(torch.autograd.grad(out, xs, view), want):
        assert torch.equal(a, b)
