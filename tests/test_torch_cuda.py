"""The port's CUDA kernels and its main path on the card, against their
plain versions. Every test here is marked ``cuda`` and skips without a
CUDA device; the file imports torch and numpy only, so it also runs on a
machine without JAX:

  PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: paged decode and rglru's gradient through autograd 1e-5 in
fp32 (rglru's kernels bitwise their plain versions), flash and wkv6 y 2e-5
in fp32, all 2e-2 in bf16, the wkv6 state atol 1e-4 / rtol 1e-3 (the CPU
tests' own); gradients 2e-5 (fp32) / 2e-2 (bf16) of each gradient's max;
log-likelihoods 1e-3 (sums of 24 fp32 log-probs computed in two
orders)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.kernels import _cuda  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rglru  # noqa: E402
from repro_torch.kernels import rwkv6  # noqa: E402

pytestmark = pytest.mark.cuda
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_and_count_launches(cuda, dtype):
    dt = TORCH_DT[dtype]
    g = torch.Generator(device=cuda).manual_seed(0)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dt)
    B, KV, G, hd, page, maxp = 24, 4, 2, 32, 8, 11
    P = B * maxp + 1
    q, kp, vp = mk(B, KV, G, hd), mk(P, KV, page, hd), mk(P, KV, page, hd)
    bt = torch.randperm(P - 1, generator=g, device=cuda)[:B * maxp] \
        .reshape(B, maxp).int()
    lens = torch.randint(0, maxp * page + 1, (B,), generator=g,
                         device=cuda).int()
    lens[::5] = 0
    before = dict(_cuda.launches)
    got = pa.paged_decode_bkgh(q, kp, vp, bt, lens, page_size=page)
    want = pa.paged_decode_ref(q, kp, vp, bt, lens, page_size=page)
    t = 1e-5 if dtype == "float32" else 2e-2
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    atol=t, rtol=t)
    assert bool((got[lens == 0] == 0).all())
    t = 2e-5 if dtype == "float32" else 2e-2
    for S, kw in ((32, {}), (65, {"window": 24}), (48, {"softcap": 20.0})):
        q, k, v = mk(4, 8, S, 32), mk(4, 4, S, 32), mk(4, 4, S, 32)
        got = fa.flash_attention_bhsd(q, k, v, **kw)
        want = fa.attention_ref(q, k, v, **kw)
        assert_allclose(got.float().cpu().numpy(),
                        want.float().cpu().numpy(), atol=t, rtol=t)
    assert _cuda.launches["paged_decode_bkgh"] == \
        before["paged_decode_bkgh"] + 1
    assert _cuda.launches["flash_attention_bhsd"] == \
        before["flash_attention_bhsd"] + 3


def test_kernels_reject_bad_inputs(cuda):
    q = torch.zeros(1, 2, 8, 24, device=cuda)          # head dim 24
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, q, q)
    q = torch.zeros(1, 2, 8, 32, device=cuda)
    before = _cuda.launches["flash_attention_bhsd"]
    for S in (8, 1):                                   # fp32 q, bf16 K/V
        kv = torch.ones(1, 2, 8, 32, device=cuda).bfloat16()
        out = fa.flash_attention_bhsd(q[:, :, :S].contiguous(), kv, kv)
        assert out.dtype == torch.float32 and bool((out == 1).all())
    assert _cuda.launches["flash_attention_bhsd"] == before + 2
    for qs in (q, q[:, :, :1].contiguous()):
        with pytest.raises(TypeError):                 # bf16 q, fp32 K/V
            fa.flash_attention_bhsd(qs.bfloat16(), q, q)
        with pytest.raises(TypeError):                 # K and V differ
            fa.flash_attention_bhsd(qs, q.bfloat16(), q)
        with pytest.raises(ValueError):                # inner stride 2
            kv = torch.zeros(1, 2, 8, 64, device=cuda)[..., ::2]
            fa.flash_attention_bhsd(qs, kv, kv)
    with pytest.raises(ValueError):                    # not contiguous
        fa.flash_attention_bhsd(q.transpose(2, 3).contiguous()
                                .transpose(2, 3), q, q)
    with pytest.raises(ValueError):                    # not 16-byte aligned
        kv = torch.zeros(2 * 8 * 32 + 1, device=cuda)[1:].view(1, 2, 8, 32)
        fa.flash_attention_bhsd(q[:, :, :1].contiguous(), kv, kv)
    assert _cuda.launches["flash_attention_bhsd"] == before + 2


@pytest.mark.parametrize("qdt,kvdt", [("float32", "bfloat16"),
                                      ("float32", "float32"),
                                      ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("B,H,KV,L,n,hd", [
    (8, 10, 1, 2048, 2048, 256), (2, 10, 1, 2048, 1, 256),
    (3, 2, 1, 2048, 127, 256), (2, 4, 4, 2048, 1337, 256),
    (1, 20, 1, 300, 300, 256), (2, 8, 4, 96, 43, 32), (2, 4, 2, 64, 64, 16),
    (3, 4, 1, 500, 333, 64), (2, 6, 3, 200, 150, 128),
    (34, 8, 4, 96, 43, 32), (40, 20, 4, 300, 257, 64)])
def test_flash_decode_form_over_ring_views(cuda, qdt, kvdt, B, H, KV, L, n,
                                           hd):
    """The decode form as ``attn_decode`` calls it: one query a head over
    the first n slots of a (B, L, KV, hd) ring, handed over as a strided
    view in the cache's dtype (bf16 beside an fp32 q on the recurrentgemma
    path); query groups of 20, 10, 2 and 1; more key ranges than keys; and
    136 or 160 blocks, one key range each (no combine) on an H100's 132
    SMs. One launch a call."""
    if B * KV > 132:
        assert fa.decode_splits(B * KV, _cuda.sm_count(cuda)) == 1
    g = torch.Generator(device=cuda).manual_seed(n)
    q = torch.randn(B, H, 1, hd, generator=g, device=cuda).to(TORCH_DT[qdt])
    k, v = (torch.randn(B, L, KV, hd, generator=g, device=cuda)
            .to(TORCH_DT[kvdt])[:, :n].transpose(1, 2) for _ in range(2))
    before = _cuda.launches["flash_attention_bhsd"]
    got = fa.flash_attention_bhsd(q, k, v, causal=False)
    assert _cuda.launches["flash_attention_bhsd"] == before + 1
    want = fa.attention_ref(q, k, v, causal=False)
    assert got.dtype == q.dtype
    t = 2e-5 if qdt == "float32" else 2e-2
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    atol=t, rtol=t)


@pytest.mark.parametrize("hd", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("B,H,KV,S,kw", [
    (2, 4, 2, 77, dict(seq_q=70, seq_k=61)),
    (1, 4, 1, 130, dict(window=33, softcap=10.0)),
    (2, 2, 2, 65, dict(causal=False)),
    (1, 3, 1, 100, dict(causal=False, seq_k=40, window=9))])
def test_flash_fp32_sequence_form(cuda, hd, B, H, KV, S, kw):
    """The register-tiled fp32 form at every head dim: ragged lengths (rows
    past seq_q exactly zero), a window with softcap, no mask, and rows with
    no live key. One launch a call."""
    g = torch.Generator(device=cuda).manual_seed(hd + S)
    q = torch.randn(B, H, S, hd, generator=g, device=cuda)
    k = torch.randn(B, KV, S, hd, generator=g, device=cuda)
    v = torch.randn(B, KV, S, hd, generator=g, device=cuda)
    before = _cuda.launches["flash_attention_bhsd"]
    got = fa.flash_attention_bhsd(q, k, v, **kw)
    assert _cuda.launches["flash_attention_bhsd"] == before + 1
    want = fa.attention_ref(q, k, v, **kw)
    if "seq_q" in kw:
        assert bool((got[:, :, kw["seq_q"]:] == 0).all())
    assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=2e-5,
                    rtol=2e-5)


@pytest.mark.parametrize("B,H,KV,S,hd,kw", [
    (4, 8, 8, 32, 32, {}),                     # foldscore-s predict_batch
    (1, 8, 4, 31, 32, {}),                     # progen-s admission prefill
    (1, 8, 4, 65, 32, {}),                     # progen-s frontend_seq + 1
    (2, 8, 4, 33, 32, {}),                     # one key past a tile
    (2, 8, 2, 70, 256, {}),                    # hd 256, GQA
    (2, 10, 1, 100, 256, dict(window=40)),     # hd 256, MQA, 10 heads
    (1, 4, 2, 80, 16, dict(softcap=5.0)), (1, 2, 2, 64, 64, {}),
    (1, 2, 1, 40, 128, dict(window=7)),
    (2, 4, 2, 77, 32, dict(seq_q=70, seq_k=61)),
    (1, 3, 1, 100, 64, dict(causal=False, seq_k=40, window=9)),
    (2, 4, 4, 50, 32, dict(causal=False))])
def test_flash_bf16_sequence_form(cuda, B, H, KV, S, hd, kw):
    """The mma.sync form at the protein path's shapes (GQA prefill, S = 65,
    one key past a tile), at hd 256 with GQA and MQA, and with ragged
    lengths, a window with no key for some rows, softcap and no mask:
    against the plain version and the tiled algebra it repeats; rows with
    no live key exactly zero. One launch a call, counted as the bf16
    sequence form."""
    g = torch.Generator(device=cuda).manual_seed(S * hd)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).bfloat16()
    q, k, v = mk(B, H, S, hd), mk(B, KV, S, hd), mk(B, KV, S, hd)
    before = _cuda.forms["flash_attention_bhsd"]["seq_bf16"]
    got = fa.flash_attention_bhsd(q, k, v, **kw)
    assert _cuda.forms["flash_attention_bhsd"]["seq_bf16"] == before + 1
    assert got.dtype == torch.bfloat16
    got = got.float().cpu().numpy()
    for ref in (fa.attention_ref, fa.attention_tiled_ref):
        want = ref(q, k, v, **kw).float().cpu().numpy()
        assert_allclose(got, want, atol=2e-2, rtol=2e-2)
    rows = np.arange(S)
    no_key = rows >= kw.get("seq_q", S)
    if kw.get("window", 0) > 0 and not kw.get("causal", True):
        no_key |= rows - kw["window"] + 1 >= kw.get("seq_k", S)
    assert np.all(got[:, :, no_key] == 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,off,kw", [
    (2, 4, 2, 128, 512, 64, 0, {}),            # chunk 0 of 4
    (2, 4, 2, 128, 512, 64, 384, {}),          # chunk 3 of 4
    (2, 15, 5, 128, 512, 64, 256, {}),         # smollm-360m's CP rank 2
    (1, 10, 1, 160, 640, 256, 480, dict(window=300)),  # window past off
    (1, 4, 2, 1, 96, 32, 70, {}),              # a one-query chunk
    (1, 3, 1, 1, 96, 128, 70, dict(window=9)),
    (1, 2, 1, 40, 64, 32, 100, dict(causal=False, window=8)),  # no key
    (2, 4, 4, 64, 256, 16, 64, dict(softcap=5.0))])
def test_flash_sequence_forms_at_an_offset(cuda, dtype, B, H, KV, Sq, Sk, hd,
                                           off, kw):
    """Both sequence forms (and the decode form for one query) at a query
    offset, a context-parallel rank's chunk: against the plain version
    (the bf16 form also against its tiled algebra), the chunk's rows
    against the whole call's rows [off, off + Sq) where the chunk lies
    inside the keys, rows with no live key exactly zero. One launch a
    call."""
    dt = TORCH_DT[dtype]
    g = torch.Generator(device=cuda).manual_seed(Sq + off + hd)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dt)  # noqa
    q, k, v = mk(B, H, Sq, hd), mk(B, KV, Sk, hd), mk(B, KV, Sk, hd)
    kw = dict(causal=True, **kw) if "causal" not in kw else kw
    before = _cuda.launches["flash_attention_bhsd"]
    got = fa.flash_attention_bhsd(q, k, v, q_offset=off, **kw)
    assert _cuda.launches["flash_attention_bhsd"] == before + 1
    t = 2e-5 if dtype == "float32" else 2e-2
    refs = [fa.attention_ref]
    if dtype == "bfloat16" and Sq > 1:
        refs.append(fa.attention_tiled_ref)
    for ref in refs:
        want = ref(q, k, v, q_offset=off, **kw)
        assert_allclose(got.float().cpu().numpy(),
                        want.float().cpu().numpy(), atol=t, rtol=t)
    if off + Sq <= Sk and Sq > 1:
        qs = torch.zeros(B, H, off + Sq, hd, device=cuda, dtype=dt)
        qs[:, :, off:] = q
        whole = fa.flash_attention_bhsd(qs, k, v, **kw)
        assert_allclose(got.float().cpu().numpy(),
                        whole[:, :, off:].float().cpu().numpy(), atol=t,
                        rtol=t)
    live = cost_live_rows(Sq, Sk, off, kw)
    assert bool((got[:, :, ~live] == 0).all())


def cost_live_rows(Sq, Sk, off, kw):
    """Which of a chunk's rows have a live key (the plain mask's)."""
    mask = fa._mask(Sq, torch.arange(Sk), kw.get("causal", True),
                    kw.get("window", 0), Sq, Sk, off, "cpu")
    return mask.any(-1).to("cuda")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,causal", [
    (2, 32, 2, 40, 40, 128, True),             # chatglm3-6b, G = 16
    (1, 56, 8, 37, 37, 128, True),             # llava-next-34b, G = 7
    (2, 15, 5, 33, 33, 64, True),              # smollm-360m, G = 3
    (1, 12, 12, 300, 300, 64, False),          # whisper encoder, mid-tile
    (2, 12, 12, 9, 1500, 64, False),           # whisper cross prefill
    (2, 12, 12, 1, 1500, 64, False),           # whisper cross decode
    (2, 32, 2, 1, 75, 128, False)])            # chatglm3-6b decode, G = 16
def test_flash_at_the_dense_decoders_and_whispers_shapes(
        cuda, dtype, B, H, KV, Sq, Sk, hd, causal):
    """The dense decoders' and whisper's shapes: GQA groups of 16, 7 and
    3 at hd 128 and 64, a bidirectional pass whose keys end mid-tile,
    cross-attention with Sq != Sk over 1500 frames (a contiguous copy) and
    one query over 1500 frames and over a G = 16 cache (strided views of a
    (B, Sk, KV, hd) cache, as ``attn_decode`` hands them). Against the
    plain version (and the bf16 sequence form also against the tiled
    algebra); one launch a call."""
    g = torch.Generator(device=cuda).manual_seed(Sq * Sk + H)
    dt = TORCH_DT[dtype]
    q = torch.randn(B, H, Sq, hd, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(B, Sk, KV, hd, generator=g, device=cuda).to(dt)
            .transpose(1, 2) for _ in range(2))
    if Sq > 1:
        k, v = k.contiguous(), v.contiguous()
    before = _cuda.launches["flash_attention_bhsd"]
    got = fa.flash_attention_bhsd(q, k, v, causal=causal)
    assert _cuda.launches["flash_attention_bhsd"] == before + 1
    t = 2e-5 if dtype == "float32" else 2e-2
    refs = [fa.attention_ref]
    if Sq > 1 and dtype == "bfloat16":
        refs.append(fa.attention_tiled_ref)
    for ref in refs:
        want = ref(q, k, v, causal=causal)
        assert_allclose(got.float().cpu().numpy(),
                        want.float().cpu().numpy(), atol=t, rtol=t)


PAGE, MAXP = 8, 9                        # 72 keys a row: 3 tiles of 32
PAGED_LENGTHS = (0, 1, 7, 8, 9, MAXP * PAGE, 40, 65)


def paged_case(device, seed, G, hd, dtype, lengths=PAGED_LENGTHS, KV=2):
    """Paged decode inputs on ``device``: every row's live pages drawn from
    a scrambled pool, every page past its length the trash page (the
    pool's last), which holds NaN."""
    rng = np.random.default_rng(seed)
    B = len(lengths)
    P = B * MAXP + 1
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    kp = rng.normal(size=(P, KV, PAGE, hd)).astype(np.float32)
    vp = rng.normal(size=(P, KV, PAGE, hd)).astype(np.float32)
    kp[P - 1] = vp[P - 1] = np.nan
    order = rng.permutation(P - 1)
    bt = np.full((B, MAXP), P - 1, np.int32)
    for b, n in enumerate(lengths):
        live = -(-n // PAGE)
        bt[b, :live] = order[b * MAXP:b * MAXP + live]
    t = lambda a, dt=None: torch.from_numpy(a).to(device, dt)
    return (t(q, dtype), t(kp, dtype), t(vp, dtype), t(bt),
            t(np.asarray(lengths, np.int32)))


@pytest.mark.parametrize("n_split", [None, 1, 2, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G,hd", [(1, 16), (2, 16), (4, 16), (1, 32),
                                  (2, 32), (4, 32), (2, 64), (8, 128),
                                  (20, 256)])
def test_paged_kernel_matches_plain(cuda, G, hd, dtype, n_split):
    """Rows of length 0, 1, 7, 8, 9, the full capacity, 40 and 65 over a
    scrambled pool with a NaN trash page past every row's length, at the
    range count ``paged_decode_splits`` chooses (1 here) and forced to 1, 2
    and 5 through the wrapper's internal argument: the plain version's
    output within 1e-5 (fp32) or 2e-2 (bf16), the split algebra's too;
    inactive rows exactly zero; one counted launch a call."""
    q, kp, vp, bt, lens = paged_case(cuda, G * hd, G, hd, TORCH_DT[dtype])
    before = _cuda.launches["paged_decode_bkgh"]
    if n_split is None:
        got = pa.paged_decode_bkgh(q, kp, vp, bt, lens, page_size=PAGE)
    else:
        got = pa._launch(q, kp, vp, bt, lens, PAGE, n_split)
    assert _cuda.launches["paged_decode_bkgh"] == before + 1
    want = pa.paged_decode_ref(q, kp, vp, bt, lens, page_size=PAGE)
    split = pa.paged_decode_split_ref(q, kp, vp, bt, lens, page_size=PAGE,
                                      n_split=n_split or 1)
    assert _cuda.launches["paged_decode_bkgh"] == before + 1
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    assert bool((got[lens == 0] == 0).all())
    t = 1e-5 if dtype == "float32" else 2e-2
    for ref in (want, split):
        assert_allclose(got.float().cpu().numpy(), ref.float().cpu().numpy(),
                        atol=t, rtol=t)


@pytest.mark.parametrize("n_split", [1, 3])
def test_paged_kernel_all_rows_inactive(cuda, n_split):
    """Every row of length 0 and every page the NaN trash page: exact
    zeros."""
    q, kp, vp, bt, lens = paged_case(cuda, 3, 2, 32, torch.bfloat16,
                                     lengths=(0,) * 24, KV=4)
    got = pa._launch(q, kp, vp, bt, lens, PAGE, n_split)
    assert torch.equal(got, torch.zeros_like(got))


def test_paged_kernel_rejects_bad_inputs(cuda):
    q, kp, vp, bt, lens = paged_case(cuda, 0, 2, 32, torch.float32)
    run = lambda *a, page=PAGE: pa.paged_decode_bkgh(*a, page_size=page)
    before = _cuda.launches["paged_decode_bkgh"]
    with pytest.raises(TypeError):                     # bf16 q, fp32 pages
        run(q.bfloat16(), kp, vp, bt, lens)
    with pytest.raises(TypeError):                     # K and V differ
        run(q, kp, vp.bfloat16(), bt, lens)
    with pytest.raises(TypeError):                     # int64 block table
        run(q, kp, vp, bt.long(), lens)
    with pytest.raises(TypeError):                     # int64 lengths
        run(q, kp, vp, bt, lens.long())
    with pytest.raises(ValueError):                    # pool not contiguous
        wide = torch.zeros(*kp.shape[:3], 64, device=cuda)[..., :32]
        run(q, wide, vp, bt, lens)
    with pytest.raises(ValueError):                    # not 16-byte aligned
        x = torch.zeros(kp.numel() + 1, device=cuda)[1:].view(kp.shape)
        run(q, x, vp, bt, lens)
    with pytest.raises(ValueError):                    # table of other rows
        run(q, kp, vp, bt[:-1].contiguous(), lens)
    with pytest.raises(ValueError):                    # lengths of others
        run(q, kp, vp, bt, torch.cat([lens, lens]))
    with pytest.raises(ValueError):                    # page size differs
        run(q, kp, vp, bt, lens, page=4)
    with pytest.raises(ValueError):                    # head dim 24
        x = torch.zeros(*kp.shape[:3], 24, device=cuda)
        run(torch.zeros(*q.shape[:3], 24, device=cuda), x, x, bt, lens)
    assert _cuda.launches["paged_decode_bkgh"] == before


def wkv_inputs(g, device, B, H, T, K, dtype):
    mk = lambda *s: torch.randn(*s, generator=g, device=device)
    r, k, v = (0.5 * mk(B, H, T, K)).to(dtype), (0.5 * mk(B, H, T, K)).to(
        dtype), (0.5 * mk(B, H, T, K)).to(dtype)
    logw = -torch.exp(mk(B, H, T, K))
    return r, k, v, logw, 0.3 + 0.1 * mk(H, K), 0.1 * mk(B, H, K, K)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,K", [(8, 64, 33, 64), (2, 4, 70, 16)])
def test_wkv6_matches_plain_and_counts_launches(cuda, dtype, B, H, T, K):
    dt = TORCH_DT[dtype]
    g = torch.Generator(device=cuda).manual_seed(T)
    args = wkv_inputs(g, cuda, B, H, T, K, dt)
    before = _cuda.launches["wkv6_bhtk"]
    y, s = rwkv6.wkv6_bhtk(*args)
    assert _cuda.launches["wkv6_bhtk"] == before + 1
    y_ref, s_ref = rwkv6.wkv6_ref(*args)
    assert _cuda.launches["wkv6_bhtk"] == before + 1
    assert y.dtype == dt and s.dtype == torch.float32
    t = 2e-5 if dtype == "float32" else 2e-2
    assert_allclose(y.float().cpu().numpy(), y_ref.float().cpu().numpy(),
                    atol=t, rtol=t)
    assert_allclose(s.cpu().numpy(), s_ref.cpu().numpy(), atol=1e-4,
                    rtol=1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,K,ends", [
    (8, 64, 512, 64, False), (8, 64, 1, 64, False), (2, 8, 2, 64, False),
    (2, 8, 31, 64, False), (2, 8, 40, 64, True), (2, 4, 70, 16, False),
    (2, 4, 33, 16, True)])
def test_wkv6_forms_match_plain(cuda, dtype, B, H, T, K, ends):
    """The prefill kernel (T > 1) at rwkv6-7b's prefill shape, at short and
    ragged T and with logw at -e^5 and -1e-6, and the decode kernel (T = 1):
    against the plain version and the prefill kernel's own algebra, each
    launch counted under its form."""
    dt = TORCH_DT[dtype]
    g = torch.Generator(device=cuda).manual_seed(T + K)
    args = wkv_inputs(g, cuda, B, H, T, K, dt)
    if ends:
        args[3][..., ::2] = -float(np.exp(5.0))
        args[3][..., 1::2] = -1e-6
    form = "decode" if T == 1 else "prefill"
    before = dict(_cuda.forms["wkv6_bhtk"])
    y, s = rwkv6.wkv6_bhtk(*args)
    want = dict(before, **{form: before[form] + 1})
    assert _cuda.forms["wkv6_bhtk"] == want
    t = 2e-5 if dtype == "float32" else 2e-2
    refs = [rwkv6.wkv6_ref] + ([rwkv6.wkv6_serial_ref] if T <= 70 else [])
    for ref in refs:
        y_ref, s_ref = ref(*args)
        assert_allclose(y.float().cpu().numpy(), y_ref.float().cpu().numpy(),
                        atol=t, rtol=t)
        assert_allclose(s.cpu().numpy(), s_ref.cpu().numpy(), atol=1e-4,
                        rtol=1e-3)


def test_wkv6_rejects_bad_inputs(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    r, k, v, logw, u, s0 = wkv_inputs(g, cuda, 1, 2, 5, 16, torch.float32)
    before = _cuda.launches["wkv6_bhtk"]
    with pytest.raises(TypeError):                     # bf16 logw
        rwkv6.wkv6_bhtk(r, k, v, logw.bfloat16(), u, s0)
    with pytest.raises(TypeError):                     # mixed r/k dtypes
        rwkv6.wkv6_bhtk(r, k.bfloat16(), v, logw, u, s0)
    with pytest.raises(ValueError):                    # not contiguous
        rwkv6.wkv6_bhtk(r.transpose(2, 3).contiguous().transpose(2, 3), k,
                        v, logw, u, s0)
    with pytest.raises(ValueError):                    # not 16-byte aligned
        x = torch.zeros(r.numel() + 1, device=cuda)[1:].view(r.shape)
        rwkv6.wkv6_bhtk(x, k, v, logw, u, s0)
    with pytest.raises(ValueError):                    # head dim 24
        x = torch.zeros(1, 2, 5, 24, device=cuda)
        rwkv6.wkv6_bhtk(x, x, x, x, x[0, :, 0], torch.zeros(1, 2, 24, 24,
                                                             device=cuda))
    assert _cuda.launches["wkv6_bhtk"] == before


def wkv_grad_case(g, device, B, H, T, K, dtype, ends):
    """wkv6 inputs (``wkv_inputs``; logw at -e^5 and -1e-6 where ``ends``)
    and the upstream dy (in ``dtype``) and dS (fp32)."""
    args = wkv_inputs(g, device, B, H, T, K, dtype)
    if ends:
        args[3][..., ::2] = -float(np.exp(5.0))
        args[3][..., 1::2] = -1e-6
    dy = torch.randn(B, H, T, K, generator=g, device=device).to(dtype)
    return args, dy, torch.randn(B, H, K, K, generator=g, device=device)


def hold_grads(got, want, dtype):
    """Each gradient within 2e-5 (fp32) / 2e-2 (bf16) of ``want``'s max, in
    its input's dtype."""
    t = 2e-5 if dtype == "float32" else 2e-2
    for name, a, b in zip(("r", "k", "v", "logw", "u", "s0"), got, want):
        assert a.dtype == b.dtype, name
        assert bool(torch.isfinite(a).all()), name
        err = float((a.float() - b.float()).abs().max())
        assert err <= t * float(b.float().abs().max()), (name, err)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,K,ends,absent", [
    (8, 64, 512, 64, False, None), (4, 16, 512, 64, True, None),
    (2, 8, 45, 64, False, "dS"), (2, 8, 33, 64, True, "dy"),
    (2, 4, 70, 16, False, None), (2, 4, 33, 16, True, "dS"),
    (3, 5, 1, 64, False, None), (2, 3, 16, 64, False, None)])
def test_wkv6_grad_kernel_matches_plain(cuda, dtype, B, H, T, K, ends,
                                        absent):
    """The gradient kernel at rwkv6-7b's training shape and a rank's local
    shape, at short and ragged T, with logw at its two ends, dy or dS
    absent: against autograd through ``wkv6_ref``, against its own
    algorithm (``wkv6_bwd_chunk_ref``) and the token-serial oracle
    (``wkv6_bwd_serial_ref``, where T is short), one launch in the
    ``backward`` form, two calls bitwise equal."""
    dt = TORCH_DT[dtype]
    g = torch.Generator(device=cuda).manual_seed(B * T + K)
    args, dy, dS = wkv_grad_case(g, cuda, B, H, T, K, dt, ends)
    dy, dS = (None if absent == n else x for n, x in (("dy", dy), ("dS", dS)))
    before = dict(_cuda.forms["wkv6_bhtk"])
    got = rwkv6.wkv6_bwd_bhtk(*args, dy, dS)
    assert _cuda.forms["wkv6_bhtk"] == dict(before,
                                            backward=before["backward"] + 1)
    again = rwkv6.wkv6_bwd_bhtk(*args, dy, dS)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    xs = [x.detach().requires_grad_() for x in args]
    y, s = rwkv6.wkv6_ref(*xs)
    outs, ups = zip(*[(o, d) for o, d in ((y, dy), (s, dS)) if d is not None])
    want = torch.autograd.grad(outs, xs, ups, allow_unused=True)
    hold_grads(got, [torch.zeros_like(x) if w is None else w
                     for x, w in zip(xs, want)], dtype)
    hold_grads(got, rwkv6.wkv6_bwd_chunk_ref(*args, dy, dS), dtype)
    if T <= 70:
        hold_grads(got, rwkv6.wkv6_bwd_serial_ref(*args, dy, dS), dtype)


@pytest.mark.parametrize("logw", [-20.0, -30.0])
def test_wkv6_grad_kernel_keeps_small_decays(cuda, logw):
    """w = exp(logw) of 2e-9 and 9e-14 on every channel: dlogw, that small
    and real, within 2e-5 of its max of autograd through ``wkv6_ref``, as
    every other gradient."""
    g = torch.Generator(device=cuda).manual_seed(5)
    args, dy, dS = wkv_grad_case(g, cuda, 2, 4, 37, 64, torch.float32,
                                 False)
    args[3].fill_(logw)
    got = rwkv6.wkv6_bwd_bhtk(*args, dy, dS)
    assert float(got[3].abs().max()) > 0
    xs = [x.detach().requires_grad_() for x in args]
    hold_grads(got, torch.autograd.grad(rwkv6.wkv6_ref(*xs), xs, (dy, dS)),
               "float32")


@pytest.mark.parametrize("B,H,T,K", [(2, 2, 40, 64), (8, 64, 100, 64),
                                     (1, 3, 45, 16)])
def test_wkv6_grad_kernel_is_the_same_at_every_row_split(cuda, B, H, T, K):
    """The kernel's grid is set by the shapes alone and no sum runs across
    its blocks but in a fixed order: each (b, h) of a batch taken alone
    (another grid, another du sum) gives bitwise the batch's dr, dk, dv,
    dlogw and ds0, and at B = 1 its du too."""
    g = torch.Generator(device=cuda).manual_seed(T)
    args, dy, dS = wkv_grad_case(g, cuda, B, H, T, K, torch.float32, False)
    whole = rwkv6.wkv6_bwd_bhtk(*args, dy, dS)
    r, k, v, logw, u, s0 = args
    for b in range(B):
        for h in range(H):
            one = rwkv6.wkv6_bwd_bhtk(
                *(x[b:b + 1, h:h + 1].contiguous()
                  for x in (r, k, v, logw)), u[h:h + 1].contiguous(),
                s0[b:b + 1, h:h + 1].contiguous(),
                dy[b:b + 1, h:h + 1].contiguous(),
                dS[b:b + 1, h:h + 1].contiguous())
            for i in (0, 1, 2, 3, 5):
                assert torch.equal(one[i][0, 0], whole[i][b, h]), (b, h, i)
            if B == 1:
                assert torch.equal(one[4][0], whole[4][h])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv6_function_launches_the_gradient_kernel(cuda, dtype):
    """``WKV6`` on the card: one prefill launch forward and one backward
    launch, which autograd's thread counts in the forward's tally, and the
    gradients of autograd through ``wkv6_ref``."""
    from repro_torch.kernels import ops
    dt = TORCH_DT[dtype]
    g = torch.Generator(device=cuda).manual_seed(7)
    args, dy, dS = wkv_grad_case(g, cuda, 2, 8, 77, 64, dt, False)
    xs = [x.detach().requires_grad_() for x in args]
    with ops.tally() as counts:
        outs = rwkv6.wkv6_grad(*xs)
    got = torch.autograd.grad(outs, xs, (dy, dS))
    torch.cuda.synchronize()
    assert counts == {"wkv6_bhtk": 2, ("wkv6_bhtk", "prefill"): 1,
                      ("wkv6_bhtk", "backward"): 1}
    hold_grads(got, torch.autograd.grad(rwkv6.wkv6_ref(*xs), xs, (dy, dS)),
               dtype)


def test_wkv6_grad_kernel_rejects_bad_inputs(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    (r, k, v, logw, u, s0), dy, dS = wkv_grad_case(g, cuda, 1, 2, 5, 16,
                                                   torch.float32, False)
    before = dict(_cuda.forms["wkv6_bhtk"])
    bwd = rwkv6.wkv6_bwd_bhtk
    with pytest.raises(TypeError):                     # bf16 dy, fp32 r
        bwd(r, k, v, logw, u, s0, dy.bfloat16(), dS)
    with pytest.raises(TypeError):                     # bf16 dS
        bwd(r, k, v, logw, u, s0, dy, dS.bfloat16())
    with pytest.raises(ValueError):                    # dy not contiguous
        bwd(r, k, v, logw, u, s0,
            dy.transpose(2, 3).contiguous().transpose(2, 3), dS)
    with pytest.raises(ValueError):                    # s0 not 16-byte
        x = torch.zeros(s0.numel() + 1, device=cuda)[1:].view(s0.shape)
        bwd(r, k, v, logw, u, x, dy, dS)
    with pytest.raises(ValueError):                    # dS of another shape
        bwd(r, k, v, logw, u, s0, dy, dS[:, :1])
    with pytest.raises(ValueError):                    # head dim 24
        x = torch.zeros(1, 2, 5, 24, device=cuda)
        bwd(x, x, x, x, x[0, :, 0], torch.zeros(1, 2, 24, 24, device=cuda),
            None, None)
    assert _cuda.forms["wkv6_bhtk"] == before


RG_STAGE = rglru.STAGE_TOKENS


@pytest.mark.parametrize("B,T,C,form", [
    (8, 2560, 2560, "staged"), (4, 2560, 2560, "staged"),
    (4, 512, 2560, "staged"), (4, 512, 640, "staged"),
    (4, RG_STAGE - 1, 2560, "serial"), (4, RG_STAGE, 2560, "staged"),
    (4, RG_STAGE + 1, 2560, "staged"), (4, 2 * RG_STAGE + 1, 2560, "staged"),
    (1, 2 * RG_STAGE + 1, 1624, "staged"), (4, 100, 2600, "staged"),
    (1, 100, 1624, "staged"), (3, 100, 48, "staged"), (3, 100, 40, "staged"),
    (8, 1, 2560, "serial"), (4, 1, 640, "serial"),
    (1, 32, 8, "staged"), (2, 96, 40, "staged"), (2, 64, 128, "staged"),
    (1, 50, 24, "staged"), (3, 17, 130, "serial"), (3, 64, 130, "serial")])
def test_rglru_matches_plain_and_counts_launches(cuda, B, T, C, form):
    """recurrentgemma-2b's prefill, train, mesh-step and tensor-parallel
    rank shapes and its decode, T around a ring stage (rings of 2 to 4
    stages), short last tiles of the 64 channels (C 2600, 1624,
    48, 40), the reference kernel test's edge shapes and ragged ones, from
    a nonzero h0: h and h_T bitwise ``rglru_ref``'s, one launch in the form
    the shape takes (``staged`` where T >= a stage and C % 4 == 0), and a
    second call the same bits."""
    g = torch.Generator(device=cuda).manual_seed(T)
    a = torch.sigmoid(torch.randn(B, T, C, generator=g, device=cuda))
    b = 0.3 * torch.randn(B, T, C, generator=g, device=cuda)
    h0 = torch.randn(B, C, generator=g, device=cuda)
    before = _cuda.launches["rglru_btc"]
    forms = dict(_cuda.forms["rglru_btc"])
    h, h_T = rglru.rglru_btc(a, b, h0)
    assert _cuda.launches["rglru_btc"] == before + 1
    assert _cuda.forms["rglru_btc"] == dict(forms, **{form: forms[form] + 1})
    h_ref, hT_ref = rglru.rglru_ref(a, b, h0)
    assert _cuda.launches["rglru_btc"] == before + 1
    assert h.dtype == h_T.dtype == torch.float32
    assert torch.equal(h, h_ref) and torch.equal(h_T, hT_ref)
    again = rglru.rglru_btc(a, b, h0)
    assert torch.equal(again[0], h) and torch.equal(again[1], h_T)


def test_rglru_unaligned_view_takes_the_serial_form(cuda):
    """A contiguous view 4 bytes off an aligned base cannot be bulk-copied:
    it takes the serial form, bitwise ``rglru_ref``; 16 bytes off, the
    staged form."""
    g = torch.Generator(device=cuda).manual_seed(5)
    B, T, C = 2, 3 * RG_STAGE, 64
    for off, form in ((1, "serial"), (4, "staged")):
        flat = torch.randn(2 * B * T * C + off, generator=g, device=cuda)
        a = flat[off:off + B * T * C].sigmoid_().view(B, T, C)
        b = flat[off + B * T * C:].view(B, T, C)
        assert (a.data_ptr() % 16 == 0) == (b.data_ptr() % 16 == 0) \
            == (form == "staged")
        assert a.is_contiguous() and b.is_contiguous()
        h0 = torch.randn(B, C, generator=g, device=cuda)
        forms = dict(_cuda.forms["rglru_btc"])
        h, h_T = rglru.rglru_btc(a, b, h0)
        assert _cuda.forms["rglru_btc"] == dict(forms,
                                                **{form: forms[form] + 1})
        want, want_T = rglru.rglru_ref(a, b, h0)
        assert torch.equal(h, want) and torch.equal(h_T, want_T)


def test_rglru_rejects_bad_inputs(cuda):
    a = torch.zeros(2, 5, 16, device=cuda)
    h0 = torch.zeros(2, 16, device=cuda)
    before = _cuda.launches["rglru_btc"]
    with pytest.raises(TypeError):                     # bf16 input
        rglru.rglru_btc(a.bfloat16(), a, h0)
    with pytest.raises(ValueError):                    # h0 of another width
        rglru.rglru_btc(a, a, h0[:, :8])
    with pytest.raises(ValueError):                    # not contiguous
        rglru.rglru_btc(a.transpose(1, 2).contiguous().transpose(1, 2), a,
                        h0)
    assert _cuda.launches["rglru_btc"] == before


def rglru_grad_case(g, device, B, T, C):
    """rglru inputs (a = sigmoid(N(0,1)), h from the kernel's forward) and
    the upstream gh, gT."""
    a = torch.sigmoid(torch.randn(B, T, C, generator=g, device=device))
    b = 0.3 * torch.randn(B, T, C, generator=g, device=device)
    h0 = torch.randn(B, C, generator=g, device=device)
    h, _ = rglru.rglru_btc(a, b, h0)
    return (a, b, h0, h, torch.randn(B, T, C, generator=g, device=device),
            torch.randn(B, C, generator=g, device=device))


@pytest.mark.parametrize("absent", [None, "gh", "gT"])
@pytest.mark.parametrize("B,T,C", [(8, 2560, 2560), (4, 2560, 2560),
                                   (8, 1, 2560), (2, 96, 40), (3, 17, 130),
                                   (1, 300, 24)])
def test_rglru_grad_kernel_matches_plain_bitwise(cuda, B, T, C, absent):
    """The gradient kernel at recurrentgemma-2b's training shapes (8 and 4
    x 2560 x 2560), T = 1, ragged T and C, with gh or gT absent: da, db
    and dh0 bitwise those of ``rglru_bwd_ref`` on the same inputs, one
    launch in ``rglru_btc``'s ``backward`` form."""
    g = torch.Generator(device=cuda).manual_seed(T + C)
    a, _, h0, h, gh, gT = rglru_grad_case(g, cuda, B, T, C)
    gh, gT = (None if absent == n else x for n, x in (("gh", gh), ("gT", gT)))
    before = dict(_cuda.forms["rglru_btc"])
    n = _cuda.launches["rglru_btc"]
    got = rglru.rglru_bwd(a, h, h0, gh, gT)
    assert _cuda.forms["rglru_btc"] == dict(before,
                                            backward=before["backward"] + 1)
    assert _cuda.launches["rglru_btc"] == n + 1
    want = rglru.rglru_bwd_ref(a, h, h0, gh, gT)
    for x, y in zip(got, want):
        assert x.dtype == torch.float32 and torch.equal(x, y)


def test_rglru_function_launches_the_gradient_kernel(cuda):
    """``RGLRU`` on the card: one forward launch (the ``serial`` form, C
    130) and one backward launch (the ``backward`` form), which autograd's
    thread counts in the
    forward's tally; the gradients those of autograd through
    ``rglru_ref``."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=cuda).manual_seed(3)
    a, b, h0, _, gh, gT = rglru_grad_case(g, cuda, 2, 77, 130)
    xs = [x.detach().requires_grad_() for x in (a, b, h0)]
    with ops.tally() as counts:
        outs = rglru.rglru_grad(*xs)
    got = torch.autograd.grad(outs, xs, (gh, gT))
    torch.cuda.synchronize()
    assert counts == {"rglru_btc": 2, ("rglru_btc", "serial"): 1,
                      ("rglru_btc", "backward"): 1}
    want = torch.autograd.grad(rglru.rglru_ref(*xs), xs, (gh, gT))
    for x, y in zip(got, want):
        assert_allclose(x.cpu().numpy(), y.cpu().numpy(), atol=1e-5,
                        rtol=1e-5)


def test_rglru_grad_kernel_rejects_bad_inputs(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    a, _, h0, h, gh, gT = rglru_grad_case(g, cuda, 2, 5, 16)
    before = dict(_cuda.forms["rglru_btc"])
    bwd = rglru.rglru_bwd
    with pytest.raises(TypeError):                     # bf16 gh
        bwd(a, h, h0, gh.bfloat16(), gT)
    with pytest.raises(ValueError):                    # gT of another width
        bwd(a, h, h0, gh, gT[:, :8])
    with pytest.raises(ValueError):                    # gh not contiguous
        bwd(a, h, h0, gh.transpose(1, 2).contiguous().transpose(1, 2), gT)
    with pytest.raises(ValueError):                    # h of another length
        bwd(a, h[:, :4].contiguous(), h0, gh, gT)
    assert _cuda.forms["rglru_btc"] == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_hd256_matches_plain(cuda, dtype):
    """Head dim 256 with MQA (10 heads, 1 KV head): causal with a window
    and without, and the decode form (one query, unmasked, over a ragged
    number of cached keys)."""
    dt = TORCH_DT[dtype]
    g = torch.Generator(device=cuda).manual_seed(1)
    mk = lambda *s: torch.randn(*s, generator=g, device=cuda).to(dt)
    t = 2e-5 if dtype == "float32" else 2e-2
    cases = [((2, 300, 300), dict(window=128)), ((2, 100, 100), {}),
             ((8, 1, 77), dict(causal=False)),
             ((3, 1, 2048), dict(causal=False))]
    before = _cuda.launches["flash_attention_bhsd"]
    for (B, Sq, Sk), kw in cases:
        q, k, v = mk(B, 10, Sq, 256), mk(B, 1, Sk, 256), mk(B, 1, Sk, 256)
        got = fa.flash_attention_bhsd(q, k, v, **kw)
        want = fa.attention_ref(q, k, v, **kw)
        assert_allclose(got.float().cpu().numpy(),
                        want.float().cpu().numpy(), atol=t, rtol=t)
    assert _cuda.launches["flash_attention_bhsd"] == before + len(cases)


def test_engine_on_card_matches_cpu(cuda):
    """The reduced fp32 engine on the card (kernels) and on the CPU (plain
    versions), same weights and noise: the same tokens."""
    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import protein as prot
    cfg = get_reduced("progen-s").replace(compute_dtype="float32")
    rng = np.random.default_rng(0)
    specs = [dict(backbone=rng.normal(size=(rows, 16)), seed=0, length=6,
                  tag=i, noise=rng.gumbel(size=(6, cfg.padded_vocab)))
             for i, rows in enumerate((8, 5, 8))]
    out = {}
    for dev in (cuda, torch.device("cpu")):
        params = prot.init_progen(cfg, seed=1, device=dev)
        eng = prot.PagedDecodeEngine(cfg, slots=2, max_new=6, device=dev)
        out[dev.type] = eng.run(params, 1.0, specs)
    for tag in range(3):
        np.testing.assert_array_equal(out["cuda"][tag][0],
                                      out["cpu"][tag][0])
        assert abs(out["cuda"][tag][1] - out["cpu"][tag][1]) < 1e-3


def test_recurrentgemma_on_card_matches_cpu(cuda):
    """The reduced fp32 recurrentgemma, one model on both devices, a prompt
    of 20 tokens past its window of 16: the same greedy tokens."""
    import copy

    from repro_torch.configs.registry import get_reduced
    from repro_torch.models import lm
    cfg = get_reduced("recurrentgemma-2b").replace(compute_dtype="float32")
    cpu = lm.init_lm(cfg, seed=0, device="cpu")
    card = copy.deepcopy(cpu).to(cuda)
    prompts = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg.vocab_size, size=(3, 20)))
    with torch.inference_mode():
        got = lm.generate(card, {"inputs": prompts.to(cuda)}, cfg, 10)
        want = lm.generate(cpu, {"inputs": prompts}, cfg, 10)
    np.testing.assert_array_equal(got.cpu().numpy(), want.numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 8, 4, 54), (8, 8, 8, 37)])
def test_flash_gradient_on_card_matches_autograd(cuda, dtype, shape):
    """The flash kernel's autograd Function on the card: one forward
    launch of its sequence form and one gradient kernel launch (the
    ``backward`` form), both counted in the forward's tally, and dq/dk/dv
    within the tolerance of autograd through ``attention_ref``, relative
    to each gradient's max."""
    from repro_torch.kernels import ops
    dt = TORCH_DT[dtype]
    B, H, KV, S = shape
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(B, H, S, 32, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(B, KV, S, 32, generator=g, device=cuda).to(dt)
            for _ in range(2))
    do = torch.randn(B, H, S, 32, generator=g, device=cuda).to(dt)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    ops.reset_launches()
    with ops.tally() as counts:
        out = fa.flash_attention_grad(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), do)
    torch.cuda.synchronize()
    form = "seq_f32" if dtype == "float32" else "seq_bf16"
    assert ops.launches["flash_attention_bhsd"] == 2
    want_forms = dict(decode=0, seq_f32=0, seq_bf16=0, backward=1)
    want_forms[form] = 1
    assert ops.forms["flash_attention_bhsd"] == want_forms
    assert counts == {"flash_attention_bhsd": 2,
                      ("flash_attention_bhsd", form): 1,
                      ("flash_attention_bhsd", "backward"): 1}
    want = torch.autograd.grad(fa.attention_ref(q, k, v), (q, k, v), do)
    t = 2e-5 if dtype == "float32" else 2e-2
    for a, b in zip(got, want):
        assert a.dtype == dt
        err = float((a.float() - b.float()).abs().max())
        assert err <= t * float(b.float().abs().max())


# (B, H, KV, Sq, Sk, hd, q_offset, kwargs): head dims 16-256, groups of 1,
# 3, 5 and 10, causal and not, windows, ragged seq_k, context-parallel
# chunks, rows with no live key, recurrentgemma-2b's hd 256 and window 2048
FLASH_GRAD_CASES = [
    (2, 2, 2, 40, 40, 16, 0, dict(causal=True)),
    (1, 6, 2, 37, 37, 32, 0, dict(causal=True, seq_k=30)),
    (1, 5, 1, 33, 45, 64, 0, dict(causal=False)),
    (1, 10, 1, 96, 96, 256, 0, dict(causal=True, window=40)),
    (1, 10, 1, 32, 128, 256, 96, dict(causal=True, window=48)),
    (2, 6, 2, 16, 64, 32, 16, dict(causal=True)),
    (1, 4, 4, 24, 40, 16, 0, dict(causal=False, window=6)),
    (1, 3, 1, 16, 24, 16, 20, dict(causal=False, window=6, seq_k=20)),
    (2, 10, 2, 20, 50, 64, 0, dict(causal=False, seq_k=41)),
    (1, 1, 1, 70, 70, 256, 0, dict(causal=True)),
    (2, 8, 2, 100, 100, 128, 0, dict(causal=True)),
    (4, 15, 5, 128, 512, 64, 384, dict(causal=True)),
]


def flash_grad_case(cuda, dt, seed, B, H, KV, Sq, Sk, hd, off, kw):
    """q, k, v, the forward kernel's o and lse and an upstream g on the
    card."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(B, H, Sq, hd, generator=g, device=cuda).to(dt)
             for _ in range(2))
    k, v = (torch.randn(B, KV, Sk, hd, generator=g, device=cuda).to(dt)
            for _ in range(2))
    o, lse = fa.flash_attention_bhsd(q, k, v, q_offset=off, return_lse=True,
                                     **kw)
    return q, k, v, o, lse, do


def hold_flash_grads(got, want, dtype):
    t = 2e-5 if dtype == "float32" else 2e-2
    for name, a, b in zip("qkv", got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        err = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max()) or 1.0
        assert err <= t * scale, f"d{name}: {err / scale:.3e} of its max"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", range(len(FLASH_GRAD_CASES)))
def test_flash_grad_kernel_matches_tiled_ref_and_autograd(cuda, dtype,
                                                          case):
    """The gradient kernel against its own tiles, order and roundings
    (``attention_bwd_tiled_ref`` on the same card tensors and the forward
    kernel's lse) and against autograd through ``attention_ref``, each
    gradient relative to its max; one launch in the ``backward`` form, two
    calls bitwise equal."""
    dt = TORCH_DT[dtype]
    B, H, KV, Sq, Sk, hd, off, kw = FLASH_GRAD_CASES[case]
    q, k, v, o, lse, do = flash_grad_case(cuda, dt, case, B, H, KV, Sq, Sk,
                                          hd, off, kw)
    before = dict(_cuda.forms["flash_attention_bhsd"])
    got = fa.flash_attention_bwd_bhsd(q, k, v, o, do, lse=lse, q_offset=off,
                                      **kw)
    assert _cuda.forms["flash_attention_bhsd"] == dict(
        before, backward=before["backward"] + 1)
    again = fa.flash_attention_bwd_bhsd(q, k, v, o, do, lse=lse,
                                        q_offset=off, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    hold_flash_grads(got, fa.attention_bwd_tiled_ref(
        q, k, v, o, do, lse, q_offset=off, **kw), dtype)
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    hold_flash_grads(got, torch.autograd.grad(
        fa.attention_ref(*xs, q_offset=off, **kw), xs, do), dtype)
    if kw.get("seq_k") is not None:
        n = kw["seq_k"]
        assert all(bool((d[:, :, n:] == 0).all()) for d in got[1:])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [9, 10, 11])
def test_flash_grad_kernel_cuts_its_walks_as_the_tiled_ref(cuda, dtype,
                                                          case):
    """The gradient kernel takes its walks' cuts as it is given them: at
    long causal walks, each walk whole, as ``bwd_segments`` cuts them (both
    walks here), and with the dq walks whole (``fill`` 0), each within the
    tolerance of the tiled ref and of autograd."""
    dt = TORCH_DT[dtype]
    B, H, KV, Sq, Sk, hd, off, kw = FLASH_GRAD_CASES[case]
    q, k, v, o, lse, do = flash_grad_case(cuda, dt, case, B, H, KV, Sq, Sk,
                                          hd, off, kw)
    geo = (B, KV, Sq, Sk, Sk, kw["causal"], kw.get("window", 0), off,
           H // KV, fa.bwd_step(hd, dt))
    want = fa.attention_bwd_tiled_ref(q, k, v, o, do, lse, q_offset=off,
                                      **kw)
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    auto = torch.autograd.grad(fa.attention_ref(*xs, q_offset=off, **kw),
                               xs, do)
    cuts = {(fa.BWD_WHOLE, 1, fa.BWD_WHOLE, 1), fa.bwd_segments(*geo),
            fa.bwd_segments(*geo, fill=0)}
    assert len(cuts) == 3
    for cut in cuts:
        got = fa._launch_bwd(q, k, v, o, do, lse, kw["causal"],
                             kw.get("window", 0), None, off, segments=cut)
        hold_flash_grads(got, want, dtype)
        hold_flash_grads(got, auto, dtype)


@pytest.mark.parametrize("B,Sq,Sk,off", [(2, 640, 640, 0),
                                         (4, 128, 512, 384)])
def test_flash_grad_kernel_at_recurrentgemmas_attention(cuda, B, Sq, Sk,
                                                        off):
    """fp32, hd 256, 10 query heads over one KV head, window 2048 (a
    sequence of 640, and phase 12's context-parallel chunk of 128 queries
    at 384 over 512 keys): against autograd through ``attention_ref``,
    two calls bitwise equal."""
    q, k, v, o, lse, do = flash_grad_case(cuda, torch.float32, Sq, B, 10, 1,
                                          Sq, Sk, 256, off,
                                          dict(causal=True, window=2048))
    kw = dict(causal=True, window=2048, q_offset=off)
    got = fa.flash_attention_bwd_bhsd(q, k, v, o, do, lse=lse, **kw)
    again = fa.flash_attention_bwd_bhsd(q, k, v, o, do, lse=lse, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    xs = [x.detach().requires_grad_() for x in (q, k, v)]
    hold_flash_grads(got, torch.autograd.grad(
        fa.attention_ref(*xs, **kw), xs, do), "float32")


def test_flash_grad_kernel_rejects_bad_inputs(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, o, lse, do = flash_grad_case(cuda, torch.float32, 0, 1, 4, 2, 8,
                                          8, 32, 0, {})
    before = dict(_cuda.forms["flash_attention_bhsd"])

    def bwd(*xs, lse=lse):
        return fa.flash_attention_bwd_bhsd(*xs, lse=lse)
    with pytest.raises(ValueError):                    # no lse on the card
        fa.flash_attention_bwd_bhsd(q, k, v, o, do)
    with pytest.raises(TypeError):                     # bf16 K/V, fp32 q
        bwd(q, k.bfloat16(), v.bfloat16(), o, do)
    with pytest.raises(TypeError):                     # bf16 upstream
        bwd(q, k, v, o, do.bfloat16())
    with pytest.raises(TypeError):                     # lse not fp32
        bwd(q, k, v, o, do, lse=lse.bfloat16())
    with pytest.raises(ValueError):                    # lse of another shape
        bwd(q, k, v, o, do, lse=lse[:, :1].contiguous())
    with pytest.raises(ValueError):                    # g not contiguous
        bwd(q, k, v, o, do.transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError):                    # o of another shape
        bwd(q, k, v, o[:, :1], do)
    with pytest.raises(ValueError):                    # q not 16-byte
        x = torch.zeros(q.numel() + 1, device=cuda)[1:].view(q.shape)
        bwd(x, k, v, o, do)
    with pytest.raises(ValueError):                    # head dim 24
        x = torch.randn(1, 4, 8, 24, generator=g, device=cuda)
        bwd(x, x[:, :2], x[:, :2], x, x)
    assert _cuda.forms["flash_attention_bhsd"] == before


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,Sq,Sk,hd,off,kw", [
    (2, 8, 4, 54, 54, 32, 0, dict(causal=True)),
    (1, 10, 1, 96, 96, 256, 0, dict(causal=True, window=40)),
    (4, 15, 5, 128, 512, 64, 384, dict(causal=True)),
    (1, 3, 1, 16, 24, 16, 20, dict(causal=False, window=6, seq_k=20)),
    (2, 6, 2, 37, 45, 128, 0, dict(causal=False, seq_q=30)),
    (3, 4, 2, 1, 40, 64, 0, dict(causal=False)),
])
def test_flash_forward_writes_lse(cuda, dtype, B, H, KV, Sq, Sk, hd, off,
                                  kw):
    """Both sequence kernels, asked for lse, write each row's log-sum-exp
    of its live scores (``attention_lse``; rows past ``seq_q`` against
    ``attention_ref``'s, NEG_INF + log(1e-20) where no key is live) and an
    output bitwise the one they give unasked; one query asked for lse runs
    the sequence form (its o against the plain version)."""
    dt = TORCH_DT[dtype]
    g = torch.Generator(device=cuda).manual_seed(Sq + hd)
    q = torch.randn(B, H, Sq, hd, generator=g, device=cuda).to(dt)
    k, v = (torch.randn(B, KV, Sk, hd, generator=g, device=cuda).to(dt)
            for _ in range(2))
    kw = dict(kw, q_offset=off)
    form = "seq_f32" if dtype == "float32" else "seq_bf16"
    before = dict(_cuda.forms["flash_attention_bhsd"])
    o, lse = fa.flash_attention_bhsd(q, k, v, return_lse=True, **kw)
    assert _cuda.forms["flash_attention_bhsd"] == dict(
        before, **{form: before[form] + 1})
    assert lse.shape == (B, H, Sq) and lse.dtype == torch.float32
    if kw.get("seq_q") is None:
        want = fa.attention_lse(q, k, **{n: x for n, x in kw.items()
                                         if n != "seq_q"})
    else:
        _, want = fa.attention_ref(q, k, v, return_lse=True, **kw)
    assert_allclose(lse.cpu().numpy(), want.cpu().numpy(), atol=1e-5,
                    rtol=1e-5)
    if Sq > 1:
        assert torch.equal(o, fa.flash_attention_bhsd(q, k, v, **kw))
    t = 2e-5 if dtype == "float32" else 2e-2
    assert_allclose(o.float().cpu().numpy(),
                    fa.attention_ref(q, k, v, **kw).float().cpu().numpy(),
                    atol=t, rtol=t)


def test_finetune_on_card_matches_cpu(cuda):
    """A reduced fp32 finetune of 5 steps on the card (the flash kernel's
    fp32 form, one launch a layer a step) and on the CPU from the same
    weights and batch: losses within 1e-5 relative, weights within 1e-4
    (tests/test_torch_evolution.py's tolerances)."""
    import copy

    from repro_torch.configs.registry import get_reduced
    from repro_torch.core.payload import FinetunePayload, ProteinPayload
    from repro_torch.kernels import ops
    from repro_torch.models import protein as prot
    from repro_torch.runtime.allocator import SubMesh
    gcfg = get_reduced("progen-s").replace(compute_dtype="float32")
    fcfg = get_reduced("foldscore-s").replace(compute_dtype="float32")
    weights = prot.init_progen(gcfg, 0, device="cpu")
    rng = np.random.default_rng(8)
    batch = {"backbones": rng.normal(size=(4, 8, 16)).astype(np.float32),
             "sequences": rng.integers(1, 21, size=(4, 12)).astype(np.int32),
             "weights": np.linspace(1.0, 0.2, 4).astype(np.float32)}
    out = []
    for dev in (cuda, torch.device("cpu")):
        pp = ProteinPayload(gen_cfg=gcfg, fold_cfg=fcfg, device=dev,
                            progen=copy.deepcopy(weights))
        ops.reset_launches()
        res = FinetunePayload(pp, lr=1e-3, steps=5).finetune(
            SubMesh((pp.device,)), dict(batch))
        if dev.type == "cuda":
            torch.cuda.synchronize()
            assert ops.forms["flash_attention_bhsd"]["seq_f32"] == \
                gcfg.n_layers * 5
        out.append((res, pp.gen_params))
    (gres, gp), (cres, cp) = out
    for k in ("loss_first", "loss_last", "mean_ll_first", "mean_ll_last"):
        assert abs(gres[k] - cres[k]) <= 1e-5 * abs(cres[k]), k
    for a, b in zip(gp.parameters(), cp.parameters()):
        assert_allclose(a.cpu().numpy(), b.numpy(), atol=1e-4)
