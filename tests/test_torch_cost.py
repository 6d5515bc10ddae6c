"""The port's cost accounting (``repro_torch.distributed.cost``, the
counterpart of ``repro.distributed.hlo_cost``), its roofline
(``distributed.roofline``) and dry run (``launch/dryrun.py``), on the CPU.

The reference's four ``hlo_cost`` tests (``tests/test_sharding_and_cost.py``)
mirrored on the counter; each kernel's formula the same on ``meta`` as on
the plain CPU path and held to its plain version's work; the counter's
FLOPs outside the attention and mixer tags within 2% of the reference's
``hlo_cost.analyze`` on the same reduced forwards (llama3-8b, rwkv6-7b,
qwen3-moe-30b-a3b); ``model_flops`` against the reference's parameter
counts; one dry-run cell on a fake group of 4 ranks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.configs.registry import get_reduced as ref_get_reduced  # noqa: E402
from repro.distributed.hlo_analysis import Roofline as RefRoofline  # noqa: E402
from repro.distributed.hlo_cost import analyze as hlo_analyze  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import (SHAPES, SHAPES_BY_NAME,  # noqa: E402
                                 ShapeConfig)
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          get_reduced)
from repro_torch.distributed import cost, roofline  # noqa: E402
from repro_torch.distributed.sharding import gather  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rglru, rwkv6  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import lm  # noqa: E402

TAGS = "flashattn|sdpattn|wkvscan|rgscan|moeffn"


# ---------------------------------------------------------------------------
# the reference's hlo_cost tests, mirrored
# ---------------------------------------------------------------------------

def test_loop_trip_count_multiplication():
    def f(x):
        for _ in range(9):
            x = torch.tanh(x @ x)
        return x

    c = cost.analyze(f, torch.randn(32, 32))
    expect = 9 * (2 * 32 ** 3)
    assert abs(c.flops - expect) / expect < 0.05


def test_looped_equals_unrolled():
    def fs(x):
        for _ in range(5):
            x = torch.tanh(x @ x)
        return x

    def fu(x):
        x = torch.tanh(x @ x)
        x = torch.tanh(x @ x)
        x = torch.tanh(x @ x)
        x = torch.tanh(x @ x)
        return torch.tanh(x @ x)

    x = torch.randn(48, 48)
    cs, cu = cost.analyze(fs, x), cost.analyze(fu, x)
    assert abs(cs.flops - cu.flops) / cu.flops < 0.02
    assert cs.bytes == cu.bytes


@pytest.fixture
def group():
    """A process group torn down after the test: ``group(n)`` joins a fake
    one of n ranks (collectives accepted, nothing sent), ``group(1)`` a
    one-rank gloo one."""
    def join(n):
        if n == 1:
            dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            from torch.testing._internal.distributed.fake_pg import FakeStore
            dist.init_process_group("fake", store=FakeStore(), rank=0,
                                    world_size=n)
        from torch.distributed.device_mesh import init_device_mesh
        return init_device_mesh("cpu", (n, 1), mesh_dim_names=("data",
                                                               "model"))
    try:
        yield join
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.mark.parametrize("ranks", [1, 4])
def test_collective_bytes_detected(ranks, group):
    """A weight sharded over the ranks, gathered at use: one rank counts no
    collective bytes; four count the all-gather's result bytes, and its
    gradient's reduce-scatter (plus an all-reduce along ``model``)."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    mesh = group(ranks)
    w = torch.nn.Parameter(distribute_tensor(
        torch.randn(64, 64), mesh, [Shard(0), Replicate()],
        src_data_rank=None))
    x = torch.randn(64, 64)

    def step():
        (x @ gather(w, torch.float32)).sum().backward()
    c = cost.analyze(step)
    assert c.flops >= 2 * 64 ** 3
    if ranks == 1:
        assert c.coll_total == 0
    else:
        assert c.coll["all-gather"] == 64 * 64 * 4
        assert c.coll["reduce-scatter"] == 64 * 64 * 4 / ranks


def test_tagged_attribution():
    def f(x):
        with cost.tag("hotspot"):
            y = torch.tanh(x @ x)
        return y + 1

    total, tagged = cost.analyze(f, torch.randn(64, 64), tag="hotspot")
    assert tagged.flops >= 2 * 64 ** 3
    assert tagged.flops < total.flops


# ---------------------------------------------------------------------------
# the kernels' formulas
# ---------------------------------------------------------------------------

def _same_on_meta(fn, args, kwargs, want):
    """The kernel's count on the CPU inputs and on their meta twins, both
    equal to ``want`` = (flops, bytes); the meta outputs shaped like the
    CPU ones."""
    meta = [a.to("meta") if isinstance(a, torch.Tensor) else a for a in args]
    with cost.counting() as c_cpu:
        out_cpu = fn(*args, **kwargs)
    with cost.counting() as c_meta:
        out_meta = fn(*meta, **kwargs)
    for a, b in zip(jax.tree.leaves(out_cpu), jax.tree.leaves(out_meta)):
        assert b.is_meta and a.shape == b.shape and a.dtype == b.dtype
    assert (c_cpu.total.flops, c_cpu.total.bytes) == want
    assert (c_meta.total.flops, c_meta.total.bytes) == want


FLASH = [  # (B, H, KV, Sq, Sk, hd), kwargs
    ((2, 4, 2, 17, 17, 16), dict(causal=True)),
    ((2, 4, 4, 17, 17, 16), dict(causal=True, window=5)),
    ((1, 4, 1, 9, 23, 32), dict(causal=False)),
    ((3, 8, 2, 1, 40, 16), dict(causal=False, seq_k=29)),
]


@pytest.mark.parametrize("case", range(len(FLASH)))
def test_flash_formula(case):
    (B, H, KV, Sq, Sk, hd), kw = FLASH[case]
    g = torch.Generator().manual_seed(case)
    q = torch.randn(B, H, Sq, hd, generator=g)
    k, v = (torch.randn(B, KV, Sk, hd, generator=g) for _ in range(2))
    n = kw.get("seq_k") or Sk
    flops, nbytes = cost.flash_work(B, H, KV, Sq, n, hd, 4, 4,
                                    kw.get("causal"), kw.get("window", 0))
    # the plain version's live (q, k) pairs are the formula's
    _, mask = fa._scores(q, k, kw.get("causal"), kw.get("window", 0), 0.0,
                         None, kw.get("seq_k"))
    assert flops == 4 * hd * B * H * int(mask.sum())
    assert nbytes == (2 * q.numel() + 2 * B * KV * n * hd) * 4
    _same_on_meta(fa.flash_attention_bhsd, (q, k, v), kw,
                  (float(flops), float(nbytes)))
    assert cost.live_pairs(Sq, n, kw.get("causal"), kw.get("window", 0)) \
        == int(mask.sum())


@pytest.mark.parametrize("case", range(len(FLASH)))
def test_flash_bwd_formula(case):
    """The gradient's bound: 10·hd a live pair (the forward's 4·hd, 2.5
    times), q, o and do read and dq written, K and V read and dK and dV
    written over the live keys."""
    (B, H, KV, Sq, Sk, hd), kw = FLASH[case]
    n = kw.get("seq_k") or Sk
    args = (B, H, KV, Sq, n, hd, 2, 2, kw.get("causal"), kw.get("window", 0))
    flops, nbytes = cost.flash_bwd_work(*args)
    assert 4 * flops == 10 * cost.flash_work(*args)[0]
    keys = cost.live_keys(Sq, n, kw.get("causal"), kw.get("window", 0))
    assert nbytes == (4 * B * H * Sq * hd + 4 * B * KV * keys * hd) * 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv6_formula(dtype):
    B, H, T, K = 2, 3, 37, 16
    g = torch.Generator().manual_seed(1)
    r, k, v = (0.5 * torch.randn(B, H, T, K, generator=g)).to(dtype), \
        (0.5 * torch.randn(B, H, T, K, generator=g)).to(dtype), \
        (0.5 * torch.randn(B, H, T, K, generator=g)).to(dtype)
    logw = -torch.exp(torch.randn(B, H, T, K, generator=g))
    u, s0 = torch.randn(H, K, generator=g), torch.randn(B, H, K, K,
                                                         generator=g)
    flops, nbytes = cost.wkv6_work(B, H, T, K, r.element_size())
    # a multiply-add for y and one for S a state element a token
    assert flops == 2 * 2 * B * H * T * K * K
    assert nbytes == (4 * r.numel() * r.element_size() + 4 * logw.numel()
                      + 4 * u.numel() + 2 * 4 * s0.numel())
    _same_on_meta(rwkv6.wkv6_bhtk, (r, k, v, logw, u, s0), {},
                  (float(flops), float(nbytes)))


def test_rglru_formula():
    B, T, C = 3, 29, 24
    g = torch.Generator().manual_seed(2)
    a = torch.sigmoid(torch.randn(B, T, C, generator=g))
    b, h0 = torch.randn(B, T, C, generator=g), torch.randn(B, C, generator=g)
    flops, nbytes = cost.rglru_work(B, T, C)
    _same_on_meta(rglru.rglru_btc, (a, b, h0), {},
                  (float(flops), float(nbytes)))
    # the plain version's own ops: a multiply and an add an element a token
    with cost.counting() as c:
        rglru.rglru_ref(a, b, h0)
    assert c.total.flops == flops


def test_paged_formula():
    B, KV, G, hd, page, maxp = 3, 2, 2, 16, 4, 5
    g = torch.Generator().manual_seed(3)
    q = torch.randn(B, KV, G, hd, generator=g)
    kp, vp = (torch.randn(B * maxp + 1, KV, page, hd, generator=g)
              for _ in range(2))
    bt = torch.arange(B * maxp, dtype=torch.int32).reshape(B, maxp)
    lengths = torch.tensor([0, 7, 20], dtype=torch.int32)
    flops, nbytes = cost.paged_work(B, KV, G, hd, 27, maxp, 4)
    assert flops == 4 * hd * G * KV * int(lengths.sum())
    with cost.counting() as c:
        pa.paged_decode_bkgh(q, kp, vp, bt, lengths, page_size=page)
    assert (c.total.flops, c.total.bytes) == (flops, nbytes)
    # on meta the lengths are unknown: every slot of the block tables
    with cost.counting() as c:
        out = pa.paged_decode_bkgh(*(t.to("meta") for t in (
            q, kp, vp, bt, lengths)), page_size=page)
    assert out.is_meta and out.shape == q.shape
    assert c.total.flops == 4 * hd * G * KV * B * maxp * page


# ---------------------------------------------------------------------------
# whole forwards against the reference's HLO count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama3-8b", "rwkv6-7b",
                                  "qwen3-moe-30b-a3b"])
def test_untagged_flops_match_reference(arch):
    """The FLOPs outside attention and the mixers: what the two packages
    compute alike (projections, MLPs, norms, the LM head)."""
    ref_cfg, cfg = ref_get_reduced(arch), get_reduced(arch)
    params = ref_lm.init_lm(jax.random.PRNGKey(0), ref_cfg)
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    txt = jax.jit(lambda p, t: ref_lm.lm_logits(p, {"inputs": t}, ref_cfg)
                  ).lower(params, toks).compile().as_text()
    ref_total, ref_tagged = hlo_analyze(txt, tag_re=TAGS)
    module = bridge.lm_from_ref(jax.tree.map(np.asarray, params), cfg)
    with torch.no_grad():
        total, tagged = cost.analyze(lm.lm_logits, module,
                                     {"inputs": torch.from_numpy(toks)}, cfg,
                                     tag=TAGS)
    want = ref_total.flops - ref_tagged.flops
    got = total.flops - tagged.flops
    assert abs(got - want) / want < 0.02, (got, want)
    assert tagged.flops > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_match_reference_counts(arch):
    ref = ref_get_config(arch)
    cfg = get_config(arch)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    assert cost.model_flops(cfg, "train", 4096) == \
        6 * ref.active_param_count() * 4096
    assert cost.model_flops(cfg, "decode", 128) == \
        2 * ref.active_param_count() * 128


def test_roofline_terms():
    """The reference's properties on the card's rates."""
    kw = dict(flops_per_device=2e15, hbm_bytes_per_device=4e12,
              collective_bytes_per_device=9e10, chips=256,
              model_flops=3e17)
    r, ref = roofline.Roofline(**kw), RefRoofline(**kw)
    assert r.t_compute == 2e15 / 989e12 and r.t_memory == 4e12 / 3.35e12
    assert r.t_collective == 9e10 / 450e9
    assert r.bottleneck == "compute"
    assert r.model_flops_ratio == ref.model_flops_ratio
    assert r.to_dict().keys() == ref.to_dict().keys()
    assert r.roofline_fraction == pytest.approx(
        (3e17 / 256 / 989e12) / r.t_bound)
    assert r.mfu(4.0) == pytest.approx(3e17 / 256 / (4.0 * 989e12))


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------

REF_KEYS = {"arch", "shape", "mesh", "applicable", "skip_reason", "params",
            "active_params", "chips", "roofline", "attn_tagged",
            "mixer_tagged", "memory_analysis"}


@pytest.mark.parametrize("arch,kind", [("rwkv6-7b", "train"),
                                       ("llama3-8b", "decode")])
def test_dryrun_cell_on_a_fake_group(arch, kind):
    """A reduced cell on a fake (2, 2) group of 4 ranks: the reference's
    record keys, FLOPs in both tags' reach, the model FLOPs of its
    tokens, no process group left behind."""
    sc = ShapeConfig(f"{kind}_small", kind, 32, 8)
    rec = dryrun.run_cell(arch, sc, (2, 2), reduced=True)
    assert not dist.is_initialized()
    assert REF_KEYS <= rec.keys() and rec["applicable"]
    assert rec["chips"] == 4
    r = rec["roofline"]
    assert r["flops_per_device"] > 0 and r["hbm_bytes_per_device"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    tokens = 8 * 32 if kind == "train" else 8
    assert r["model_flops"] == cost.model_flops(get_reduced(arch), kind,
                                                tokens)
    assert rec["attn_tagged"]["flops"] > 0 or arch == "rwkv6-7b"
    if arch == "rwkv6-7b":
        assert rec["mixer_tagged"]["flops"] > 0
    assert rec["memory_analysis"]["argument_size_bytes"] > \
        rec["memory_analysis"]["parameter_bytes"] > 0
    assert rec["memory_analysis"]["temp_size_bytes"] is None
    assert dryrun.roofline_line(rec).startswith(f"{arch} {sc.name} (2, 2): "
                                                f"chips=4")


def test_dryrun_skips_long_context_for_full_attention():
    long = next(s for s in SHAPES if s.name == "long_500k")
    rec = dryrun.run_cell("llama3-8b", long, "single")
    assert rec["applicable"] is False and "long_500k" in rec["skip_reason"]
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# tensor parallelism over ``model``: a (1, 4) cell on a fake group
# ---------------------------------------------------------------------------

TP_CELL = ShapeConfig("train_small", "train", 32, 8)


class Dots(torch.utils._python_dispatch.TorchDispatchMode):
    """The counter's FLOPs of the matrix products alone."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.overloadpacket.__name__ in cost._DOTS:
            self.flops += cost.op_cost(func, args, kwargs, out).flops
        return out


def tp_all_reduce_bytes(cfg, B, S, n_metrics=5):
    """The all-reduce bytes of one reduced llama3-8b train step on a (1, 4)
    mesh, reckoned from the shapes: an activation (B, S, d) in the compute
    dtype for the vocab-parallel lookup, two a layer's attention and two
    its MLP (the row-parallel output forward, the column-parallel input's
    gradient backward) and one for the head's input gradient; three fp32
    (B, S) for the CE (max, sum of exponentials, gold logit); the
    replicated K/V projections' gradients (KV 2 does not divide 4, each
    rank reads its heads' share) in the compute dtype; the train step's
    fp32 global norm and its metrics."""
    act = B * S * cfg.d_model * 2
    kv = 2 * cfg.d_model * cfg.n_kv_heads * cfg.head_dim * 2
    return (act * (2 + 4 * cfg.n_layers) + 3 * B * S * 4
            + cfg.n_layers * kv + 4 + 4 * n_metrics)


def test_tp_cell_all_reduce_bytes():
    """The (1, 4) cell's collectives are all-reduces only (the data axis
    has one rank: no gather moves a byte), as many bytes as reckoned; its
    attention FLOPs a quarter of the (1, 1) cell's (1 of 4 heads a rank)."""
    cfg = get_reduced("llama3-8b")
    assert cfg.compute_dtype == "bfloat16" and cfg.n_kv_heads % 4
    one = dryrun.run_cell("llama3-8b", TP_CELL, (1, 1), reduced=True)
    four = dryrun.run_cell("llama3-8b", TP_CELL, (1, 4), reduced=True)
    assert not dist.is_initialized()
    assert one["roofline"]["collectives"] == {}
    assert four["roofline"]["collectives"] == {
        "all-reduce": tp_all_reduce_bytes(cfg, TP_CELL.global_batch,
                                          TP_CELL.seq_len)}
    assert four["roofline"]["flops_per_device"] < \
        one["roofline"]["flops_per_device"] / 3
    flash = [cost.flash_work(TP_CELL.global_batch, h, kv, TP_CELL.seq_len,
                             TP_CELL.seq_len, cfg.head_dim, 2, 2)[0]
             for h, kv in ((cfg.n_heads, cfg.n_kv_heads), (1, 1))]
    assert flash[0] == 4 * flash[1]


@pytest.mark.parametrize("part", ["mlp", "head", "q-and-o"])
def test_tp_split_products_are_a_quarter(part):
    """Per-rank FLOPs of the products the rules split (the MLP, the vocab
    head, attention's q and o projections: the matrix products the
    counter sees, forward and backward) on a fake (1, 4) group: exactly a
    quarter of the (1, 1) count."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.distributed import sharding
    from repro_torch.models import attention
    from repro_torch.models.common import logits_fwd, trainable
    from repro_torch.models.mlp import mlp_fwd
    cfg = get_reduced("llama3-8b")
    B, S = 8, 32

    def count(n):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
        try:
            mesh = init_device_mesh("cpu", (1, n),
                                    mesh_dim_names=("data", "model"))
            with torch.device("meta"):
                params = trainable(lm.LM(cfg))
            sharding.shard_module(params, mesh, cfg)
            x = torch.empty(B, S, cfg.d_model, device="meta",
                            dtype=torch.bfloat16, requires_grad=True)
            layer = params.layers[0]
            with sharding.activation_sharding(mesh, cfg, "train"), \
                    Dots() as c:
                if part == "mlp":
                    y = mlp_fwd(layer.mlp, x, cfg)
                elif part == "head":
                    y = logits_fwd(params, x, cfg)
                else:
                    q = attention._q(layer.attn, x, cfg)
                    y = attention._proj_out(layer.attn, q, cfg)
                y.sum().backward()
            return c.flops
        finally:
            dist.destroy_process_group()
    one, four = count(1), count(4)
    assert one > 0 and four * 4 == one


# ---------------------------------------------------------------------------
# sequence and context parallelism: train_4k cells at full width, 2 layers,
# on the single-pod fake group
# ---------------------------------------------------------------------------

TWO_LAYERS = {"n_layers": 2, "segments": ((("attn",), 2),)}
SP_S, SP_M = 4096, 16


def seen_cell(arch, rank=None, bwd=None):
    """``dryrun.run_cell`` of ``arch``'s train_4k cell cut to 2 layers, at
    ``rank``, with each flash call's (Sq, q_offset) and each layer's
    residual shape, recorded by pass-throughs in the functions' places;
    each gradient call's (Sq, q_offset) too, in the list ``bwd``."""
    from repro_torch.models import blocks
    calls, shapes = [], []
    inner_fa, inner_layer = fa.flash_attention_bhsd, blocks.layer_fwd
    inner_bwd = fa.flash_attention_bwd_bhsd

    def flash(q, k, v, **kw):
        calls.append((q.shape[2], kw.get("q_offset", 0)))
        return inner_fa(q, k, v, **kw)

    def flash_bwd(q, *a, **kw):
        if bwd is not None:
            bwd.append((q.shape[2], kw.get("q_offset", 0)))
        return inner_bwd(q, *a, **kw)

    def layer(kind, p, x, ctx, cfg):
        shapes.append(tuple(x.shape))
        return inner_layer(kind, p, x, ctx, cfg)
    fa.flash_attention_bhsd, blocks.layer_fwd = flash, layer
    fa.flash_attention_bwd_bhsd = flash_bwd
    try:
        rec = dryrun.run_cell(arch, "train_4k", "single", TWO_LAYERS,
                              rank=rank)
    finally:
        fa.flash_attention_bhsd, blocks.layer_fwd = inner_fa, inner_layer
        fa.flash_attention_bwd_bhsd = inner_bwd
    return rec, calls, shapes


def test_cp_cell_counts_flash_at_each_ranks_chunk():
    """smollm-360m ``train_4k`` (15 heads on 16 ranks: SP and CP): every
    flash call and every gradient call takes the rank's 4096 / 16 queries
    at its offset, the residual is the rank's (rows, 256, 960) chunk in
    every layer, and the last rank's flash FLOPs exceed rank 0's by the
    live pairs its chunk adds, in the forward's formula and the gradient's
    (the default rank is that last one); the collectives are the
    all-reduces the layers issue, nothing else."""
    cfg = get_config("smollm-360m")
    rows = SHAPES_BY_NAME["train_4k"].global_batch // SP_M
    n = SP_S // SP_M
    recs = {}
    for rank in (0, SP_M - 1):
        bwd = []
        rec, calls, shapes = seen_cell("smollm-360m", rank, bwd)
        assert rec["rank"] == rank
        assert calls and set(calls) == {(n, rank * n)}, set(calls)
        assert bwd and set(bwd) == {(n, rank * n)}, set(bwd)
        assert set(shapes) == {(rows, n, cfg.d_model)}
        assert set(rec["roofline"]["collectives"]) == {"all-reduce"}
        recs[rank] = rec, len(calls), len(bwd)
    assert seen_cell("smollm-360m")[0]["rank"] == SP_M - 1
    (first, n_calls, n_bwd), (last, _, _) = recs[0], recs[SP_M - 1]
    args = (rows, cfg.n_heads, cfg.n_kv_heads, n, SP_S, cfg.head_dim, 2, 2,
            True, 0)
    work = [cost.flash_work(*args, off)[0] for off in (0, (SP_M - 1) * n)]
    grad = [cost.flash_bwd_work(*args, off)[0]
            for off in (0, (SP_M - 1) * n)]
    assert last["attn_tagged"]["flops"] - first["attn_tagged"]["flops"] \
        == n_calls * (work[1] - work[0]) + n_bwd * (grad[1] - grad[0])


def test_sp_cell_norms_run_on_the_ranks_positions():
    """llama3-8b ``train_4k`` (32 heads divide 16: SP, no CP): the layers
    take the rank's (rows, 4096 / 16, 4096) chunk, so its norms and
    residual adds count S / 16 positions; flash takes the whole sequence
    on the rank's 2 heads; the layers' collectives are all-reduces, beside
    the FSDP storage's all-gathers of the weights over ``data`` and
    reduce-scatters of their gradients (DTensor's)."""
    cfg = get_config("llama3-8b")
    assert cfg.fsdp
    rows = SHAPES_BY_NAME["train_4k"].global_batch // SP_M
    rec, calls, shapes = seen_cell("llama3-8b")
    assert set(shapes) == {(rows, SP_S // SP_M, cfg.d_model)}
    assert calls and set(calls) == {(SP_S, 0)}
    assert set(rec["roofline"]["collectives"]) == {
        "all-reduce", "all-gather", "reduce-scatter"}
