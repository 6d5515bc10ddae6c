"""Serving on a mesh (``distributed.sharding``'s serve switch, ``dot`` and
the caches placed by ``cache_spec_tree``) against the same code unsharded,
on the CPU.

Four gloo ranks, spawned once with a free localhost port, form a (1, 4)
and then a (2, 2) ("data", "model") mesh. The reduced configs compute in
fp32, with the full config's ``fsdp`` and ``moe_parallelism``. For each of
the ten ``ARCH_IDS`` every rank:

- stores one copy of seed 0's weights by the train rules and prefills its
  rows of one seeded batch tensor-parallel (as the reference's dry run
  compiles a prefill cell), and one copy by the serve rules and decodes
  ``STEPS`` tokens on their 2-D shards (the reference's decode cell), fed
  the unsharded run's greedy tokens: the prefill's and every step's
  logits (gathered over the vocab) within ``LOGIT_RTOL`` of their max
  against unsharded ``lm.prefill`` / ``lm.decode_step``, the same greedy
  tokens;
- holds each cache shard after the prefill to the shape that
  ``cache_spec_tree`` gives the unsharded caches and to the chunk of them
  it places there.

Reduced llama3-8b and chatglm3-6b (KV 2) split their K/V caches over the
head dim at (1, 4) and over KV heads at (2, 2); smollm-360m (KV 1, hd 20)
and recurrentgemma-2b (KV 1) over the head dim on both; whisper-small's
cross caches too. The spawn joins with a time limit of its own, so a hung
rank fails the tests instead of the run.

Beside the spawn: the tensor-parallel state is a thread's own; a prefill
and a decode dry-run cell on a fake (2, 2) group count the collective
bytes reckoned here, the decode cell no all-gather.
"""

import copy
import multiprocessing
import socket
import threading

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import (ARCH_IDS, get_config,  # noqa: E402
                                          get_reduced)
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_sim_mesh  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.common import vocab_lo  # noqa: E402

RANKS, MESHES = 4, ((1, 4), (2, 2))
# rows, prompt tokens (past recurrentgemma's reduced window of 16: its ring
# cache rotates), decode steps
B, S, STEPS = 4, 20, 4
LOGIT_RTOL = 1e-5
JOIN_S = 420


def config(arch):
    full = get_config(arch)
    return get_reduced(arch).replace(compute_dtype="float32", fsdp=full.fsdp,
                                     moe_parallelism=full.moe_parallelism)


def prompt(cfg):
    """The global batch: seeded tokens, and the frontend's stub input
    (llava's patches, whisper's frames) where the arch takes one."""
    g = torch.Generator().manual_seed(11)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.frontend in ("vision_patches", "audio_frames"):
        key = "patches" if cfg.frontend == "vision_patches" else "frames"
        batch[key] = 0.02 * torch.randn(B, cfg.frontend_seq, cfg.d_model,
                                        generator=g)
    return batch


def rel(a, b):
    """max |a - b| / max |b| (1 where b is all zeros)."""
    scale = float(b.abs().max()) or 1.0
    return float((a - b).abs().max()) / scale


def spec_chunk(full, spec, mesh):
    """This rank's chunk of ``full`` as ``spec`` places it: each dim cut
    by its axes in turn, major to minor."""
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    for dim, axes in enumerate(spec):
        for a in axes or ():
            full = full.chunk(sizes[a], dim)[coord[a]]
    return full


def whole_logits(logits, params, cfg):
    """The rank's vocab slice of the logits gathered over ``model`` (in
    the step's context)."""
    if vocab_lo(params, cfg) is None:
        return logits
    return sharding.gather_from_model(logits)


def serve_errors(arch, mesh):
    """What one rank's serving of ``arch`` on ``mesh`` shows against the
    unsharded run: {"prefill": rel error, "decode": [rel error a step],
    "tokens": same greedy tokens, "caches": {leaf: (shape as the spec
    says, rel error against the spec's chunk)}, "split": the K/V caches'
    split}."""
    cfg = config(arch)
    module = lm.init_lm(cfg, seed=0, device="cpu")
    train_m, serve_m = copy.deepcopy(module), copy.deepcopy(module)
    sharding.shard_module(train_m, mesh, cfg, "train")
    sharding.shard_module(serve_m, mesh, cfg, "serve")
    batch = prompt(cfg)
    cache_len = lm.prefix_len(batch, cfg) + S + STEPS
    i, n_dp = sharding.dp_index(mesh)
    rows = slice(i * B // n_dp, (i + 1) * B // n_dp)

    with torch.no_grad():
        logits, caches, t = lm.prefill(module, batch, cfg, cache_len)
        want_caches = copy.deepcopy(caches)
        want, toks = [logits], [logits.argmax(-1)[:, None]]
        for s in range(STEPS):
            logits, caches = lm.decode_step(module, caches, toks[-1], t + s,
                                            cfg)
            want.append(logits)
            toks.append(logits.argmax(-1)[:, None])

        out = {"caches": {}}
        with sharding.activation_sharding(mesh, cfg, "train"):
            got, shards, t_local = lm.prefill(
                train_m, sharding.local_rows(batch, mesh), cfg, cache_len)
            got = whole_logits(got, train_m, cfg)
            out["split"] = attn._cache_split(cfg)
        assert t_local == t
        errs, same = [rel(got, want[0][rows])], [
            torch.equal(got.argmax(-1), want[0][rows].argmax(-1))]
        specs = sharding.cache_spec_tree(want_caches, mesh, cfg)
        for layer, (mine, full, spec) in enumerate(zip(shards, want_caches,
                                                       specs)):
            for (path, a), (_, w), (_, sp) in zip(
                    sharding._leaves(mine), sharding._leaves(full),
                    sharding._leaves(spec)):
                chunk = spec_chunk(w, sp, mesh)
                out["caches"][f"{layer}/{path}"] = (
                    tuple(a.shape) == sharding.shard_shape(w.shape, sp, mesh)
                    == tuple(chunk.shape), rel(a, chunk))
        with sharding.activation_sharding(mesh, cfg, "serve"):
            for s in range(STEPS):
                got, shards = lm.decode_step(serve_m, shards, toks[s][rows],
                                             t + s, cfg)
                got = whole_logits(got, serve_m, cfg)
                errs.append(rel(got, want[s + 1][rows]))
                same.append(torch.equal(got.argmax(-1),
                                        want[s + 1][rows].argmax(-1)))
    out.update(prefill=errs[0], decode=errs[1:], tokens=all(same))
    return out


def _worker(rank, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=RANKS)
    try:
        res = {}
        for shape in MESHES:
            mesh = make_sim_mesh(RANKS, shape, ("data", "model"))
            tag = "x".join(map(str, shape))
            for arch in ARCH_IDS:
                res[(tag, arch)] = serve_errors(arch, mesh)
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, from one spawn of ``RANKS`` gloo ranks."""
    out = tmp_path_factory.mktemp("tp_serve")
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, out))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(JOIN_S)
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.terminate()
        p.join(10)
    assert not hung, f"{len(hung)} rank(s) still running after {JOIN_S} s"
    assert [p.exitcode for p in procs] == [0] * RANKS
    return [torch.load(out / f"rank{r}.pt") for r in range(RANKS)]


MESH_TAGS = ["x".join(map(str, m)) for m in MESHES]


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_serving_matches_unsharded(arch, mesh, ranks):
    """Prefill under the train rules and decode on the serve rules' shards:
    each rank's logits against the unsharded run's rows, and the same
    greedy tokens."""
    for r, res in enumerate(ranks):
        got = res[(mesh, arch)]
        worst = max([got["prefill"]] + got["decode"])
        assert len(got["decode"]) == STEPS
        assert worst <= LOGIT_RTOL, \
            f"rank {r}: prefill {got['prefill']:.2e}, decode {got['decode']}"
        assert got["tokens"], f"rank {r}: greedy tokens differ"


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_shards_as_cache_spec_tree_places_them(arch, mesh, ranks):
    """After the prefill each rank holds its shard of every cache leaf: the
    shape ``cache_spec_tree`` gives the unsharded caches, and the chunk of
    them it places there."""
    for r, res in enumerate(ranks):
        caches = res[(mesh, arch)]["caches"]
        assert caches
        for leaf, (shape_ok, err) in caches.items():
            assert shape_ok, f"rank {r}: {leaf} has another shape"
            assert err <= LOGIT_RTOL, f"rank {r}: {leaf} off by {err:.2e}"


@pytest.mark.parametrize("arch,split", [
    ("llama3-8b", {"1x4": "head_dim", "2x2": "heads"}),
    ("chatglm3-6b", {"1x4": "head_dim", "2x2": "heads"}),
    ("smollm-360m", {"1x4": "head_dim", "2x2": "head_dim"}),
    ("recurrentgemma-2b", {"1x4": "head_dim", "2x2": "head_dim"}),
    ("whisper-small", {"1x4": "heads", "2x2": "heads"})])
def test_kv_caches_split_as_the_rules_say(arch, split, ranks):
    """KV 2 falls back to the head dim on 4 ranks and divides 2; KV 1 (and
    smollm's 20-wide heads) always take the head dim; every arch above is
    held by the two tests before."""
    for res in ranks:
        assert {m: res[(m, arch)]["split"] for m in MESH_TAGS} == split


# ---------------------------------------------------------------------------
# the tensor-parallel state is a thread's own
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_group():
    """A fake process group of 4 ranks (this process rank 0), torn down
    after the test."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("mode", ["train", "serve"])
def test_tp_state_is_per_thread(mode, fake_group):
    """A thread inside a train-mode or serve-mode context leaves another
    thread's ``tp()`` at rank 0 of 1 (and its ``data2d()`` None); the
    context ``running()`` reads on one thread is what ``resume`` puts in
    force on another (autograd's backward thread, where remat recomputes a
    layer)."""
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    cfg = config("llama3-8b")
    entered, done = threading.Event(), threading.Event()
    seen = {}

    def stepping():
        with sharding.activation_sharding(mesh, cfg, mode):
            seen["inside"] = sharding.tp()
            seen["state"] = sharding.running()
            entered.set()
            done.wait(30)

    other = threading.Thread(target=stepping)
    other.start()
    try:
        assert entered.wait(30)
        assert sharding.tp() == sharding.TP(0, 1, None, None)
        assert sharding.data2d() is None
        with sharding.resume(seen["state"]):
            assert sharding.tp() == seen["inside"]
            assert (sharding.data2d() is not None) == (mode == "serve")
        assert sharding.tp().mesh is None
    finally:
        done.set()
        other.join(30)
    assert seen["inside"].size == 2 and seen["inside"].mode == mode


# ---------------------------------------------------------------------------
# dry-run serving cells on a fake (2, 2) group
# ---------------------------------------------------------------------------

CELL_ROWS, CELL_SEQ = 8, 32


def prefill_bytes(cfg, rows, seq):
    """{kind: bytes} of one reduced llama3-8b prefill on a (2, 2) mesh
    (fsdp on, bf16 compute), reckoned from the shapes. All-gather: each
    parameter the train rules shard over ``data`` gathered over it once,
    at use, its ``model`` shard in the dtype it is used in (the embedding
    table in its fp32, the rest in bf16): the table (V/2, d), a layer's
    wq (d, H/2, hd), wk and wv (d, KV/2, hd), wo (H/2, hd, d), the MLP's
    wi, wg (d, ff/2) and wo (ff/2, d), the head (d, V/2). All-reduce: the
    rank's rows (B/2, S, d) in bf16 after the vocab-parallel lookup and
    after each layer's two row-parallel products."""
    d, H, KV, hd, ff, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.padded_vocab)
    layer = (d * H // 2 * hd + 2 * d * KV // 2 * hd + H // 2 * hd * d
             + 3 * d * ff // 2) * 2
    gather = V // 2 * d * 4 + cfg.n_layers * layer + d * V // 2 * 2
    act = rows // 2 * seq * d * 2
    return {"all-gather": gather, "all-reduce": act * (1 + 2 * cfg.n_layers)}


def decode_bytes(cfg, rows):
    """{kind: bytes} of one reduced llama3-8b decode step on a (2, 2) mesh
    by the serve rules, reckoned from the shapes: all-reduces only, each
    the result bytes of one. A ``"data2d"`` product gathers the token rows
    of both ``data`` ranks (b = ``rows``, the global batch, of one token
    each, in bf16) and
    then sums either its partial outputs (contracted: wq, wk, wv, wi, wg,
    the head) or its columns in a zeroed full-width buffer (output dim:
    attention's and the MLP's wo); the row-parallel products add their
    ``model`` all-reduce of the rank's rows. The lookup gathers the token
    ids (int64), sums its vocab slice over ``model`` and its columns over
    ``data``. KV 2 divides 2: the K/V caches hold the rank's KV head, no
    gather."""
    d, H, KV, hd, ff, V = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.head_dim, cfg.d_ff, cfg.padded_vocab)
    b, half = rows, rows // 2

    def bf16(*shape):
        n = 2
        for s in shape:
            n *= s
        return n
    lookup = b * 8 + bf16(b, d // 2) + bf16(b, d)
    attention = (3 * bf16(b, d) + bf16(b, H // 2 * hd)
                 + 2 * bf16(b, KV // 2 * hd)            # wq, wk, wv
                 + bf16(b, H // 2 * hd) + bf16(b, d) + bf16(half, d))  # wo
    mlp = (2 * (bf16(b, d) + bf16(b, ff // 2))           # wi, wg
           + bf16(b, ff // 2) + bf16(b, d) + bf16(half, d))  # wo
    head = bf16(b, d) + bf16(b, V // 2)
    return {"all-reduce": lookup + cfg.n_layers * (attention + mlp) + head}


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dryrun_serving_cell_bytes(kind):
    """A reduced llama3-8b prefill cell (train rules, fsdp on) and decode
    cell (serve rules) on a fake (2, 2) group: their collective bytes by
    kind are the reckoning's; the decode cell gathers no weight (no
    all-gather at all), its cache shards the rank's rows and KV head."""
    cfg = get_reduced("llama3-8b").replace(fsdp=True)
    assert cfg.compute_dtype == "bfloat16" and cfg.n_kv_heads == 2
    sc = ShapeConfig(f"{kind}_small", kind, CELL_SEQ, CELL_ROWS)
    rec = dryrun.run_cell("llama3-8b", sc, (2, 2), {"fsdp": True},
                          reduced=True)
    assert not dist.is_initialized()
    coll = rec["roofline"]["collectives"]
    if kind == "prefill":
        assert coll == prefill_bytes(cfg, CELL_ROWS, CELL_SEQ)
        return
    assert coll == decode_bytes(cfg, CELL_ROWS)
    assert "all-gather" not in coll
    kv = 2 * cfg.n_layers * (CELL_ROWS // 2) * CELL_SEQ * 1 * cfg.head_dim * 2
    params = rec["memory_analysis"]["parameter_bytes"]
    assert rec["memory_analysis"]["argument_size_bytes"] == \
        params + kv + CELL_ROWS // 2 * 4


def test_dryrun_decode_cell_of_an_encoder_decoder():
    """whisper-small's decode cell: each ``dec_attn`` layer's caches as its
    prefill leaves them, the encoder's cross K/V over the frames beside the
    self cache (the reference allocates both), each the rank's shard (KV 4
    over ``model`` 2, rows over ``data`` 2); no all-gather."""
    cfg = get_reduced("whisper-small")
    assert cfg.n_kv_heads == 4 and set(cfg.layer_kinds) == {"dec_attn"}
    sc = ShapeConfig("decode_small", "decode", CELL_SEQ, CELL_ROWS)
    rec = dryrun.run_cell("whisper-small", sc, (2, 2), reduced=True)
    assert not dist.is_initialized()
    coll = rec["roofline"]["collectives"]
    assert coll.get("all-reduce") and "all-gather" not in coll
    kv = (2 * len(cfg.layer_kinds) * (CELL_ROWS // 2)
          * (CELL_SEQ + cfg.frontend_seq) * (cfg.n_kv_heads // 2)
          * cfg.head_dim * 2)
    mem = rec["memory_analysis"]
    assert mem["argument_size_bytes"] == \
        mem["parameter_bytes"] + kv + CELL_ROWS // 2 * 4
