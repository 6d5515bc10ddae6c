"""Tensor-parallel training over ``model`` (``distributed.sharding``'s
``gather``, ``copy_to_model``, ``reduce_from_model`` and
``gather_from_model``, and the layers that call them) against the same
code unsharded, on the CPU.

Four gloo ranks, spawned once with a free localhost port, form a (1, 4)
and then a (2, 2) ("data", "model") mesh. The reduced configs compute in
fp32 (so a row's products round alike however they are split), with the
full config's ``fsdp`` and ``moe_parallelism``. On each mesh every rank:

- runs each block of ``BLOCKS`` tensor-parallel on its dp rows of one
  seeded input and the unsharded block on each dp rank's rows: outputs,
  the input's gradient and every parameter's gradient (gathered whole)
  within ``BLOCK_RTOL`` relative to the unsharded ones (the whole model's
  loss of each arch of ``TRAINS`` too; rwkv6-7b's at ``RWKV_LM_REL``).
  Reduced llama3-8b
  and chatglm3-6b have KV 2, which divides ``model`` at (2, 2) and is
  replicated at (1, 4); smollm-360m's 3 heads and recurrentgemma-2b's 2
  (at (1, 4)) do not divide, so attention computes each rank's chunk of
  the 16 queries at its offset (context parallelism; the reduced configs
  set no sequence parallelism, tests/test_torch_sp.py turns it on);
  qwen3's qk-norm,
  llama4's experts (each rank its own, tests/test_torch_ep.py) and shared
  expert, rwkv6's time mix
  (also at heads of 32, whose 2 heads do not divide 4 ranks: it computes
  whole) and channel mix, the Griffin block with its gather, and the
  vocab-parallel embedding and chunked CE (recurrentgemma's tied table);
- trains each of ``TRAINS`` ``STEPS`` steps with ``launch/train.py``
  (remat "full", 2 CE chunks), held against ``--mesh none`` on the same
  global batches: losses and the first step's gradient norm within
  ``LOSS_RTOL``, the weights within ``WEIGHT_RTOL`` (rwkv6-7b's and
  recurrentgemma-2b's within ``SPLIT_WEIGHT_RTOL``), every copy of a shard
  bitwise equal; the (1, 4) run's checkpoint restored into ``--mesh
  none`` holds the mesh's weights bitwise and gives the loss of those
  weights bitwise.

The spawn joins with a time limit of its own, so a hung rank fails the
tests instead of the run.
"""

import copy
import multiprocessing
import shutil
import socket

import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.checkpoint.manager import CheckpointManager  # noqa: E402
from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.data.synthetic import lm_batch  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import train as tr  # noqa: E402
from repro_torch.launch.mesh import make_sim_mesh  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import lm, ssm  # noqa: E402
from repro_torch.models.common import embed_tokens, trainable  # noqa: E402
from repro_torch.models.mlp import mlp_fwd  # noqa: E402
from repro_torch.models.moe import moe_fwd  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

RANKS, MESHES = 4, ((1, 4), (2, 2))
B, S, STEPS = 4, 16, 2
BLOCK_RTOL, LOSS_RTOL, WEIGHT_RTOL = 1e-5, 1e-5, 1e-4
# The split's sums round otherwise than the unsharded products, and AdamW's
# normalized step carries that into the weights: ten times the most that
# splitting every down-projection's sum in 2 or 4 blocks moves the
# unsharded run's weights in 2 steps (tools/tp_rounding.py --parts 2 / 4:
# 1.345e-4 / 1.017e-4 of a leaf's max in rwkv6-7b, 1.135e-4 / 1.498e-4 in
# recurrentgemma-2b); the other archs stay within WEIGHT_RTOL.
SPLIT_WEIGHT_RTOL = {"rwkv6-7b": 1.3e-3, "recurrentgemma-2b": 1.5e-3}
JOIN_S = 420
TRAINS = ("llama3-8b", "chatglm3-6b", "rwkv6-7b", "recurrentgemma-2b")


def config(arch, **kw):
    full = get_config(arch)
    return get_reduced(arch).replace(compute_dtype="float32", fsdp=full.fsdp,
                                     moe_parallelism=full.moe_parallelism,
                                     **kw)


def train_config(arch):
    return config(arch, remat="full", ce_chunks=2)


def opt():
    return OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)


# ---------------------------------------------------------------------------
# the blocks: name -> (arch, fn(module, x, tokens, targets, cfg) -> y)
# ---------------------------------------------------------------------------


def _positions(x):
    return torch.arange(x.shape[1])


def _attn(m, x, tok, tgt, cfg):
    kind = cfg.layer_kinds[0]
    window = cfg.attn_window if kind.startswith("attn_local") else 0
    return attn.attn_fwd(m.layers[0].attn, x, _positions(x), cfg,
                         window=window)


def _attn_local(m, x, tok, tgt, cfg):
    i = cfg.layer_kinds.index("attn_local")
    return attn.attn_fwd(m.layers[i].attn, x, _positions(x), cfg,
                         window=cfg.attn_window)


def _mlp(m, x, tok, tgt, cfg):
    return mlp_fwd(m.layers[0].mlp, x, cfg)


def _moe(m, x, tok, tgt, cfg):
    i = cfg.layer_kinds.index("moe")
    y, aux = moe_fwd(m.layers[i].moe, x, cfg)
    return y + aux["moe_lb_loss"] + aux["moe_z_loss"]


def _timemix(m, x, tok, tgt, cfg):
    return ssm.rwkv_timemix(m.layers[0].tm, x, ssm.init_rwkv_state(
        cfg, x.shape[0]), cfg)[0]


def _channelmix(m, x, tok, tgt, cfg):
    return ssm.rwkv_channelmix(m.layers[0].tm, x, ssm.init_rwkv_state(
        cfg, x.shape[0]), cfg)[0]


def _rglru(m, x, tok, tgt, cfg):
    return ssm.rglru_block(m.layers[0].rec, x, ssm.init_rglru_state(
        cfg, x.shape[0]), cfg)[0]


def _loss(m, x, tok, tgt, cfg):
    """The whole model's ``lm_loss`` (x unused: its gradient is zero)."""
    return lm.lm_loss(m, {"inputs": tok, "targets": tgt}, cfg)[0] \
        + 0.0 * x.sum()


def _vocab(m, x, tok, tgt, cfg):
    """The vocab-parallel lookup into the residual, then the chunked CE
    over the vocab-parallel head (the tied table for recurrentgemma)."""
    h = embed_tokens(m.embedding, tok, cfg).float() + x
    return lm._chunked_ce(m, h, tgt, cfg.replace(ce_chunks=2))


BLOCKS = {
    "attn-llama3": ("llama3-8b", _attn),
    "attn-chatglm3": ("chatglm3-6b", _attn),
    "attn-smollm": ("smollm-360m", _attn),
    "attn-recurrentgemma": ("recurrentgemma-2b", _attn_local),
    "attn-qwen3-qknorm": ("qwen3-moe-30b-a3b", _attn),
    "mlp-llama3": ("llama3-8b", _mlp),
    "moe-llama4": ("llama4-maverick-400b-a17b", _moe),
    "timemix-rwkv6": ("rwkv6-7b", _timemix),
    "channelmix-rwkv6": ("rwkv6-7b", _channelmix),
    # heads of 32: d 64 divides 4 ranks, its 2 heads do not (the time mix
    # computes whole on every rank)
    "timemix-rwkv6-heads-whole": ("rwkv6-7b", _timemix),
    "rglru-recurrentgemma": ("recurrentgemma-2b", _rglru),
    "vocab-llama3": ("llama3-8b", _vocab),
    "vocab-recurrentgemma-tied": ("recurrentgemma-2b", _vocab),
}
# the whole model's loss and gradients, at the train configs (remat "full",
# 2 CE chunks), for each arch that trains below
BLOCKS.update({f"lm-{a}": (a, _loss) for a in TRAINS})
# rwkv6-7b's model gradients are ill-conditioned in fp32: two fp32 WKV
# orders give leaf gradients 5.2e-5 of their max apart (ROADMAP Watch
# points); tests/test_torch_ssm_train.py holds the model there at 2e-4
RWKV_LM_REL = 2e-4


def block_rtol(name):
    return RWKV_LM_REL if name == "lm-rwkv6-7b" else BLOCK_RTOL


def rel(a, b):
    """max |a - b| / max |b| (1 where b is all zeros)."""
    scale = float(b.abs().max()) or 1.0
    return float((a - b).abs().max()) / scale


def block_inputs(cfg):
    g = torch.Generator().manual_seed(7)
    x = torch.randn(B, S, cfg.d_model, generator=g)
    tok = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    tgt = torch.randint(0, cfg.vocab_size, (B, S), generator=g)
    tgt[0, :3] = -1                                     # masked targets
    return x, tok, tgt


def block_errors(name, mesh):
    """{what: relative error} of block ``name`` on ``mesh`` against the
    unsharded block (every rank takes part: the gradients are gathered
    whole)."""
    arch, fn = BLOCKS[name]
    cfg = train_config(arch) if name.startswith("lm-") else config(arch)
    if name.endswith("heads-whole"):
        cfg = cfg.replace(rwkv_head_dim=32)
    module = trainable(lm.init_lm(cfg, seed=0, device="cpu"))
    ref = copy.deepcopy(module)
    sharding.shard_module(module, mesh, cfg)
    x, tok, tgt = block_inputs(cfg)
    i, n_dp = sharding.dp_index(mesh)
    rows = [slice(d * B // n_dp, (d + 1) * B // n_dp) for d in range(n_dp)]
    gy = torch.randn(fn(ref, x[rows[0]], tok[rows[0]], tgt[rows[0]],
                        cfg).shape, generator=torch.Generator().manual_seed(3))

    named = [(n, p) for n, p in ref.named_parameters()]
    xr = x.clone().requires_grad_()
    ys = [fn(ref, xr[r], tok[r], tgt[r], cfg) for r in rows]
    want = torch.autograd.grad(sum((y * gy).sum() for y in ys),
                               [p for _, p in named] + [xr],
                               allow_unused=True)

    params = dict(module.named_parameters())
    xl = x[rows[i]].clone().requires_grad_()
    with sharding.activation_sharding(mesh, cfg, "train"):
        y = fn(module, xl, tok[rows[i]], tgt[rows[i]], cfg)
        got = torch.autograd.grad((y * gy).sum(),
                                  [params[n] for n, _ in named] + [xl],
                                  allow_unused=True)
    errs = {"y": rel(y.detach(), ys[i].detach()),
            "dx": rel(got[-1], want[-1][rows[i]])}
    for (n, _), g, w in zip(named, got[:-1], want[:-1]):
        if (g is None) != (w is None):
            errs[n] = float("inf")
        elif g is not None:
            errs[n] = rel(sharding.whole(g), w)
    return errs


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------


def run(cfg, steps, ckpt_dir, mesh=None, restore=False):
    return tr.train(cfg, opt(), steps=steps, batch=B, seq=S, mesh=mesh,
                    ckpt_dir=str(ckpt_dir), restore=restore, log_every=100,
                    device="cpu")


def run_norms(cfg, steps, ckpt_dir, mesh=None):
    """``run``, also returning each step's ``grad_norm`` metric (the
    global norm before clipping), read from the step ``tr.build`` makes."""
    norms = []
    build = tr.build

    def recording(*args, **kw):
        params, state, step = build(*args, **kw)

        def step_fn(params, state, batch):
            params, state, metrics = step(params, state, batch)
            norms.append(float(metrics["grad_norm"]))
            return params, state, metrics
        return params, state, step_fn
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tr, "build", recording)
        return run(cfg, steps, ckpt_dir, mesh) + (norms,)


def shard_key(p):
    """Where a local shard sits: its coordinates on the mesh dims that
    shard the leaf (ranks equal here hold copies of one shard)."""
    return tuple(c for c, pl in zip(p.device_mesh.get_coordinate(),
                                    p.placements) if pl.is_shard())


def mesh_train(arch, mesh, ckpt_dir):
    params, _, losses, norms = run_norms(train_config(arch), STEPS, ckpt_dir,
                                         mesh)
    return {"losses": losses, "grad_norms": norms,
            "local": {n: (shard_key(p), p.to_local().detach().clone())
                      for n, p in params.named_parameters()},
            "whole": {n: sharding.whole(p)
                      for n, p in params.named_parameters()}}


def _worker(rank, port, out):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=RANKS)
    try:
        res = {}
        for shape in MESHES:
            mesh = make_sim_mesh(RANKS, shape, ("data", "model"))
            tag = "x".join(map(str, shape))
            for name in BLOCKS:
                res[(tag, name)] = block_errors(name, mesh)
            for arch in TRAINS:
                res[(tag, arch)] = mesh_train(arch, mesh,
                                              out / f"{tag}-{arch}")
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
    out = tmp_path_factory.mktemp("tp")
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
    return out, [torch.load(out / f"rank{r}.pt") for r in range(RANKS)]


@pytest.fixture(scope="module")
def unsharded(ranks):
    """``--mesh none`` on each arch of ``TRAINS``: (module after STEPS,
    losses, grad norms of STEPS steps)."""
    out, _ = ranks
    runs = {arch: run_norms(train_config(arch), STEPS, out / f"none-{arch}")
            for arch in TRAINS}
    return {arch: (params, losses, norms)
            for arch, (params, _, losses, norms) in runs.items()}


MESH_TAGS = ["x".join(map(str, m)) for m in MESHES]


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("block", list(BLOCKS))
def test_block_matches_unsharded(block, mesh, ranks):
    for r, res in enumerate(ranks[1]):
        errs = res[(mesh, block)]
        worst = max(errs, key=errs.get)
        assert errs[worst] <= block_rtol(block), \
            f"rank {r}: {worst} off by {errs[worst]:.2e} ({errs})"


def test_blocks_split_as_the_rules_say():
    """The cases above reach each path of the layers: a split and a
    replicated KV projection, attention whole, the lru, ff and vocab
    splits (the rules' divisibility, read on the reduced configs)."""
    llama, rg, smol = (config(a) for a in ("llama3-8b", "recurrentgemma-2b",
                                           "smollm-360m"))
    assert llama.n_kv_heads == 2 and llama.n_heads == 4
    assert llama.n_kv_heads % 4 and not llama.n_kv_heads % 2
    assert smol.n_heads % 4 and smol.n_heads % 2
    assert rg.n_heads % 4 and not rg.n_heads % 2 and rg.n_kv_heads == 1
    assert rg.tie_embeddings and not rg.lru_width % 4
    assert not llama.d_ff % 4 and not llama.padded_vocab % 4


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("arch", TRAINS)
def test_train_matches_unsharded(arch, mesh, ranks, unsharded):
    """The launcher's losses, the first step's gradient norm (the same
    weights) and the weights after the steps on the mesh against
    ``--mesh none``'s, every copy of a shard bitwise equal. AdamW's step
    does not see a constant factor on every gradient; the norm does (a
    loss divided by the wrong count, a replicated leaf counted once a
    rank)."""
    module, losses, norms = unsharded[arch]
    res = [r[(mesh, arch)] for r in ranks[1]]
    want = {n: p.detach() for n, p in module.named_parameters()}
    for r, got in enumerate(res):
        worst = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                        losses))
        assert len(got["losses"]) == STEPS and worst <= LOSS_RTOL, \
            f"rank {r}: losses {got['losses']} vs {losses}"
        first = abs(got["grad_norms"][0] - norms[0]) / norms[0]
        assert len(got["grad_norms"]) == STEPS and first <= LOSS_RTOL, \
            f"rank {r}: grad norms {got['grad_norms']} vs {norms}"
    assert res[0]["whole"].keys() == want.keys()
    worst = max(rel(res[0]["whole"][n], w) for n, w in want.items())
    assert worst <= SPLIT_WEIGHT_RTOL.get(arch, WEIGHT_RTOL), \
        f"weights off by {worst:.2e}"
    for name in res[0]["local"]:
        copies = {}
        for got in res:
            key, t = got["local"][name]
            assert torch.equal(copies.setdefault(key, t), t), name


@pytest.mark.parametrize("arch", TRAINS)
def test_tp_checkpoint_restores_unsharded(arch, ranks):
    """The (1, 4) run's checkpoint restored into ``--mesh none``: its
    weights are the mesh's, bitwise, and step 3's loss is the unsharded
    loss of those weights, bitwise."""
    out, res = ranks
    cfg = train_config(arch)
    one = out / f"restore-{arch}"
    shutil.copytree(out / f"1x4-{arch}", one)
    whole = res[0][("1x4", arch)]["whole"]
    _, _, tail = run(cfg, STEPS + 1, one, restore=True)
    module = trainable(lm.init_lm(cfg, seed=0, device="cpu"))
    state, _, step = CheckpointManager(str(one)).restore({"params": module},
                                                         step=STEPS)
    assert step == STEPS
    for n, p in state["params"].named_parameters():
        assert torch.equal(p, whole[n]), n
    with torch.no_grad():
        batch = lm_batch(cfg, B, S, seed=0, step=STEPS)
        want = float(lm.lm_loss(state["params"], batch, cfg)[0])
    assert tail == [want], f"{tail} vs {want}"
