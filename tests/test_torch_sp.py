"""Sequence and context parallelism over ``model`` (``distributed.sharding``'s
``seq_split``, ``context_parallel``, ``gather_seq``, ``scatter_seq`` and
``gather_from_model`` along the sequence, and the layers that call them)
against the same code unsharded, on the CPU.

Four gloo ranks, spawned once with a free localhost port, form a (1, 4)
and then a (2, 2) ("data", "model") mesh. The reduced configs compute in
fp32 with the full config's ``fsdp``, ``moe_parallelism`` and
``sequence_parallel`` (the reduced ones turn the last off). On each mesh
every rank:

- runs each block of ``BLOCKS`` on its dp rows of one seeded input: a
  sequence-parallel block (``sp``) on the rank's chunk of the sequence, as
  the residual stream holds it, the others on the whole sequence; outputs,
  the input's gradient and every parameter's gradient (gathered whole)
  within ``BLOCK_RTOL`` of the unsharded block's. Attention under SP with
  its heads split (llama3-8b; chatglm3-6b, whose 2 KV heads are
  replicated at (1, 4)), under SP and context parallelism (smollm-360m: 3
  reduced heads, 15 at full width, divide neither mesh's ``model``),
  local attention under CP past the reduced window of 16
  (recurrentgemma-2b at 24 positions, (1, 4) only: its 2 heads split on
  (2, 2)), cross-attention under CP (whisper-small at 3 heads), qwen3's
  qk-norm, llama4's MoE and a whole layer under SP, the vocab-parallel
  embedding and the chunked CE under SP; the whole model's ``lm_loss`` of
  each of ``TRAINS``;
- trains each of ``TRAINS`` ``STEPS`` steps with ``launch/train.py``
  against ``--mesh none`` (losses and the first step's gradient norm
  within ``LOSS_RTOL``, weights within ``WEIGHT_RTOL``, recurrentgemma-2b's
  within test_torch_tp.py's split tolerance), and prefills under the
  train rules (context parallelism, no SP) against unsharded
  ``lm.prefill``: logits gathered over the vocab within ``BLOCK_RTOL``;
- records what the layers received: the residual's shape inside each
  layer and the ``(Sq, q_offset)`` of every flash call, for a step whose
  sequence splits and for one that ``_fit`` rejects (6 and 2 positions on
  4 ``model`` ranks, 5 and 1 on 2), which computes whole.

The spawn joins with a time limit of its own, so a hung rank fails the
tests instead of the run.
"""

import copy
import multiprocessing
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.launch import train as tr  # noqa: E402
from repro_torch.launch.mesh import make_sim_mesh  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import blocks, lm  # noqa: E402
from repro_torch.models.common import (embed_tokens, head_fwd,  # noqa: E402
                                       head_input, trainable, vocab_lo)
from repro_torch.models.mlp import mlp_fwd  # noqa: E402
from repro_torch.models.moe import moe_fwd  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

RANKS, MESHES = 4, ((1, 4), (2, 2))
B, S, STEPS = 4, 16, 2
BLOCK_RTOL, LOSS_RTOL, WEIGHT_RTOL = 1e-5, 1e-5, 1e-4
# test_torch_tp.py's SPLIT_WEIGHT_RTOL: AdamW carries the split sums'
# rounding into recurrentgemma-2b's weights
SPLIT_WEIGHT_RTOL = {"recurrentgemma-2b": 1.5e-3}
JOIN_S = 300
TRAINS = ("smollm-360m", "llama3-8b", "recurrentgemma-2b")
# sequences that _fit does not split over each mesh's model ranks: not a
# multiple, shorter
UNFIT = {"1x4": (6, 2), "2x2": (5, 1)}


def config(arch, **kw):
    full = get_config(arch)
    return get_reduced(arch).replace(
        compute_dtype="float32", fsdp=full.fsdp,
        moe_parallelism=full.moe_parallelism,
        sequence_parallel=full.sequence_parallel, **kw)


def train_config(arch):
    return config(arch, remat="full", ce_chunks=2)


def opt():
    return OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)


# ---------------------------------------------------------------------------
# the blocks: name -> (arch, config overrides, sequence length, sp,
# fn(module, x, tokens, targets, cfg, sp) -> y)
# ---------------------------------------------------------------------------


def _attn(m, x, tok, tgt, cfg, sp):
    kind = cfg.layer_kinds[0]
    window = cfg.attn_window if kind.startswith("attn_local") else 0
    return attn.attn_fwd(m.layers[0].attn, x, torch.arange(seq_len(cfg)),
                         cfg, window=window, sp=sp)


def _attn_local(m, x, tok, tgt, cfg, sp):
    i = cfg.layer_kinds.index("attn_local")
    return attn.attn_fwd(m.layers[i].attn, x, torch.arange(seq_len(cfg)),
                         cfg, window=cfg.attn_window, sp=sp)


def _cross(m, x, tok, tgt, cfg, sp):
    """Cross-attention over an encoder output made from x (so its gradient
    reaches x through both uses)."""
    enc = 0.5 * x.flip(1)[:, :12]
    return attn.cross_prefill(m.layers[0].xattn, x, enc, cfg, sp=sp)[0]


def _mlp(m, x, tok, tgt, cfg, sp):
    return mlp_fwd(m.layers[0].mlp, x, cfg, sp)


def _moe(m, x, tok, tgt, cfg, sp):
    """The MoE FFN's output, and its aux values as a term of the loss of
    their own (as ``lm_loss`` adds them: the same on every ``model``
    rank, where a term of the chunk's output would take only the chunk's
    share of their gradient)."""
    i = cfg.layer_kinds.index("moe")
    y, aux = moe_fwd(m.layers[i].moe, x, cfg, sp=sp)
    return y, aux["moe_lb_loss"] + aux["moe_z_loss"]


def _layer(m, x, tok, tgt, cfg, sp):
    ctx = {"positions": torch.arange(seq_len(cfg)), "sp": sp}
    return blocks.layer_fwd(cfg.layer_kinds[0], m.layers[0], x, ctx, cfg)[0]


def _vocab(m, x, tok, tgt, cfg, sp):
    """The vocab-parallel lookup into the residual (the rank's chunk under
    SP), then the final norm, the gather and the chunked CE over the
    vocab-parallel head."""
    h = embed_tokens(m.embedding, tok, cfg, sp=sp).float() + x
    h = head_input(m, h, cfg, sp)
    return lm._chunked_ce(m, h, tgt, cfg.replace(ce_chunks=2), head_fwd)


def _loss(m, x, tok, tgt, cfg, sp):
    """The whole model's ``lm_loss`` (x unused: its gradient is zero)."""
    return lm.lm_loss(m, {"inputs": tok, "targets": tgt}, cfg)[0] \
        + 0.0 * x.sum()


BLOCKS = {
    "attn-sp-llama3": ("llama3-8b", {}, _attn, True),
    "attn-sp-chatglm3": ("chatglm3-6b", {}, _attn, True),
    "attn-sp-cp-smollm": ("smollm-360m", {}, _attn, True),
    "attn-sp-qwen3-qknorm": ("qwen3-moe-30b-a3b", {}, _attn, True),
    "attn-cp-recurrentgemma-local": ("recurrentgemma-2b", {}, _attn_local,
                                     False),
    "cross-cp-whisper": ("whisper-small", {"n_heads": 3, "n_kv_heads": 3},
                         _cross, False),
    "mlp-sp-llama3": ("llama3-8b", {}, _mlp, True),
    "moe-sp-llama4": ("llama4-maverick-400b-a17b", {}, _moe, True),
    "layer-sp-cp-smollm": ("smollm-360m", {}, _layer, True),
    "layer-sp-llama3": ("llama3-8b", {}, _layer, True),
    "vocab-sp-llama3": ("llama3-8b", {}, _vocab, True),
}
BLOCKS.update({f"lm-{a}": (a, None, _loss, False) for a in TRAINS})
# sequence lengths: recurrentgemma's local attention past its window of 16
SEQ = {"recurrentgemma-2b": 24}
# recurrentgemma's 2 heads split over 2 ranks: no CP at (2, 2)
ONLY_1X4 = ("attn-cp-recurrentgemma-local",)


def block_config(name):
    arch, kw, _, _ = BLOCKS[name]
    return train_config(arch) if kw is None else config(arch, **kw)


def seq_len(cfg):
    return SEQ.get(cfg.name, S)


def rel(a, b):
    """max |a - b| / max |b| (1 where b is all zeros)."""
    scale = float(b.abs().max()) or 1.0
    return float((a - b).abs().max()) / scale


def block_inputs(cfg):
    g = torch.Generator().manual_seed(7)
    n = seq_len(cfg)
    x = torch.randn(B, n, cfg.d_model, generator=g)
    tok = torch.randint(0, cfg.vocab_size, (B, n), generator=g)
    tgt = torch.randint(0, cfg.vocab_size, (B, n), generator=g)
    tgt[0, :3] = -1                                     # masked targets
    return x, tok, tgt


def chunk(t, sp):
    """The rank's chunk of the sequence (dim 1) under SP, else all of
    it."""
    return t[:, sharding.rank_slice(t.shape[1])] if sp else t


def _out(y):
    """A block's (output, a scalar term of the loss: 0.0 where it has
    none)."""
    return y if isinstance(y, tuple) else (y, 0.0)


def block_errors(name, mesh):
    """{what: relative error} of block ``name`` on ``mesh`` against the
    unsharded block (every rank takes part: the gradients are gathered
    whole). A scalar output (a loss) is the same on every rank; another
    output is held on the rank's chunk under SP."""
    arch, _, fn, sp = BLOCKS[name]
    cfg = block_config(name)
    module = trainable(lm.init_lm(cfg, seed=0, device="cpu"))
    ref = copy.deepcopy(module)
    sharding.shard_module(module, mesh, cfg)
    x, tok, tgt = block_inputs(cfg)
    i, n_dp = sharding.dp_index(mesh)
    rows = [slice(d * B // n_dp, (d + 1) * B // n_dp) for d in range(n_dp)]
    gy = torch.randn(_out(fn(ref, x[rows[0]], tok[rows[0]], tgt[rows[0]],
                             cfg, False))[0].shape,
                     generator=torch.Generator().manual_seed(3))

    named = [(n, p) for n, p in ref.named_parameters()]
    xr = x.clone().requires_grad_()
    outs = [_out(fn(ref, xr[r], tok[r], tgt[r], cfg, False)) for r in rows]
    want = torch.autograd.grad(sum((y * gy).sum() + e for y, e in outs),
                               [p for _, p in named] + [xr],
                               allow_unused=True)

    params = dict(module.named_parameters())
    with sharding.activation_sharding(mesh, cfg, "train"):
        split = sp and sharding.seq_split(x.shape[1], cfg)
        assert split == sp, f"{name}: seq_split {split}"
        xl = chunk(x[rows[i]], sp).clone().requires_grad_()
        y, extra = _out(fn(module, xl, tok[rows[i]], tgt[rows[i]], cfg, sp))
        g = gy if y.dim() == 0 else chunk(gy, sp)
        got = torch.autograd.grad((y * g).sum() + extra,
                                  [params[n] for n, _ in named] + [xl],
                                  allow_unused=True)
        y_want = outs[i][0] if y.dim() == 0 else chunk(outs[i][0], sp)
        dx_want = chunk(want[-1][rows[i]], sp)
    errs = {"y": rel(y.detach(), y_want.detach()),
            "extra": rel(torch.as_tensor(extra).detach(),
                         torch.as_tensor(outs[i][1]).detach()),
            "dx": rel(got[-1], dx_want)}
    for (n, _), gr, w in zip(named, got[:-1], want[:-1]):
        if (gr is None) != (w is None):
            errs[n] = float("inf")
        elif gr is not None:
            errs[n] = rel(sharding.whole(gr), w)
    return errs


# ---------------------------------------------------------------------------
# what the layers received
# ---------------------------------------------------------------------------


class Seen:
    """Records, while entered, each layer's residual shape and each flash
    call's (Sq, q_offset), by pass-throughs in the functions' places in
    their modules (where the callers look them up at each call)."""

    def __enter__(self):
        self.layers, self.flash = [], []
        self._fa, self._layer = fa.flash_attention_bhsd, blocks.layer_fwd
        inner_fa, inner_layer = self._fa, self._layer

        def flash(q, k, v, **kw):
            self.flash.append((q.shape[2], kw.get("q_offset", 0)))
            return inner_fa(q, k, v, **kw)

        def layer(kind, p, x, ctx, cfg):
            self.layers.append(tuple(x.shape))
            return inner_layer(kind, p, x, ctx, cfg)
        fa.flash_attention_bhsd, blocks.layer_fwd = flash, layer
        return self

    def __exit__(self, *exc):
        fa.flash_attention_bhsd, blocks.layer_fwd = self._fa, self._layer


def seen_step(arch, mesh, n):
    """The layers' residual shapes and flash's calls in one ``lm_loss``
    forward and backward of ``arch`` at ``n`` positions on ``mesh``."""
    cfg = config(arch)
    module = trainable(lm.init_lm(cfg, seed=0, device="cpu"))
    sharding.shard_module(module, mesh, cfg)
    g = torch.Generator().manual_seed(5)
    i, n_dp = sharding.dp_index(mesh)
    batch = {k: torch.randint(0, cfg.vocab_size, (B // n_dp, n), generator=g)
             for k in ("inputs", "targets")}
    with sharding.activation_sharding(mesh, cfg, "train"), Seen() as seen:
        lm.lm_loss(module, batch, cfg)[0].backward()
        rank = sharding.tp().rank
    return {"layers": seen.layers, "flash": seen.flash, "rank": rank}


# ---------------------------------------------------------------------------
# whole train steps and prefills
# ---------------------------------------------------------------------------


def run_norms(cfg, steps, ckpt_dir, mesh=None):
    """``launch/train.py``'s run, with each step's ``grad_norm``."""
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
        params, _, losses = tr.train(
            cfg, opt(), steps=steps, batch=B, seq=S, mesh=mesh,
            ckpt_dir=str(ckpt_dir), log_every=100, device="cpu")
    return params, losses, norms


def mesh_train(arch, mesh, ckpt_dir):
    params, losses, norms = run_norms(train_config(arch), STEPS, ckpt_dir,
                                      mesh)
    return {"losses": losses, "grad_norms": norms,
            "whole": {n: sharding.whole(p)
                      for n, p in params.named_parameters()}}


def prefill_error(arch, mesh):
    """One rank's prefill logits of its rows (gathered over the vocab)
    against unsharded ``lm.prefill``'s, relative; and flash's calls."""
    cfg = config(arch)
    module = lm.init_lm(cfg, seed=0, device="cpu")
    want_m = copy.deepcopy(module)
    sharding.shard_module(module, mesh, cfg, "train")
    g = torch.Generator().manual_seed(11)
    n = SEQ.get(arch, S)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (B, n), generator=g)}
    i, n_dp = sharding.dp_index(mesh)
    rows = slice(i * B // n_dp, (i + 1) * B // n_dp)
    with torch.no_grad():
        want = lm.prefill(want_m, batch, cfg, n + 4)[0][rows]
        with sharding.activation_sharding(mesh, cfg, "train"), \
                Seen() as seen:
            got = lm.prefill(module, sharding.local_rows(batch, mesh), cfg,
                             n + 4)[0]
            if vocab_lo(module, cfg) is not None:
                got = sharding.gather_from_model(got)
    return {"err": rel(got, want), "flash": seen.flash}


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
                if tag == "1x4" or name not in ONLY_1X4:
                    res[(tag, name)] = block_errors(name, mesh)
            for arch in TRAINS:
                res[(tag, "train", arch)] = mesh_train(
                    arch, mesh, out / f"{tag}-{arch}")
            for arch in ("smollm-360m", "recurrentgemma-2b"):
                res[(tag, "prefill", arch)] = prefill_error(arch, mesh)
            for arch in ("smollm-360m", "llama3-8b"):
                for n in (S,) + UNFIT[tag]:
                    res[(tag, "seen", arch, n)] = seen_step(arch, mesh, n)
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
    out = tmp_path_factory.mktemp("sp")
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
    losses, grad norms)."""
    out, _ = ranks
    return {arch: run_norms(train_config(arch), STEPS, out / f"none-{arch}")
            for arch in TRAINS}


MESH_TAGS = ["x".join(map(str, m)) for m in MESHES]
BLOCK_CASES = [(b, m) for m in MESH_TAGS for b in BLOCKS
               if m == "1x4" or b not in ONLY_1X4]


@pytest.mark.parametrize("block,mesh", BLOCK_CASES)
def test_block_matches_unsharded(block, mesh, ranks):
    for r, res in enumerate(ranks[1]):
        errs = res[(mesh, block)]
        worst = max(errs, key=errs.get)
        assert errs[worst] <= BLOCK_RTOL, \
            f"rank {r}: {worst} off by {errs[worst]:.2e} ({errs})"


def test_blocks_split_as_the_rules_say():
    """The cases above reach each path: SP with the heads split and KV
    replicated, SP with CP (heads dividing neither mesh), CP alone, the
    ff and vocab splits; the reduced configs keep the full ones' SP."""
    llama, glm, smol, rg = (config(a) for a in (
        "llama3-8b", "chatglm3-6b", "smollm-360m", "recurrentgemma-2b"))
    assert llama.sequence_parallel and glm.sequence_parallel \
        and smol.sequence_parallel and not rg.sequence_parallel
    assert glm.n_kv_heads % 4 and not llama.n_heads % 4
    assert smol.n_heads % 4 and smol.n_heads % 2
    assert rg.n_heads % 4 and rg.attn_window < SEQ["recurrentgemma-2b"]
    assert 3 % 4 and 3 % 2          # whisper's heads here
    assert not llama.d_ff % 4 and not llama.padded_vocab % 4


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("arch", TRAINS)
def test_train_matches_unsharded(arch, mesh, ranks, unsharded):
    """The launcher's losses, the first step's gradient norm and the
    weights after the steps on the mesh against ``--mesh none``'s."""
    module, losses, norms = unsharded[arch]
    want = {n: p.detach() for n, p in module.named_parameters()}
    for r, res in enumerate(ranks[1]):
        got = res[(mesh, "train", arch)]
        worst = max(abs(a - b) / abs(b) for a, b in zip(got["losses"],
                                                        losses))
        assert len(got["losses"]) == STEPS and worst <= LOSS_RTOL, \
            f"rank {r}: losses {got['losses']} vs {losses}"
        first = abs(got["grad_norms"][0] - norms[0]) / norms[0]
        assert first <= LOSS_RTOL, \
            f"rank {r}: grad norms {got['grad_norms']} vs {norms}"
    whole = ranks[1][0][(mesh, "train", arch)]["whole"]
    worst = max(rel(whole[n], w) for n, w in want.items())
    assert worst <= SPLIT_WEIGHT_RTOL.get(arch, WEIGHT_RTOL), \
        f"weights off by {worst:.2e}"


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("arch", ("smollm-360m", "recurrentgemma-2b"))
def test_cp_prefill_matches_unsharded(arch, mesh, ranks):
    """A prefill under the train rules: context parallelism where the heads
    do not divide ``model`` (each rank's flash call a chunk at its
    offset), never SP; the logits as unsharded."""
    heads = config(arch).n_heads
    m = int(mesh.split("x")[1])
    n = SEQ.get(arch, S)
    for r, res in enumerate(ranks[1]):
        got = res[(mesh, "prefill", arch)]
        assert got["err"] <= BLOCK_RTOL, f"rank {r}: {got['err']:.2e}"
        if heads % m:
            rank = r % m
            assert set(got["flash"]) == {(n // m, rank * n // m)}, got
        else:
            assert set(got["flash"]) == {(n, 0)}, got


@pytest.mark.parametrize("mesh", MESH_TAGS)
def test_sp_and_cp_ran(mesh, ranks):
    """In a train step at 16 positions: llama3-8b's residual is each
    rank's (rows, 16 / model, d) chunk inside every layer and flash gets
    the whole sequence on the rank's heads; smollm-360m's is the chunk too
    and flash gets the rank's 16 / model queries at its offset (SP and
    CP)."""
    m = int(mesh.split("x")[1])
    dp = RANKS // m
    for res in ranks[1]:
        for arch in ("llama3-8b", "smollm-360m"):
            got = res[(mesh, "seen", arch, S)]
            d = config(arch).d_model
            assert set(got["layers"]) == {(B // dp, S // m, d)}, got
            want = ({(S // m, got["rank"] * S // m)}
                    if arch == "smollm-360m" else {(S, 0)})
            assert got["flash"] and set(got["flash"]) == want, got


@pytest.mark.parametrize("mesh,n", [(m, n) for m, ns in UNFIT.items()
                                    for n in ns])
def test_unfit_sequence_computes_whole(n, mesh, ranks):
    """A sequence that ``_fit`` does not split over ``model`` (not a
    multiple of it, or shorter) computes whole on every rank: no SP, no
    CP, as the reference's ``_fit`` leaves such an axis replicated."""
    from repro.distributed import sharding as ref_shd

    class Stub:
        axis_names = ("data", "model")
        devices = np.empty(tuple(map(int, mesh.split("x"))), dtype=object)
    m = Stub.devices.shape[1]
    assert ref_shd._fit(n, ("model",), Stub()) is None
    assert sharding._fit(n, ("model",), Stub()) is None
    assert ref_shd._fit(S, ("model",), Stub()) == ("model",)
    for res in ranks[1]:
        for arch in ("llama3-8b", "smollm-360m"):
            got = res[(mesh, "seen", arch, n)]
            d = config(arch).d_model
            assert set(got["layers"]) == {(B // (RANKS // m), n, d)}, got
            assert set(got["flash"]) == {(n, 0)}, got


def test_seq_split_needs_a_train_step_on_a_mesh():
    """Off a mesh, or on a mesh stub (no process group), nothing splits:
    the rules alone leave every step as it was."""
    cfg = config("llama3-8b")
    assert not sharding.seq_split(S, cfg)
    assert not sharding.context_parallel(15, S)

    class Stub:
        axis_names = ("data", "model")
        devices = np.empty((1, 4), dtype=object)
    with sharding.activation_sharding(Stub(), cfg, "train"):
        assert sharding.use_context_parallel(15)
        assert not sharding.seq_split(S, cfg)
        assert not sharding.context_parallel(15, S)
