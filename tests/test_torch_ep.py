"""Expert parallelism over ``model`` (``distributed.sharding``'s
``moe_split``, ``all_to_all_model``, ``grad_once``, ``sum_over_data`` and
the MoE's capacity form that calls them) against the same code unsharded,
and the unsharded MoE against the JAX reference, on the CPU.

Four gloo ranks, spawned once with a free localhost port, form a (1, 4)
and then a (2, 2) ("data", "model") mesh. Reduced llama4-maverick-400b-a17b
(``moe_parallelism="ep"``: 8 experts, top-1, a shared expert) and reduced
qwen3-moe-30b-a3b (``"fsdp"``: 8 experts, top-2) compute in fp32 with the
full config's ``fsdp`` and ``moe_parallelism``. On each mesh every rank:

- runs the first MoE layer's FFN (the reference's seeded weights through
  ``bridge``) on its dp rows of one seeded input, with and without
  sequence parallelism (``sp``: on the rank's chunk of the sequence): the
  output, the input's gradient and every parameter's gradient (gathered
  whole) within ``BLOCK_RTOL`` of the unsharded block's, the aux values
  too (they enter the loss as ``lm_loss`` adds them); llama4's products
  over the rank's ``E / model`` experts, qwen3's over its ``G / model``
  groups with every expert, no parameter gathered over ``model``
  (``sharding.gathers["over_model"]``) and, on (1, 4), no all-gather at
  all (``cost.counting``); qwen3 at 2 rows, whose 2 groups do not divide
  dp x ``model`` = 4, computes as before (all its groups, every expert);
- trains each arch ``STEPS`` steps with ``launch/train.py`` (sequence
  parallel, as the full configs set it) against ``--mesh none``: losses
  and the first step's gradient norm within ``LOSS_RTOL``, the weights
  within ``WEIGHT_RTOL`` (llama4's within ``SPLIT_WEIGHT_RTOL``), no
  parameter gathered over ``model``;
- builds each arch by ``lm.init_lm`` on the mesh, drawing only its rows
  of the experts where the rules split them, bitwise the shards of the
  whole draw;
- prefills its rows under the train rules and decodes ``DECODE`` steps on
  the serve rules' shards (llama4's experts over ``model`` and their
  ``f`` over ``data``, qwen3's over ``model``), fed the unsharded run's
  greedy tokens: the logits (gathered over the vocab) within
  ``LOGIT_RTOL`` of their max, the same greedy tokens, no parameter
  gathered over ``model``, each decode product over the rank's experts.

Beside the spawn: the unsharded block against the reference's
``moe_fwd`` on the same weights; the reference's serve-time dispatch spec
of qwen3 names ``model`` twice where its groups divide dp x ``model``
(its fault, which the port resolves); decode cells of both archs on a
fake (2, 2) group gather no weight.

The spawn joins with a time limit of its own, so a hung rank fails the
tests instead of the run.
"""

import copy
import dataclasses
import multiprocessing
import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import ShapeConfig  # noqa: E402
from repro_torch.configs.registry import get_config, get_reduced  # noqa: E402
from repro_torch.distributed import cost, sharding  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import train as tr  # noqa: E402
from repro_torch.launch.mesh import make_sim_mesh  # noqa: E402
from repro_torch.models import common, lm, moe  # noqa: E402
from repro_torch.models.common import trainable, vocab_lo  # noqa: E402
from repro_torch.optim import OptConfig  # noqa: E402

RANKS, MESHES = 4, ((1, 4), (2, 2))
LLAMA4, QWEN3 = "llama4-maverick-400b-a17b", "qwen3-moe-30b-a3b"
B, S, STEPS, DECODE = 4, 16, 2, 3
BLOCK_RTOL, LOSS_RTOL, WEIGHT_RTOL, LOGIT_RTOL = 1e-5, 1e-5, 1e-4, 1e-5
# test_torch_tp.py's SPLIT_WEIGHT_RTOL: AdamW's normalized step carries the
# split sums' rounding into llama4's expert weights, ten times the most
# that splitting its shared expert's down-projection sum in 2 or 4 blocks
# moves the unsharded run's in 2 steps (tools/tp_rounding.py --parts 2 /
# 4: 6.633e-5 / 6.613e-5 of layers.1.moe.wo's max, on the CPU); the parent
# tree's experts, gathered whole, move 1.19e-4 on (2, 2) too
SPLIT_WEIGHT_RTOL = {LLAMA4: 6.7e-4}
# test_torch_moe.py's hold of the port's MoE FFN against the reference's
REF_ATOL = REF_RTOL = 2e-5
JOIN_S = 300
ARCHS = (LLAMA4, QWEN3)
# the first MoE layer: the reference's stacked block key, the port's layer
MOE_LAYER = {QWEN3: ("0_moe", 0), LLAMA4: ("1_moe", 1)}
# the blocks: (arch, sp, rows); qwen3's 2 rows do not divide dp x model
BLOCKS = [(a, sp, B) for a in ARCHS for sp in (False, True)] \
    + [(QWEN3, False, 2)]


def config(arch, sp=False, **kw):
    full = get_config(arch)
    return get_reduced(arch).replace(
        compute_dtype="float32", fsdp=full.fsdp,
        moe_parallelism=full.moe_parallelism, sequence_parallel=sp, **kw)


def train_config(arch):
    return config(arch, get_config(arch).sequence_parallel, remat="full",
                  ce_chunks=2)


def opt():
    return OptConfig(lr=1e-3, warmup_steps=0, total_steps=10)


def rel(a, b):
    """max |a - b| / max |b| (1 where b is all zeros)."""
    scale = float(b.abs().max()) or 1.0
    return float((a - b).abs().max()) / scale


def block_tag(arch, sp, rows):
    return f"{arch}-{'sp' if sp else 'nosp'}-{rows}"


class Products:
    """Records, while entered, each expert product's dispatch shape (G, n,
    C, d) and the shape of the ``wi`` it multiplies, by a pass-through in
    ``moe._experts``'s place (where ``moe._routed`` looks it up)."""

    def __enter__(self):
        self.seen, self._inner = set(), moe._experts
        inner, inner_w = self._inner, moe._expert_w

        def experts(p, h, cfg, eq_in, eq_out, use="whole"):
            used = []

            def expert_w(w, x, cfg, use):
                out = inner_w(w, x, cfg, use)
                if w is p.wi:
                    used.append(tuple(out.shape))
                return out
            moe._expert_w = expert_w
            try:
                return inner(p, h, cfg, eq_in, eq_out, use)
            finally:
                moe._expert_w = inner_w
                self.seen.add((tuple(h.shape), used[0]))
        moe._experts = experts
        return self

    def __exit__(self, *exc):
        moe._experts = self._inner


def over_model(fn):
    """(fn's result, the uses that gathered a parameter over ``model``
    while it ran)."""
    before = sharding.gathers["over_model"]
    out = fn()
    return out, sharding.gathers["over_model"] - before


# ---------------------------------------------------------------------------
# the MoE block
# ---------------------------------------------------------------------------


def block_errors(arch, sp, rows, mesh, state):
    """{what: relative error} of the first MoE layer's FFN of ``arch`` on
    ``mesh`` (weights ``state``, the reference's through ``bridge``) against
    the unsharded FFN's, every rank taking part; and what the rank's
    products, gathers and collectives were."""
    cfg = config(arch, sp)
    module = trainable(lm.LM(cfg))
    module.load_state_dict(state)
    ref = copy.deepcopy(module)
    sharding.shard_module(module, mesh, cfg)
    layer = MOE_LAYER[arch][1]
    g = torch.Generator().manual_seed(7)
    x = torch.randn(rows, S, cfg.d_model, generator=g)
    i, n_dp = sharding.dp_index(mesh)
    mine = [slice(d * rows // n_dp, (d + 1) * rows // n_dp)
            for d in range(n_dp)]
    gy = torch.randn(x[mine[0]].shape, generator=g)

    def run(m, xin, split):
        y, aux = moe.moe_fwd(m.layers[layer].moe, xin, cfg, sp=split)
        return y, aux, aux["moe_lb_loss"] + aux["moe_z_loss"]

    named = list(ref.named_parameters())
    xr = x.clone().requires_grad_()
    outs = [run(ref, xr[r], False) for r in mine]
    want = torch.autograd.grad(sum((y * gy).sum() + e for y, _, e in outs),
                               [p for _, p in named] + [xr],
                               allow_unused=True)

    def chunk(t):
        return t[:, sharding.rank_slice(t.shape[1])] if sp else t

    params = dict(module.named_parameters())
    with sharding.activation_sharding(mesh, cfg, "train"), \
            Products() as products, cost.counting() as counter:
        assert sharding.seq_split(S, cfg) == sp
        split = sharding.moe_split(cfg, x[mine[i]].shape[0],
                                   cfg.moe_experts, cfg.moe_d_ff)
        xl = chunk(x[mine[i]]).clone().requires_grad_()
        (y, aux, extra), n_over = over_model(lambda: run(module, xl, sp))
        got, n_back = over_model(lambda: torch.autograd.grad(
            (y * chunk(gy)).sum() + extra,
            [params[n] for n, _ in named] + [xl], allow_unused=True))
        y_want, dx_want = chunk(outs[i][0]), chunk(want[-1][mine[i]])
    aux_want = outs[i][1]
    errs = {"y": rel(y.detach(), y_want.detach()),
            "dx": rel(got[-1], dx_want)}
    for k in moe.AUX_KEYS:
        errs[k] = rel(aux[k].detach(), aux_want[k].detach())
    for (n, _), gr, w in zip(named, got[:-1], want[:-1]):
        if (gr is None) != (w is None):
            errs[n] = float("inf")
        elif gr is not None:
            errs[n] = rel(sharding.whole(gr), w)
    return {"errs": errs, "products": products.seen, "split": split,
            "over_model": n_over + n_back,
            "coll": dict(counter.total.coll)}


# ---------------------------------------------------------------------------
# training and serving
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
    (params, losses, norms), n_over = over_model(
        lambda: run_norms(train_config(arch), STEPS, ckpt_dir, mesh))
    return {"losses": losses, "grad_norms": norms, "over_model": n_over,
            "whole": {n: sharding.whole(p)
                      for n, p in params.named_parameters()}}


def serve_errors(arch, mesh):
    """One rank's prefill of its rows under the train rules and ``DECODE``
    decode steps on the serve rules' shards against the unsharded run:
    {"errs": relative errors (prefill, steps), "same": same greedy tokens
    each, "over_model", "products": the decode steps' (dispatch, wi)
    shapes, "prefill_products"}."""
    cfg = config(arch)
    module = lm.init_lm(cfg, seed=0, device="cpu")
    train_m, serve_m = copy.deepcopy(module), copy.deepcopy(module)
    sharding.shard_module(train_m, mesh, cfg, "train")
    sharding.shard_module(serve_m, mesh, cfg, "serve")
    g = torch.Generator().manual_seed(11)
    batch = {"inputs": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    i, n_dp = sharding.dp_index(mesh)
    rows = slice(i * B // n_dp, (i + 1) * B // n_dp)
    out = {"errs": [], "same": [], "over_model": 0}

    def hold(logits, params, want):
        if vocab_lo(params, cfg) is not None:
            logits = sharding.gather_from_model(logits)
        out["errs"].append(rel(logits, want[rows]))
        out["same"].append(bool(torch.equal(logits.argmax(-1),
                                            want[rows].argmax(-1))))

    with torch.no_grad():
        logits, caches, t = lm.prefill(module, batch, cfg, S + DECODE)
        want, toks = [logits], [logits.argmax(-1)[:, None]]
        for s in range(DECODE):
            logits, caches = lm.decode_step(module, caches, toks[-1], t + s,
                                            cfg)
            want.append(logits)
            toks.append(logits.argmax(-1)[:, None])
        with sharding.activation_sharding(mesh, cfg, "train"), \
                Products() as pre:
            (got, shards, _), n = over_model(lambda: lm.prefill(
                train_m, sharding.local_rows(batch, mesh), cfg, S + DECODE))
            hold(got, train_m, want[0])
        out["over_model"] += n
        out["prefill_products"] = pre.seen
        with sharding.activation_sharding(mesh, cfg, "serve"), \
                Products() as dec:
            out["split"] = sharding.moe_split(cfg, B // n_dp,
                                              cfg.moe_experts, cfg.moe_d_ff)
            for s in range(DECODE):
                (got, shards), n = over_model(lambda: lm.decode_step(
                    serve_m, shards, toks[s][rows], t + s, cfg))
                out["over_model"] += n
                hold(got, serve_m, want[s + 1])
        out["products"] = dec.seen
    return out


def init_matches(arch, mesh, mode):
    """Whether ``lm.init_lm`` on ``mesh`` gives every parameter bitwise the
    shard that the whole draw stored by ``mode``'s rules gives, its
    experts drawn as the rank's rows only (bf16 experts, as the full
    configs store them, drawn 3 experts a slice); and those rows."""
    cfg = config(arch).replace(param_dtype="bfloat16")
    whole = lm.init_lm(cfg, seed=5, device="cpu")
    sharding.shard_module(whole, mesh, cfg, mode)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(common, "DRAW_SLICE", 3 * cfg.d_model * cfg.moe_d_ff)
        mine = lm.init_lm(cfg, seed=5, device="cpu", mesh=mesh, mode=mode)
    want = dict(whole.named_parameters())
    same = all(
        p.placements == want[n].placements and p.shape == want[n].shape
        and torch.equal(p.to_local(), want[n].to_local())
        for n, p in mine.named_parameters())
    return {"same": same,
            "rows": sharding.expert_rows(mesh, cfg, mode),
            "drawn": tuple(mine.layers[MOE_LAYER[arch][1]].moe.wi
                           .to_local().shape)}


def _worker(rank, port, out, states):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=RANKS)
    try:
        res = {}
        for shape in MESHES:
            mesh = make_sim_mesh(RANKS, shape, ("data", "model"))
            tag = "x".join(map(str, shape))
            for arch, sp, rows in BLOCKS:
                res[(tag, block_tag(arch, sp, rows))] = block_errors(
                    arch, sp, rows, mesh, states[arch])
            for arch in ARCHS:
                for mode in ("train", "serve"):
                    res[(tag, "init", arch, mode)] = init_matches(
                        arch, mesh, mode)
                res[(tag, "train", arch)] = mesh_train(
                    arch, mesh, out / f"{tag}-{arch}")
                res[(tag, "serve", arch)] = serve_errors(arch, mesh)
        torch.save(res, out / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the reference's weights and its MoE FFN (JAX, imported only here)
# ---------------------------------------------------------------------------

_REF = {}


def ref_params(arch):
    """The reference's seeded reduced weights, numpy leaves."""
    if arch not in _REF:
        import jax

        from repro.configs.registry import get_reduced as ref_get_reduced
        from repro.models import lm as ref_lm
        init = jax.jit(ref_lm.init_lm, static_argnums=(1,))
        _REF[arch] = jax.tree.map(np.asarray, init(
            jax.random.PRNGKey(0), ref_get_reduced(arch)))
    return _REF[arch]


def ref_moe_out(arch, x):
    """The reference's ``moe_fwd`` of the first MoE layer on ``x`` (numpy),
    fp32: (y, aux) as numpy."""
    import jax
    import jax.numpy as jnp

    from repro.configs.registry import get_reduced as ref_get_reduced
    from repro.models import moe as ref_moe
    rcfg = dataclasses.replace(ref_get_reduced(arch),
                               compute_dtype="float32")
    key, _ = MOE_LAYER[arch]
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      ref_params(arch)["segments"][0][key]["moe"])
    y, aux = ref_moe.moe_fwd(rp, jnp.asarray(x), rcfg)
    return np.asarray(y), {k: float(v) for k, v in aux.items()}


@pytest.fixture(scope="module")
def states():
    """Each arch's port weights from the reference's seeded ``init_lm``
    (``bridge``), as a state dict."""
    return {arch: bridge.lm_from_ref(ref_params(arch),
                                     config(arch)).state_dict()
            for arch in ARCHS}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, states):
    """Every rank's results, from one spawn of ``RANKS`` gloo ranks."""
    out = tmp_path_factory.mktemp("ep")
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_worker, args=(r, port, out, states))
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
    return out, [torch.load(out / f"rank{r}.pt", weights_only=False)
                 for r in range(RANKS)]


@pytest.fixture(scope="module")
def unsharded(ranks):
    """``--mesh none`` on each arch: (module after STEPS, losses, grad
    norms)."""
    out, _ = ranks
    return {arch: run_norms(train_config(arch), STEPS, out / f"none-{arch}")
            for arch in ARCHS}


MESH_TAGS = ["x".join(map(str, m)) for m in MESHES]


def model_size(mesh):
    return int(mesh.split("x")[1])


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_unsharded_block_matches_reference(arch, states):
    """The port's MoE FFN, unsharded, on the reference's weights (through
    ``bridge``) against the reference's ``moe_fwd``: the weights every
    mesh case below starts from."""
    cfg = config(arch)
    module = lm.LM(cfg)
    module.load_state_dict(states[arch])
    x = np.random.default_rng(3).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    want, want_aux = ref_moe_out(arch, x)
    with torch.no_grad():
        y, aux = moe.moe_fwd(module.layers[MOE_LAYER[arch][1]].moe,
                             torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y.numpy(), want, atol=REF_ATOL, rtol=REF_RTOL)
    for k in moe.AUX_KEYS:
        np.testing.assert_allclose(float(aux[k]), want_aux[k], rtol=1e-5,
                                   atol=1e-7)


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("arch,sp,rows", BLOCKS)
def test_block_matches_unsharded(arch, sp, rows, mesh, ranks):
    """Output, aux values, the input's gradient and every parameter's
    gradient within ``BLOCK_RTOL`` of the unsharded block's; no parameter
    gathered over ``model``, and on (1, 4) (one ``data`` rank) no
    all-gather at all."""
    for r, res in enumerate(ranks[1]):
        got = res[(mesh, block_tag(arch, sp, rows))]
        errs = got["errs"]
        worst = max(errs, key=errs.get)
        assert errs[worst] <= BLOCK_RTOL, \
            f"rank {r}: {worst} off by {errs[worst]:.2e} ({errs})"
        assert got["over_model"] == 0, got["over_model"]
        if mesh == "1x4":
            assert not got["coll"].get("all-gather"), got["coll"]


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("sp", [False, True])
def test_llama4_block_computes_its_experts(sp, mesh, ranks):
    """llama4 (``"ep"``): each rank's expert products are over its
    ``E / model`` experts of every group of its rows, on its shard of the
    weights; the combine's sum is an all-reduce (no all-to-all)."""
    cfg = config(LLAMA4)
    m = model_size(mesh)
    n, rows = cfg.moe_experts // m, B // (RANKS // m)
    C = moe.capacity(S, cfg)
    for res in ranks[1]:
        got = res[(mesh, block_tag(LLAMA4, sp, B))]
        assert got["split"] == sharding.MoeSplit(experts=True)
        assert got["products"] == {((rows, n, C, cfg.d_model),
                                     (n, cfg.d_model, cfg.moe_d_ff))}, got
        assert got["coll"].get("all-reduce") and \
            not got["coll"].get("all-to-all"), got["coll"]


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("sp", [False, True])
def test_qwen3_block_computes_its_groups(sp, mesh, ranks):
    """qwen3 (``"fsdp"``): its 4 groups divide dp x ``model`` = 4 on both
    meshes, so each rank routes and computes one group with every expert;
    under sequence parallelism an all-to-all hands it its rows."""
    cfg = config(QWEN3)
    C = moe.capacity(S, cfg)
    for res in ranks[1]:
        got = res[(mesh, block_tag(QWEN3, sp, B))]
        assert got["split"] == sharding.MoeSplit(groups=True)
        E = cfg.moe_experts
        assert got["products"] == {((1, E, C, cfg.d_model),
                                     (E, cfg.d_model, cfg.moe_d_ff))}, got
        assert bool(got["coll"].get("all-to-all")) == sp, got["coll"]


@pytest.mark.parametrize("mesh", MESH_TAGS)
def test_unfit_group_count_computes_as_before(mesh, ranks):
    """qwen3 at 2 rows: 2 groups do not divide dp x ``model`` = 4, so they
    fall back to the dp axes and every ``model`` rank computes all of its
    rows' groups with every expert, as before this split existed."""
    cfg = config(QWEN3)
    rows = 2 // (RANKS // model_size(mesh))
    C = moe.capacity(S, cfg)
    E = cfg.moe_experts
    for res in ranks[1]:
        got = res[(mesh, block_tag(QWEN3, False, 2))]
        assert got["split"] == sharding.MoeSplit()
        assert got["products"] == {((rows, E, C, cfg.d_model),
                                     (E, cfg.d_model, cfg.moe_d_ff))}, got


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_train_matches_unsharded(arch, mesh, ranks, unsharded):
    """The launcher's losses, the first step's gradient norm and the
    weights after the steps on the mesh against ``--mesh none``'s; no
    parameter gathered over ``model`` in any step."""
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
        assert got["over_model"] == 0, got["over_model"]
    whole = ranks[1][0][(mesh, "train", arch)]["whole"]
    errs = {n: rel(whole[n], w) for n, w in want.items()}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= SPLIT_WEIGHT_RTOL.get(arch, WEIGHT_RTOL), \
        f"weights off by {errs[worst]:.2e} ({worst})"


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_matches_unsharded(arch, mesh, ranks):
    """A prefill under the train rules and decode steps on the serve rules'
    shards: logits within ``LOGIT_RTOL`` of the unsharded run's, the same
    greedy tokens, no parameter gathered over ``model``; each decode
    product over the rank's ``E / model`` experts (llama4's ``f / data``
    of them, its dispatch rows gathered over ``data``), the experts staying
    on ``model`` for qwen3 too, whose 4 groups divide dp x ``model``."""
    cfg = config(arch)
    m = model_size(mesh)
    dp = RANKS // m
    n, d, f = cfg.moe_experts // m, cfg.d_model, cfg.moe_d_ff
    C = moe.capacity(1, cfg)
    ep = arch == LLAMA4
    want = {((B if ep else B // dp, n, C, d),
             (n, d, f // dp if ep else f))}
    for r, res in enumerate(ranks[1]):
        got = res[(mesh, "serve", arch)]
        worst = max(got["errs"])
        assert worst <= LOGIT_RTOL and all(got["same"]), \
            f"rank {r}: {got['errs']} {got['same']}"
        assert got["over_model"] == 0, got["over_model"]
        assert got["split"] == sharding.MoeSplit(experts=True,
                                                 f_data=ep and dp > 1)
        assert got["products"] == want, got["products"]
        assert got["prefill_products"], got


@pytest.mark.parametrize("mesh", MESH_TAGS)
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_init_on_a_mesh_draws_the_rank_s_experts(arch, mode, mesh, ranks):
    """``lm.init_lm`` with a mesh: every parameter bitwise the shard of the
    whole draw as ``mode``'s rules store it, each rank drawing only its
    rows of the experts where the rules split them over ``model`` (llama4
    always; qwen3 at serve time), all of them elsewhere."""
    cfg = config(arch)
    m = model_size(mesh)
    split = arch == LLAMA4 or mode == "serve"
    n = cfg.moe_experts // m if split else cfg.moe_experts
    for r, res in enumerate(ranks[1]):
        got = res[(mesh, "init", arch, mode)]
        assert got["same"], f"rank {r}"
        lo = (r % m) * n
        assert got["rows"] == (slice(lo, lo + n) if split else None), got
        assert got["drawn"][0] == n, got


def test_reference_serve_dispatch_names_model_twice():
    """The reference's fault: at serve time qwen3's dispatch is constrained
    to ``("expert_group_all", "experts", None, None)``, which names
    ``model`` twice wherever the groups divide dp x ``model`` (JAX's
    ``DuplicateSpecError``); at ``decode_32k`` on (16, 16) its 128 groups
    do not divide 256 and fall back to ``data``, where it runs. Checked by
    ``resolve_logical`` on mesh stubs (no JAX devices); the port resolves
    the first case with the groups on the dp axes and the experts on
    ``model``, as the second (``test_serve_matches_unsharded`` serves it at
    4 groups on (1, 4))."""
    from jax.sharding import PartitionSpec as P

    from repro.configs.registry import get_config as ref_get_config
    from repro.distributed import sharding as ref_shd

    def stub(shape):
        class Stub:
            axis_names = ("data", "model")
            devices = np.empty(shape, dtype=object)
        return Stub()
    cfg = ref_get_config(QWEN3)
    assert cfg.moe_parallelism == "fsdp"
    logical = ("expert_group_all", "experts", None, None)
    E, C, d = cfg.moe_experts, 8, cfg.d_model
    for G in (4, 8):
        spec = ref_shd.resolve_logical(logical, (G, E, C, d), stub((1, 4)),
                                       cfg)
        assert spec == P(("data", "model"), ("model",), None, None)
    spec = ref_shd.resolve_logical(logical, (128, E, C, d), stub((16, 16)),
                                   cfg)
    assert spec == P(("data",), ("model",), None, None)
    port = sharding.resolve_logical(logical, (4, E, C, d), stub((1, 4)),
                                    cfg)
    assert port == (("data", "model"), ("model",), None, None)


@pytest.mark.parametrize("arch", ARCHS)
def test_dryrun_decode_cell_gathers_no_weight(arch):
    """A reduced decode cell on a fake (2, 2) group by the serve rules:
    the experts stay where they are stored (no all-gather at all), and
    every expert product is the rank's ``E / 2`` experts."""
    sc = ShapeConfig("decode_small", "decode", 32, 8)
    with Products() as products:
        rec = dryrun.run_cell(arch, sc, (2, 2), reduced=True)
    assert not dist.is_initialized()
    coll = rec["roofline"]["collectives"]
    assert coll.get("all-reduce") and "all-gather" not in coll, coll
    E = get_reduced(arch).moe_experts
    assert {h[1] for h, _ in products.seen} == {E // 2}, products.seen
