"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the reference's (``repro.distributed.sharding``), on the reference's mesh
stubs (an object with axis names and a device array's shape), so no
process group and no device is needed.

``param_spec_tree`` of every arch (the ten ``ARCH_IDS``, progen-s and
foldscore-s) at full width, in train and serve modes, on (1, 1), (16, 16)
and (2, 16, 16) stubs, leaf for leaf against the reference's
``param_spec_tree`` of its ``init_*`` tree (``jax.eval_shape``: nothing
allocated; the port's module on ``meta``); ``cache_spec_tree`` likewise;
then ``tokens_sharding``, ``_fit`` and ``use_context_parallel`` as
``tests/test_sharding_and_cost.py`` checks the reference's, and
``placements``.

Specs compare with a one-axis tuple and its bare name taken as equal: JAX's
``PartitionSpec`` now normalises ``("model",)`` to ``'model'`` (why the
reference's ``test_cache_spec_kv_fallback_to_head_dim`` fails; its rule is
not at fault). The port's head-dim fallback is asserted directly.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs.registry import get_config as ref_get_config  # noqa: E402
from repro.distributed import sharding as ref_shd  # noqa: E402
from repro.models import lm as ref_lm  # noqa: E402
from repro.models import protein as ref_protein  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.distributed import sharding as shd  # noqa: E402
from repro_torch.models import attention, lm  # noqa: E402
from repro_torch.models.protein import FoldScore, ProGen  # noqa: E402

ARCHS = ARCH_IDS + ("progen-s", "foldscore-s")
MESHES = {"1x1": ((1, 1), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
CACHE_B, CACHE_L = 32, 64


def stub(name):
    shape, axes = MESHES[name]

    class Mesh:
        axis_names = axes
        devices = np.empty(shape, dtype=object)
    return Mesh()


def norm(spec, ndim):
    """A spec (the port's tuple or a PartitionSpec) as a tuple of ``ndim``
    entries, each None or a tuple of axis names."""
    out = [None if e is None else (e,) if isinstance(e, str) else tuple(e)
           for e in spec]
    return tuple(out) + (None,) * (ndim - len(out))


@functools.lru_cache(maxsize=None)
def trees(arch):
    """(the reference's param shape tree, the port's module on meta)."""
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    key = jax.random.PRNGKey(0)
    init, cls = {"progen-s": (ref_protein.init_progen, ProGen),
                 "foldscore-s": (ref_protein.init_foldscore, FoldScore)}.get(
        arch, (ref_lm.init_lm, lm.LM))
    shapes = jax.eval_shape(lambda: init(key, ref_cfg))
    with torch.device("meta"):
        module = cls(cfg)
    return shapes, module


def ref_leaves(tree):
    """{path string: leaf} of a reference pytree, as its ``_path_str``."""
    return {ref_shd._path_str(p): leaf
            for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", ["train", "serve"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_tree_matches_reference(arch, mode, mesh):
    shapes, module = trees(arch)
    m = stub(mesh)
    cfg = get_config(arch)
    ref_specs = ref_leaves(ref_shd.param_spec_tree(
        shapes, m, ref_get_config(arch), mode))
    ref_shapes = ref_leaves(shapes)
    paths = shd.param_paths(module)
    got = shd.param_spec_tree(module, m, cfg, mode)
    assert got.keys() == paths.keys() == dict(module.named_parameters()
                                              ).keys()
    assert {p for p, _, _ in paths.values()} == ref_specs.keys()
    for name, p in module.named_parameters():
        path, shape, stacked = paths[name]
        assert shape == tuple(ref_shapes[path].shape), name
        assert shape[stacked:] == tuple(p.shape), name
        want = norm(ref_specs[path], len(shape))
        if stacked:
            assert want[0] is None, name
            want = want[1:]
        assert norm(got[name], p.dim()) == want, (name, path)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_spec_tree_matches_reference(arch, mesh):
    ref_cfg, cfg = ref_get_config(arch), get_config(arch)
    m = stub(mesh)
    ref_caches = jax.eval_shape(
        lambda: ref_lm.init_caches(ref_cfg, CACHE_B, CACHE_L))
    ref_specs = ref_leaves(ref_shd.cache_spec_tree(ref_caches, m, ref_cfg))
    caches = lm.init_caches(cfg, CACHE_B, CACHE_L, device="meta")
    where = [(s, i, kind) for s, (kinds, reps) in enumerate(cfg.segments)
             for _ in range(reps) for i, kind in enumerate(kinds)]
    got = shd.cache_spec_tree(caches, m, cfg)
    if "dec_attn" in cfg.layer_kinds:
        # a fresh dec_attn cache is the self cache; a prefill's adds cross
        prefilled = [{"self": c, "cross": attention.init_cache(
            cfg, CACHE_B, cfg.frontend_seq, device="meta")} for c in caches]
        got += shd.cache_spec_tree(prefilled, m, cfg)
        caches, where = caches + prefilled, where + where
    assert len(got) == len(caches) == len(where)
    for (s, i, kind), cache, specs in zip(where, caches, got):
        for path, leaf in shd._leaves(cache):
            ref = f"{s}/{i}_{kind}/" + ("self/" if kind == "dec_attn" and
                                       "self" not in cache else "") + path
            want = norm(ref_specs[ref], leaf.dim() + 1)
            assert want[0] is None
            spec = specs
            for part in path.split("/"):
                spec = spec[part]
            assert norm(spec, leaf.dim()) == want[1:], (s, i, kind, path)


def test_cache_spec_kv_fallback_to_head_dim():
    """kv=8 vs a 16-wide model axis: head_dim shards instead; kv=16 shards
    the heads."""
    cfg = get_config("llama3-8b")
    m = stub("16x16")
    spec = shd.cache_spec("segments/0/0_attn/k", (32, 128, 32768, 8, 128),
                          m, cfg)
    assert spec[-2] is None and spec[-1] == ("model",)
    spec2 = shd.cache_spec("segments/0/0_attn/k", (32, 128, 32768, 16, 128),
                           m, cfg)
    assert spec2[-2] == ("model",)
    assert spec2[1] == ("data",)


def test_param_rules_divisibility_fallback():
    m = stub("1x1")  # model axis size 1 divides everything
    cfg = get_config("llama3-8b")
    spec = shd.param_spec("segments/0/0_attn/wq", (32, 4096, 32, 128), m, cfg)
    assert spec == (None, ("data",), ("model",), None)
    assert shd._fit(15, ("model",), m) == ("model",)  # size-1 axis fits
    assert shd._fit(15, None, m) is None
    # smollm's 15 heads stay replicated on a 16-wide model axis
    assert shd._fit(15, ("model",), stub("16x16")) is None


@pytest.mark.parametrize("rows,want", [(1, ()), (128, (("data",),))])
def test_tokens_sharding_divisibility(rows, want):
    m = stub("16x16")
    assert shd._fit(rows, ("data",), m) == (want[0] if want else None)
    assert shd.tokens_sharding(m, (rows, 128)) == want
    # the reference agrees
    assert ref_shd._fit(rows, ("data",), m) == shd._fit(rows, ("data",), m)
    # on a 1-wide mesh everything divides
    assert shd.tokens_sharding(stub("1x1"), (1, 128)) == (("data",),)
    assert shd.tokens_sharding(stub("2x16x16"), (64, 8)) == \
        (("pod", "data"),)


@pytest.mark.parametrize("heads", [12, 15, 16, 32, 56])
def test_use_context_parallel(heads):
    assert not shd.use_context_parallel(heads)  # no mesh installed
    for name in MESHES:
        m = stub(name)
        cfg = get_config("llama3-8b")
        with shd.activation_sharding(m, cfg), \
                ref_shd.activation_sharding(m, ref_get_config("llama3-8b")):
            assert shd.use_context_parallel(heads) == \
                ref_shd.use_context_parallel(heads)
            assert shd.active_mode() == "train"


def test_constrain_is_noop():
    x = torch.ones(4, 4)
    assert shd.constrain(x, ("batch", None)) is x
    with shd.activation_sharding(stub("16x16"), get_config("llama3-8b")):
        assert shd.constrain(x, ("batch", None)) is x


def test_placements_major_to_minor():
    """A dim over ("pod", "data") shards on both mesh dims, in the mesh's
    order; a spec shorter than the tensor replicates the rest."""
    from torch.distributed.tensor import Replicate, Shard
    m = stub("2x16x16")
    assert shd.placements((("pod", "data"), None, ("model",)), m) == \
        [Shard(0), Shard(0), Shard(2)]
    assert shd.placements((), m) == [Replicate()] * 3
    assert shd.placements((None, ("data",)), stub("16x16")) == \
        [Shard(1), Replicate()]
