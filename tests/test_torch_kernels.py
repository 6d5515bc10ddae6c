"""The port's kernels on the CPU (their plain versions) against the JAX
reference's Pallas kernels in interpret mode, its wrappers and a numpy
oracle. The kernels themselves run on the card: tests/test_torch_cuda.py.

Tolerances: paged decode 1e-5 (fp32, ``test_paged_decode.py``'s own);
flash 2e-5 in fp32 and 2e-2 in bf16 (``test_kernels.py``'s own)."""

import ast
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels import flash_attention as ref_fa  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import paged_attention as ref_pa  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import rwkv6  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def _rand_paged(rng, B, KV, G, hd, page, maxp, P):
    q = rng.normal(size=(B, KV, G, hd)).astype(np.float32)
    kp = rng.normal(size=(P, KV, page, hd)).astype(np.float32)
    vp = rng.normal(size=(P, KV, page, hd)).astype(np.float32)
    bt = rng.integers(0, P, size=(B, maxp)).astype(np.int32)
    lens = rng.integers(0, maxp * page + 1, size=B).astype(np.int32)
    lens[0] = 0                                   # inactive slot
    return q, kp, vp, bt, lens


def _dense_oracle(q, kp, vp, bt, lens):
    """Per-row gather + plain softmax in numpy/f64."""
    B, KV, G, hd = q.shape
    out = np.zeros_like(q)
    for b in range(B):
        L = int(lens[b])
        if L == 0:
            continue
        k = np.concatenate([kp[p] for p in bt[b]], axis=1)[:, :L]
        v = np.concatenate([vp[p] for p in bt[b]], axis=1)[:, :L]
        s = np.einsum("kgh,klh->kgl", q[b].astype(np.float64),
                      k.astype(np.float64)) / np.sqrt(hd)
        p_ = np.exp(s - s.max(-1, keepdims=True))
        p_ /= p_.sum(-1, keepdims=True)
        out[b] = np.einsum("kgl,klh->kgh", p_, v.astype(np.float64))
    return out


@pytest.mark.parametrize("B,KV,G,hd,page,maxp", [
    (4, 2, 2, 16, 4, 3), (3, 1, 4, 32, 8, 2), (6, 2, 1, 16, 8, 4),
])
def test_paged_plain_matches_pallas_kernel(B, KV, G, hd, page, maxp):
    rng = np.random.default_rng(3)
    args = _rand_paged(rng, B, KV, G, hd, page, maxp, P=maxp * B)
    lens = args[-1]
    want = np.asarray(ref_pa.paged_decode_bkgh(
        *map(jnp.asarray, args), page_size=page, interpret=True))
    got = pa.paged_decode_bkgh(*map(torch.from_numpy, args),
                               page_size=page).numpy()
    assert_allclose(got, want, atol=1e-5, rtol=1e-5)
    assert_allclose(got, _dense_oracle(*args), atol=1e-5, rtol=1e-5)
    assert np.all(got[lens == 0] == 0.0)          # inactive rows exactly zero


def test_paged_dispatcher_layout():
    """ops.paged_decode_attention groups heads as h = kv*G + g, like the
    reference wrapper (model layout (B,1,H,hd))."""
    rng = np.random.default_rng(4)
    B, KV, G, hd, page, maxp = 3, 2, 2, 16, 4, 3
    q = rng.normal(size=(B, 1, KV * G, hd)).astype(np.float32)
    _, kp, vp, bt, lens = _rand_paged(rng, B, KV, G, hd, page, maxp, P=9)
    want = np.asarray(ref_ops.paged_decode_attention(
        *map(jnp.asarray, (q, kp, vp, bt, lens)), page_size=page,
        interpret=True))
    got = ops.paged_decode_attention(
        *map(torch.from_numpy, (q, kp, vp, bt, lens)), page_size=page)
    assert got.shape == (B, 1, KV * G, hd)
    assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _qkv(rng, B, H, KV, S, hd, dtype):
    def mk(*s):
        return rng.normal(size=s).astype(np.float32)
    q, k, v = mk(B, S, H, hd), mk(B, S, KV, hd), mk(B, S, KV, hd)
    # round to the working dtype once, so both sides see the same inputs
    return [np.asarray(jnp.asarray(a, dtype)) for a in (q, k, v)]


@pytest.mark.parametrize("B,H,KV,S,hd", [(1, 2, 2, 64, 16),
                                         (2, 4, 2, 80, 32)])
@pytest.mark.parametrize("causal,window,softcap", [
    (True, 0, 0.0), (True, 24, 0.0), (False, 0, 0.0), (True, 0, 20.0)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_kernel(B, H, KV, S, hd, causal, window,
                                           softcap, dtype):
    """Model layout through both dispatchers: the reference runs its Pallas
    kernel in interpret mode, the port its plain version (GQA in the second
    shape). Both are also held to the reference's jnp oracle."""
    rng = np.random.default_rng(5)
    q, k, v = _qkv(rng, B, H, KV, S, hd, dtype)
    kw = dict(causal=causal, window=window, softcap=softcap)
    want = np.asarray(ref_ops.flash_attention(
        *map(jnp.asarray, (q, k, v)), block_q=32, block_k=32,
        interpret=True, **kw), np.float32)
    got = ops.flash_attention(
        *(torch.from_numpy(np.array(a, np.float32)).to(TORCH_DT[dtype])
          for a in (q, k, v)), **kw)
    assert got.dtype == TORCH_DT[dtype]
    assert_allclose(got.float().numpy(), want, **tol(dtype))
    oracle = np.asarray(ref_oracles.attention_ref(
        *(jnp.asarray(a).transpose(0, 2, 1, 3) for a in (q, k, v)),
        **kw).transpose(0, 2, 1, 3), np.float32)
    assert_allclose(got.float().numpy(), oracle, **tol(dtype))


def test_flash_bhsd_masks_pre_pad_lengths():
    """Kernel layout with block-padded inputs and pre-pad seq_q/seq_k, as
    the reference wrapper calls its kernel: real rows agree and padded q
    rows are exactly zero in the port."""
    rng = np.random.default_rng(6)
    B, H, KV, S, Sp, hd = 2, 4, 2, 37, 64, 16
    q = np.zeros((B, H, Sp, hd), np.float32)
    k = np.zeros((B, KV, Sp, hd), np.float32)
    v = np.zeros((B, KV, Sp, hd), np.float32)
    q[:, :, :S] = rng.normal(size=(B, H, S, hd))
    k[:, :, :S] = rng.normal(size=(B, KV, S, hd))
    v[:, :, :S] = rng.normal(size=(B, KV, S, hd))
    want = np.asarray(ref_fa.flash_attention_bhsd(
        *map(jnp.asarray, (q, k, v)), block_q=32, block_k=32, seq_q=S,
        seq_k=S, interpret=True))
    got = fa.flash_attention_bhsd(*map(torch.from_numpy, (q, k, v)),
                                  seq_q=S, seq_k=S).numpy()
    assert_allclose(got[:, :, :S], want[:, :, :S], atol=2e-5, rtol=2e-5)
    assert np.all(got[:, :, S:] == 0.0)


class Elsewhere(torch.Tensor):
    """A tensor without data on a device the kernels do not serve (any
    device type but the CPU, CUDA and meta): every op on it raises."""

    @staticmethod
    def __new__(cls, *shape):
        return torch.Tensor._make_wrapper_subclass(
            cls, shape, dtype=torch.float32, device=torch.device("xpu"))

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        raise RuntimeError(f"{func} reached a tensor without data")


def test_kernels_refuse_other_devices():
    """A device other than the CPU (the plain versions), CUDA (the kernels)
    and meta (the dry run's shapes, ``distributed.cost``) raises."""
    q = Elsewhere(1, 1, 1, 16)
    with pytest.raises(ValueError):
        fa.flash_attention_bhsd(q, q, q)
    with pytest.raises(ValueError):
        pa.paged_decode_bkgh(q, q, q, q, q, page_size=1)
    with pytest.raises(ValueError):
        rwkv6.wkv6_bhtk(q, q, q, q, Elsewhere(1, 16), q)
    m = torch.zeros(1, 1, 1, 16, device="meta")
    assert fa.flash_attention_bhsd(m, m, m).is_meta
    y, s = rwkv6.wkv6_bhtk(m, m, m, m, m[0, 0], torch.zeros(
        1, 1, 16, 16, device="meta"))
    assert y.shape == m.shape and s.shape == (1, 1, 16, 16) and s.is_meta


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [*(ROOT / "src" / "repro_torch").rglob("*.py"), ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_reference(path):
    roots = {name.split(".")[0] for name in _imports(path)}
    assert not roots & {"jax", "jaxlib", "repro", "msgpack"}, (path, roots)
