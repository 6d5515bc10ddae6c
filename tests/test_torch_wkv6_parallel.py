"""The wkv6 prefill kernel's order of operations on the CPU
(``wkv6_serial_ref``: the bonus hoisted out of the state sum, each column's
rows summed in row groups combined pairwise, chunks of 16 tokens staged)
against the port's plain version, the reference's token-serial oracle and
its Pallas kernel in interpret mode. The kernel itself runs on the card:
tests/test_torch_cuda.py.

Inputs come from numpy seeds. Tolerances are the reference tests' own: y
2e-5 (fp32) / 2e-2 (bf16), the state atol 1e-4 / rtol 1e-3
(``test_kernels.py``)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro_torch.kernels import rwkv6  # noqa: E402

TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
STATE_TOL = dict(atol=1e-4, rtol=1e-3)


def tol(dtype):
    return dict(atol=2e-2, rtol=2e-2) if dtype == "bfloat16" \
        else dict(atol=2e-5, rtol=2e-5)


def np32(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def wkv_inputs(seed, B, H, T, K, dtype, s0=True, logw_ends=False):
    """r/k/v rounded to ``dtype`` once; logw -exp(N(0,1)) in fp32, or
    alternating -e^5 and -1e-6 (the two ends ``rwkv_streams`` clips to);
    u 0.3 + 0.1 N(0,1); s0 0.1 N(0,1) or zero (a fresh prefill's)."""
    rng = np.random.default_rng(seed)
    rkv = [np32(jnp.asarray(0.5 * rng.normal(size=(B, H, T, K)), dtype))
           for _ in range(3)]
    logw = -np.exp(rng.normal(size=(B, H, T, K))).astype(np.float32)
    if logw_ends:
        logw[..., ::2] = -np.exp(5.0)
        logw[..., 1::2] = -1e-6
    u = (0.3 + 0.1 * rng.normal(size=(H, K))).astype(np.float32)
    s = 0.1 * rng.normal(size=(B, H, K, K)) if s0 else np.zeros((B, H, K, K))
    return (*rkv, logw, u, s.astype(np.float32))


def torch_args(args, dtype):
    r, k, v, logw, u, s0 = (torch.from_numpy(a.copy()) for a in args)
    return [x.to(TORCH_DT[dtype]) for x in (r, k, v)] + [logw, u, s0]


def check(y, s, y_ref, s_ref, dtype):
    assert_allclose(y.float().numpy(), np32(y_ref), **tol(dtype))
    assert_allclose(s.numpy(), np32(s_ref), **STATE_TOL)


@pytest.mark.parametrize("s0", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("T", [1, 2, 31, 32, 33, 70])
def test_serial_ref_matches_plain_and_oracle(T, K, dtype, s0):
    """Any T: one token, less than a chunk, chunk multiples and ragged
    tails; rwkv6-7b's head dim and the reduced one; from a fresh (zero) and
    a carried state. Against the port's chunked plain version and the
    reference's token-serial oracle."""
    args = wkv_inputs(T * K + s0, 2, 3, T, K, dtype, s0=s0)
    targs = torch_args(args, dtype)
    y, s = rwkv6.wkv6_serial_ref(*targs)
    assert y.dtype == TORCH_DT[dtype] and s.dtype == torch.float32
    assert y.shape == (2, 3, T, K) and s.shape == (2, 3, K, K)
    check(y, s, *rwkv6.wkv6_ref(*targs), dtype)
    jdt = jnp.dtype(dtype)
    jargs = [jnp.asarray(a, jdt) for a in args[:3]] + \
        [jnp.asarray(a) for a in args[3:]]
    check(y, s, *ref_oracles.wkv6_ref(*jargs), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K,T", [(16, 33), (64, 32), (64, 70)])
def test_serial_ref_matches_pallas_kernel(K, T, dtype):
    """Against the reference's Pallas kernel in interpret mode (its chunk
    shrinks to a divisor of T: 11 at T=33, 14 at T=70)."""
    args = wkv_inputs(T + K, 2, 2, T, K, dtype)
    jdt = jnp.dtype(dtype)
    jargs = [jnp.asarray(a, jdt) for a in args[:3]] + \
        [jnp.asarray(a) for a in args[3:]]
    y, s = rwkv6.wkv6_serial_ref(*torch_args(args, dtype))
    check(y, s, *ref_ops.wkv6(*jargs, chunk=32, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [16, 64])
def test_serial_ref_logw_at_both_ends_of_its_range(K, dtype):
    """logw at -e^5 (a decay that wipes the state in one token) and at
    -1e-6 (no decay): the token-serial order loses nothing at either end,
    where differences of prefix sums would."""
    args = wkv_inputs(K, 2, 2, 40, K, dtype, logw_ends=True)
    jdt = jnp.dtype(dtype)
    jargs = [jnp.asarray(a, jdt) for a in args[:3]] + \
        [jnp.asarray(a) for a in args[3:]]
    y, s = rwkv6.wkv6_serial_ref(*torch_args(args, dtype))
    check(y, s, *ref_oracles.wkv6_ref(*jargs), dtype)
    check(y, s, *rwkv6.wkv6_ref(*torch_args(args, dtype)), dtype)


@pytest.mark.parametrize("groups", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("chunk", [1, 16, 50])
def test_serial_ref_does_not_depend_on_groups_or_chunk(groups, chunk):
    """The row groups and the chunk are orders of operations, not part of
    the function: every split gives the oracle's answer in fp32."""
    args = wkv_inputs(groups * chunk, 2, 2, 45, 64, "float32")
    y, s = rwkv6.wkv6_serial_ref(*torch_args(args, "float32"), chunk=chunk,
                                 groups=groups)
    check(y, s, *ref_oracles.wkv6_ref(*map(jnp.asarray, args)), "float32")


def test_serial_ref_groups_follow_the_kernel():
    """The default split is the kernel's: 8 row groups (8 rows a lane) at
    K = 64, 4 at K = 16, chunks of 16 tokens."""
    assert rwkv6.ROW_GROUPS == {16: 4, 64: 8} and rwkv6.CHUNK == 16
    assert set(rwkv6.ROW_GROUPS) == set(rwkv6.HEAD_DIMS)
