"""WKV6's token-serial gradient oracle on the CPU (``wkv6_bwd_serial_ref``:
every state kept, a reverse walk, decay steps S - d S with d =
-expm1(logw), dlogw's factor w = exp(logw)) against autograd through the
port's plain version, the CPU backward (``WKV6`` on CPU tensors,
``wkv6_ref``'s chunks recomputed under autograd) and ``jax.vjp`` of the
reference's XLA scan (``wkv6_chunked``, off the logw floor) and token-serial
oracle (``repro.kernels.ref.wkv6_ref``, at the floor). Then the gradient
kernel's chunk plan and its algorithm's bits against the grid, zero
decays, the meta device's shapes and the cost formula. The kernel's own
algorithm (``wkv6_bwd_chunk_ref``) is held in test_torch_wkv6_bwd_chunk.py;
the kernel itself runs on the card: tests/test_torch_cuda.py.

Inputs come from numpy seeds. Tolerances are relative to each gradient's
max: 2e-5 in fp32 and 2e-2 in bf16 (``tests/test_kernels.py``'s, as
``tests/test_torch_ssm_train.py`` holds ``WKV6``)."""

import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.distributed import cost  # noqa: E402
from repro_torch.kernels import rwkv6  # noqa: E402

REL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
NAMES = ("r", "k", "v", "logw", "u", "s0")


@pytest.fixture(autouse=True)
def _two_threads():
    """Two intra-op threads a test: the tensors are small, and parallel
    test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def wkv_case(seed, B, H, T, K, floor=False):
    """r/k/v 0.5 N(0,1); logw -exp(N(0,1)) in fp32, or alternating -e^5
    and -1e-6 (the floor and the top ``rwkv_streams`` clips to); a random
    bonus u, a nonzero s0; the upstream gradients dy and dS. numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)      # noqa: E731
    r, k, v = (0.5 * f(B, H, T, K) for _ in range(3))
    logw = -np.exp(f(B, H, T, K))
    if floor:
        logw[..., ::2] = -np.exp(5.0)
        logw[..., 1::2] = -1e-6
    return ((r, k, v, logw, 0.3 + 0.1 * f(H, K), 0.1 * f(B, H, K, K)),
            (f(B, H, T, K), f(B, H, K, K)))


def torch_case(case, dtype="float32", absent=None):
    """The case as tensors, r/k/v and dy in ``dtype``; dy or dS None where
    ``absent`` names it."""
    (r, k, v, logw, u, s0), (dy, dS) = case
    dt = TORCH_DT[dtype]
    args = [torch.from_numpy(x.copy()).to(dt) for x in (r, k, v)] + \
        [torch.from_numpy(x.copy()) for x in (logw, u, s0)]
    dy = None if absent == "dy" else torch.from_numpy(dy.copy()).to(dt)
    dS = None if absent == "dS" else torch.from_numpy(dS.copy())
    return args, dy, dS


def autograd_grads(fn, args, dy, dS):
    """Autograd's six gradients through ``fn`` at (dy, dS) (None: that
    output unused); zeros where an input does not reach the outputs."""
    xs = [x.detach().clone().requires_grad_() for x in args]
    y, s = fn(*xs)
    outs, ups = zip(*[(o, d) for o, d in ((y, dy), (s, dS))
                      if d is not None])
    got = torch.autograd.grad(outs, xs, ups, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for x, g in zip(xs, got)]


def close_rel(got, want, dtype="float32", what=""):
    """Each of the six within REL[dtype] of its max, in ``want``'s dtype."""
    for name, a, b in zip(NAMES, got, want):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype, (what, name)
            b = b.float().numpy()
        a = a.float().numpy()
        scale = max(float(np.abs(b).max()), 1e-12)
        err = float(np.abs(a - np.asarray(b, np.float32)).max())
        assert err <= REL[dtype] * scale, (what, name, err, scale)


CASES = [(16, 1), (16, 33), (16, 45), (16, 64), (64, 1), (64, 33),
         (64, 45), (64, 64), (64, 16)]


@pytest.mark.parametrize("K,T", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_serial_ref_matches_autograd_and_the_plain_backward(K, T, dtype):
    """T of one token, of one 16-token chunk exactly, short of, past and a
    multiple of it, at both head dims: against autograd through
    ``wkv6_ref`` and against the CPU backward, which ``WKV6`` keeps."""
    args, dy, dS = torch_case(wkv_case(K * 100 + T, 2, 3, T, K), dtype)
    got = rwkv6.wkv6_bwd_serial_ref(*args, dy, dS)
    close_rel(got, autograd_grads(rwkv6.wkv6_ref, args, dy, dS), dtype,
              "autograd")
    close_rel(got, rwkv6.wkv6_bwd_bhtk(*args, dy, dS), dtype, "plain")


@pytest.mark.parametrize("K,T", [(16, 45), (64, 33), (64, 1)])
@pytest.mark.parametrize("absent", ["dy", "dS"])
def test_serial_ref_with_an_upstream_gradient_absent(K, T, absent):
    """dy absent (only s_T used) or dS absent (a train step drops s_T):
    the gradients of the other output alone."""
    args, dy, dS = torch_case(wkv_case(K + T, 2, 2, T, K), absent=absent)
    got = rwkv6.wkv6_bwd_serial_ref(*args, dy, dS)
    close_rel(got, autograd_grads(rwkv6.wkv6_ref, args, dy, dS))
    close_rel(got, rwkv6.wkv6_bwd_bhtk(*args, dy, dS))
    if absent == "dy":
        assert not got[0].any() and not got[4].any()     # dr, du


def ref_vjp(fn, case):
    (args, (dy, dS)) = case
    _, vjp = jax.vjp(fn, *map(jnp.asarray, args))
    return [np.asarray(g, np.float32)
            for g in vjp((jnp.asarray(dy), jnp.asarray(dS)))]


@pytest.mark.parametrize("K,T", [(16, 64), (16, 45), (64, 33)])
def test_serial_ref_matches_reference_chunked_vjp(K, T):
    """Against ``jax.vjp`` of the reference's ``wkv6_chunked`` (its training
    path), logw away from the floor."""
    case = wkv_case(K * T, 2, 3, T, K)
    args, dy, dS = torch_case(case)
    got = rwkv6.wkv6_bwd_serial_ref(*args, dy, dS)
    close_rel(got, ref_vjp(ref_ssm.wkv6_chunked, case))


@pytest.mark.parametrize("K,T", [(16, 40), (64, 40), (64, 100)])
def test_serial_ref_at_the_logw_floor_matches_the_serial_oracle(K, T):
    """logw at -e^5 and -1e-6: against ``jax.vjp`` of the reference's
    token-serial oracle. The reference's chunked scan drifts there
    (ROADMAP Queue 3) and is left out."""
    case = wkv_case(K + T, 2, 2, T, K, floor=True)
    args, dy, dS = torch_case(case)
    got = rwkv6.wkv6_bwd_serial_ref(*args, dy, dS)
    close_rel(got, ref_vjp(ref_oracles.wkv6_ref, case))
    close_rel(got, autograd_grads(rwkv6.wkv6_ref, args, dy, dS))


@pytest.mark.parametrize("K,T", [(64, 33), (64, 70), (16, 45)])
def test_row_groups_give_bitwise_the_same_gradients(K, T):
    """The gradient kernel's grid is set by the shapes alone and its sums
    run in a fixed order, so no (b, h) sees another: its algorithm
    (``wkv6_bwd_chunk_ref``) on each (b, h) alone gives bitwise the
    batch's dr, dk, dv, dlogw and ds0 (and, at B = 1, du)."""
    for B, H in ((2, 2), (1, 3)):
        args, dy, dS = torch_case(wkv_case(T + B, B, H, T, K))
        whole = rwkv6.wkv6_bwd_chunk_ref(*args, dy, dS)
        r, k, v, logw, u, s0 = args
        for b in range(B):
            for h in range(H):
                one = rwkv6.wkv6_bwd_chunk_ref(
                    *(x[b:b + 1, h:h + 1] for x in (r, k, v, logw)),
                    u[h:h + 1], s0[b:b + 1, h:h + 1], dy[b:b + 1, h:h + 1],
                    dS[b:b + 1, h:h + 1])
                for i in (0, 1, 2, 3, 5):
                    assert torch.equal(one[i][0, 0], whole[i][b, h])
                if B == 1:
                    assert torch.equal(one[4][0], whole[4][h])


def test_bwd_groups_fill_the_card():
    """The gradient kernel's chunk plan: chunks of ``BWD_CHUNK`` tokens,
    the last one padded; its chunk pass takes a block a (b, h, chunk),
    which fills the 132 SMs three blocks deep at rwkv6-7b's 8 x 64 heads,
    a tensor-parallel rank's 4 x 16 and the mesh run's 4 x 64 over 512
    tokens."""
    C = rwkv6.BWD_CHUNK
    assert C == 16
    assert [rwkv6.bwd_chunks(T) for T in (1, C, C + 1, 45, 512)] == \
        [1, 1, 2, 3, -(-512 // C)]
    for BH in (8 * 64, 4 * 16, 4 * 64):
        assert BH * rwkv6.bwd_chunks(512) >= 3 * 132


def test_kernel_chunk_is_the_wrappers():
    """The kernel is built for one chunk size, ``CHUNK`` in
    ``csrc/wkv6_bwd.cu``, and the wrapper sizes the boundary states'
    scratch by ``BWD_CHUNK``: the two must agree."""
    src = (Path(rwkv6.__file__).parent / "csrc" / "wkv6_bwd.cu").read_text()
    sizes = re.findall(r"constexpr int CHUNK = (\d+);", src)
    assert sizes == [str(rwkv6.BWD_CHUNK)]


@pytest.mark.parametrize("logw", [-float(np.exp(5.0)), -1e30,
                                  -float("inf")])
@pytest.mark.parametrize("K", [16, 64])
def test_zero_decays_give_finite_gradients(logw, K):
    """w = 0 in fp32 on every channel (the floor, far past it, and -inf):
    d = -expm1(logw) is exactly 1, no decay is ever divided by, and every
    gradient is finite; the state forgets all but the last token."""
    (r, k, v, _, u, s0), (dy, dS) = wkv_case(K, 2, 2, 37, K)
    args, dy, dS = torch_case(((r, k, v, np.full_like(r, logw), u, s0),
                               (dy, dS)))
    got = rwkv6.wkv6_bwd_serial_ref(*args, dy, dS)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    # with w = 0, s_T = k_{T-1} v_{T-1}^T: ds0 sees dy_0 through r_0 only
    assert torch.equal(got[5], args[0][:, :, 0, :, None] * dy[:, :, 0, None])
    if logw == -float(np.exp(5.0)):
        close_rel(got, autograd_grads(rwkv6.wkv6_ref, args, dy, dS))


@pytest.mark.parametrize("logw", [-20.0, -30.0])
def test_small_decays_keep_their_gradient(logw):
    """w = exp(logw) of 2e-9 and 9e-14: dlogw = w rowsum(G S_{t-1}) is that
    small and real (1 - d rounds such a w to 0), and the decay steps lose
    nothing that shows: every gradient, dlogw's too, within 2e-5 of its
    max of autograd through ``wkv6_ref``."""
    K = 64
    (r, k, v, _, u, s0), (dy, dS) = wkv_case(K, 2, 2, 37, K)
    args, dy, dS = torch_case(((r, k, v, np.full_like(r, logw), u, s0),
                               (dy, dS)))
    got = rwkv6.wkv6_bwd_serial_ref(*args, dy, dS)
    assert float(got[3].abs().max()) > 0
    close_rel(got, autograd_grads(rwkv6.wkv6_ref, args, dy, dS))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_meta_backward_shapes_and_cost(dtype):
    """On the meta device ``WKV6``'s backward returns empty gradients of
    the inputs' shapes and dtypes and reports ``cost.wkv6_bwd_work`` under
    the ``wkvscan`` tag; so does the CPU backward."""
    B, H, T, K = 2, 3, 37, 16
    args, dy, dS = torch_case(wkv_case(1, B, H, T, K), dtype)
    elem = args[0].element_size()
    flops, nbytes = cost.wkv6_bwd_work(B, H, T, K, elem)
    n = B * H * T * K
    assert flops == 2 * 6 * n * K
    assert nbytes == 7 * n * elem + 2 * 4 * n + 2 * 4 * H * K \
        + 3 * 4 * B * H * K * K
    for dev in ("meta", "cpu"):
        xs = [x.to(dev).requires_grad_() for x in args]
        y, s = rwkv6.wkv6_grad(*xs)
        with cost.counting() as c:
            got = torch.autograd.grad((y, s), xs, (dy.to(dev), dS.to(dev)))
        for a, x in zip(got, xs):
            assert a.shape == x.shape and a.dtype == x.dtype
            assert a.is_meta == (dev == "meta")
        tagged = c.select("wkvscan")
        assert (tagged.flops, tagged.bytes) == (flops, nbytes)
