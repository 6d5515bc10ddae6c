"""WKV6's gradient kernel's algorithm on the CPU (``wkv6_bwd_chunk_ref``:
the states at the chunk boundaries carried forward and back, each chunk's
gradients from its boundary states, the in-chunk pair terms walked on
every channel, decays as steps x - d x one token at a time, dlogw the
direct product expanded over the chunk's terms) at the kernel's chunk of
``BWD_CHUNK`` tokens, against autograd through the port's plain version,
the CPU backward, ``jax.vjp`` of the reference's XLA scan
(``wkv6_chunked``, off the logw floor) and of its token-serial oracle (at
the floor, where the chunked scan drifts: ROADMAP Queue 3). The kernel
itself runs on the card: tests/test_torch_cuda.py.

Inputs come from numpy seeds (``test_torch_wkv6_bwd``'s cases).
Tolerances are relative to each gradient's max: 2e-5 in fp32 and 2e-2 in
bf16."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as ref_oracles  # noqa: E402
from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.kernels import rwkv6  # noqa: E402
from test_torch_wkv6_bwd import (autograd_grads, close_rel,  # noqa: E402
                                 ref_vjp, torch_case, wkv_case)

@pytest.fixture(autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("K,T", [(16, 1), (16, 45), (16, 64), (64, 1),
                                 (64, 16), (64, 45), (64, 70)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunk_ref_matches_autograd_and_the_plain_backward(K, T, dtype):
    """One token, one chunk exactly, T short of, past and not a multiple of
    a chunk, at both head dims: against autograd through ``wkv6_ref`` and
    the CPU backward that ``WKV6`` keeps."""
    args, dy, dS = torch_case(wkv_case(K * 7 + T, 2, 3, T, K), dtype)
    got = rwkv6.wkv6_bwd_chunk_ref(*args, dy, dS)
    close_rel(got, autograd_grads(rwkv6.wkv6_ref, args, dy, dS), dtype,
              "autograd")
    close_rel(got, rwkv6.wkv6_bwd_bhtk(*args, dy, dS), dtype, "plain")


@pytest.mark.parametrize("K,T", [(16, 64), (16, 45), (64, 45), (64, 33)])
def test_chunk_ref_matches_reference_chunked_vjp(K, T):
    """Against ``jax.vjp`` of the reference's ``wkv6_chunked``, logw away
    from the floor."""
    case = wkv_case(K + 3 * T, 2, 3, T, K)
    args, dy, dS = torch_case(case)
    got = rwkv6.wkv6_bwd_chunk_ref(*args, dy, dS)
    close_rel(got, ref_vjp(ref_ssm.wkv6_chunked, case))


@pytest.mark.parametrize("K,T", [(16, 45), (64, 45), (64, 1)])
@pytest.mark.parametrize("absent", ["dy", "dS"])
def test_chunk_ref_with_an_upstream_gradient_absent(K, T, absent):
    """dy absent (only s_T used) or dS absent (a train step drops s_T)."""
    args, dy, dS = torch_case(wkv_case(K * T + 1, 2, 2, T, K),
                              absent=absent)
    got = rwkv6.wkv6_bwd_chunk_ref(*args, dy, dS)
    close_rel(got, autograd_grads(rwkv6.wkv6_ref, args, dy, dS))
    close_rel(got, rwkv6.wkv6_bwd_serial_ref(*args, dy, dS))
    if absent == "dy":
        assert not got[0].any() and not got[4].any()     # dr, du


@pytest.mark.parametrize("K,T", [(16, 40), (64, 45), (64, 100)])
def test_chunk_ref_at_the_logw_ends_matches_the_serial_oracle(K, T):
    """logw at -e^5 and -1e-6 on alternating channels: against ``jax.vjp``
    of the reference's token-serial oracle and autograd through
    ``wkv6_ref``; the whole-chunk decay is carried as its deficit, so the
    -1e-6 channels lose nothing to 1 - d rounded near 1."""
    case = wkv_case(K + T + 5, 2, 2, T, K, floor=True)
    args, dy, dS = torch_case(case)
    got = rwkv6.wkv6_bwd_chunk_ref(*args, dy, dS)
    close_rel(got, ref_vjp(ref_oracles.wkv6_ref, case))
    close_rel(got, autograd_grads(rwkv6.wkv6_ref, args, dy, dS))


@pytest.mark.parametrize("logw", [-float(np.exp(5.0)), -1e30,
                                  -float("inf")])
@pytest.mark.parametrize("K", [16, 64])
def test_chunk_ref_zero_decays_give_finite_gradients(logw, K):
    """w = 0 on every channel: d = 1 exactly, every factor across a token
    is 0 and every gradient finite; ds0 sees dy_0 through r_0 only."""
    (r, k, v, _, u, s0), (dy, dS) = wkv_case(K + 2, 2, 2, 37, K)
    args, dy, dS = torch_case(((r, k, v, np.full_like(r, logw), u, s0),
                               (dy, dS)))
    got = rwkv6.wkv6_bwd_chunk_ref(*args, dy, dS)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert torch.equal(got[5], args[0][:, :, 0, :, None] * dy[:, :, 0, None])
    if logw == -float(np.exp(5.0)):
        close_rel(got, autograd_grads(rwkv6.wkv6_ref, args, dy, dS))


@pytest.mark.parametrize("logw", [-20.0, -30.0])
def test_chunk_ref_small_decays_keep_their_gradient(logw):
    """w of 2e-9 and 9e-14 (1 - d rounds such a w to 0): dlogw = w times
    its sum is that small and real, and kept: w = exp(logw) multiplies the
    expanded sum, every gradient within 2e-5 of its max of autograd."""
    K = 64
    (r, k, v, _, u, s0), (dy, dS) = wkv_case(K + 4, 2, 2, 37, K)
    args, dy, dS = torch_case(((r, k, v, np.full_like(r, logw), u, s0),
                               (dy, dS)))
    got = rwkv6.wkv6_bwd_chunk_ref(*args, dy, dS)
    assert float(got[3].abs().max()) > 0
    close_rel(got, autograd_grads(rwkv6.wkv6_ref, args, dy, dS))
