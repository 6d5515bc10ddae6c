"""RG-LRU's gradient on the CPU: the gradient kernel's plain version
(``rglru_bwd_ref``: g_t = a_{t+1} g_{t+1} + gh_t walked from g_T = gT, db =
g, da = g h_{t-1}, dh0 = a_0 g_0, a multiply then an add per token) bitwise
the former backward (the forward scan on flipped inputs), within 2e-5 of
``jax.vjp`` of the reference's ``rglru_scan`` with gh and gT each present
or absent, and ``RGLRU``'s CPU backward, the meta device and the cost
formula. The kernel itself runs on the card: tests/test_torch_cuda.py.

Inputs come from numpy seeds: a = sigmoid(N(0, 1)), b = 0.3 N(0, 1), h0,
gh and gT N(0, 1)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models import ssm as ref_ssm  # noqa: E402
from repro_torch.distributed import cost  # noqa: E402
from repro_torch.kernels import rglru  # noqa: E402

TOL = 2e-5
SHAPES = [(2, 1, 8), (3, 17, 40), (2, 64, 24), (2, 300, 33)]


def case(seed, B, T, C):
    """(a, b, h0), (gh, gT) as numpy fp32."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)      # noqa: E731
    a = (1 / (1 + np.exp(-f(B, T, C)))).astype(np.float32)
    return (a, 0.3 * f(B, T, C), f(B, C)), (f(B, T, C), f(B, C))


def t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def flip_form(a, h0, h, gh, gT):
    """The former backward: ``rglru_btc`` on the flipped a_{t+1}, gh and
    gT, then the products."""
    gh = torch.zeros_like(h) if gh is None else gh
    gT = torch.zeros_like(h0) if gT is None else gT
    a_next = torch.cat([a[:, 1:], torch.ones_like(a[:, :1])], dim=1)
    g = rglru.rglru_btc(a_next.flip(1).contiguous(), gh.flip(1).contiguous(),
                        gT.contiguous())[0].flip(1)
    h_prev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
    return g * h_prev, g, a[:, 0] * g[:, 0]


@pytest.mark.parametrize("absent", [None, "gh", "gT", "both"])
@pytest.mark.parametrize("B,T,C", SHAPES)
def test_plain_backward_is_bitwise_the_flip_form(B, T, C, absent):
    """T = 1, short T and T > 256 that is not a multiple of the reference's
    chunk, with gh or gT absent: da, db and dh0 bitwise the flipped scan's,
    whose roundings (a multiply, then an add) the kernel keeps."""
    (a, b, h0), (gh, gT) = case(B * T + C, B, T, C)
    a, b, h0 = t(a), t(b), t(h0)
    gh = None if absent in ("gh", "both") else t(gh)
    gT = None if absent in ("gT", "both") else t(gT)
    h, _ = rglru.rglru_btc(a, b, h0)
    got = rglru.rglru_bwd_ref(a, h, h0, gh, gT)
    for x, y in zip(got, flip_form(a, h0, h, gh, gT)):
        assert x.dtype == torch.float32 and torch.equal(x, y)


@pytest.mark.parametrize("absent", [None, "gh", "gT"])
@pytest.mark.parametrize("B,T,C", SHAPES)
def test_backward_matches_reference_rglru_scan_vjp(B, T, C, absent):
    """``RGLRU``'s backward on CPU tensors (``rglru_bwd`` ->
    ``rglru_bwd_ref``) within 2e-5 of each gradient's max of ``jax.vjp`` of
    the reference's ``rglru_scan``; an absent upstream is zeros there."""
    (a, b, h0), (gh, gT) = case(T + 7 * C, B, T, C)
    if absent == "gh":
        gh = np.zeros_like(gh)
    if absent == "gT":
        gT = np.zeros_like(gT)
    _, vjp = jax.vjp(ref_ssm.rglru_scan, *map(jnp.asarray, (a, b, h0)))
    want = vjp((jnp.asarray(gh), jnp.asarray(gT)))
    xs = [t(x).requires_grad_() for x in (a, b, h0)]
    h, h_T = rglru.rglru_grad(*xs)
    outs, ups = zip(*[(o, t(g)) for o, g, n in ((h, gh, "gh"),
                                                   (h_T, gT, "gT"))
                      if n != absent])
    got = torch.autograd.grad(outs, xs, ups)
    for x, y in zip(got, want):
        y = np.asarray(y, np.float32)
        scale = max(float(np.abs(y).max()), 1e-12)
        assert float(np.abs(x.numpy() - y).max()) <= TOL * scale


def test_meta_backward_shapes_and_cost():
    """On the meta device ``RGLRU``'s backward returns empty fp32 gradients
    of the inputs' shapes and reports ``cost.rglru_bwd_work`` (the reverse
    scan's multiply and add and da's product an element; a, h, gh read and
    da, db written, h0 and gT read and dh0 written) under the ``rgscan``
    tag; so does the CPU backward."""
    B, T, C = 2, 9, 16
    flops, nbytes = cost.rglru_bwd_work(B, T, C)
    assert (flops, nbytes) == (3 * B * T * C, 4 * (5 * B * T * C + 3 * B * C))
    (a, b, h0), (gh, gT) = case(1, B, T, C)
    for dev in ("meta", "cpu"):
        xs = [t(x).to(dev).requires_grad_() for x in (a, b, h0)]
        h, h_T = rglru.rglru_grad(*xs)
        with cost.counting() as c:
            got = torch.autograd.grad((h, h_T), xs, (t(gh).to(dev),
                                                     t(gT).to(dev)))
        for g, x in zip(got, xs):
            assert g.shape == x.shape and g.dtype == torch.float32
            assert g.is_meta == (dev == "meta")
        tagged = c.select("rgscan")
        assert (tagged.flops, tagged.bytes) == (flops, nbytes)
