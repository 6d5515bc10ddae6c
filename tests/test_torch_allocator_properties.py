"""``tests/test_allocator_properties.py`` over both packages: the
allocator's bucketing and shape arithmetic in the reference's
``repro.runtime.allocator`` and the port's copy, each property run on the
same examples.

Invariants:

- ``choose_length_buckets`` covers its own histogram: every length it was
  built from pads by at most ``max_pad``, and every edge is a length that
  actually occurred.
- ``bucket_len`` is idempotent, its edges are fixed points, and past the
  largest edge it stays a bounded multiple of it.
- ``grant_for_rows`` never exceeds the healthy pool, never drops below the
  floor, and is monotone in the row count.
- ``request_for_rows`` only carves what the pool can hold: live grants sum
  to at most the pool, and releasing everything restores it.

Where ``hypothesis`` is installed it draws the examples, as in the
reference's file; where it is absent each property walks ``EXAMPLES``
examples drawn from a seeded numpy generator instead of skipping.
"""

import importlib

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    given = settings = st = None

import repro.core  # noqa: F401  — resolves the core<->runtime import cycle

PKGS = ("repro", "repro_torch")


def allocator(pkg):
    return importlib.import_module(f"{pkg}.runtime.allocator")


class Draw:
    """One argument's examples: a hypothesis strategy and the same range
    drawn from a numpy generator."""

    def __init__(self, strategy, numpy_draw):
        self.strategy, self.numpy_draw = strategy, numpy_draw


def ints(lo, hi):
    return Draw(st and st.integers(min_value=lo, max_value=hi),
                lambda rng: int(rng.integers(lo, hi + 1)))


def floats(lo, hi):
    return Draw(st and st.floats(min_value=lo, max_value=hi),
                lambda rng: float(rng.uniform(lo, hi)))


def lists(of, lo, hi):
    return Draw(st and st.lists(of.strategy, min_size=lo, max_size=hi),
                lambda rng: [of.numpy_draw(rng)
                             for _ in range(int(rng.integers(lo, hi + 1)))])


def walk(examples, **draws):
    """Run the property on ``examples`` examples of ``draws`` for each
    package: hypothesis's where it is installed, else a seeded walk."""
    def deco(fn):
        if given is not None:
            run = settings(max_examples=examples, deadline=None)(
                given(**{k: d.strategy for k, d in draws.items()})(fn))
        else:
            def run(pkg):
                rng = np.random.default_rng(0)
                for _ in range(examples):
                    fn(pkg, **{k: d.numpy_draw(rng)
                               for k, d in draws.items()})
            run.__name__, run.__doc__ = fn.__name__, fn.__doc__
        return pytest.mark.parametrize("pkg", PKGS)(run)
    return deco


class FakeDev:
    _n = 0

    def __init__(self):
        FakeDev._n += 1
        self.id = FakeDev._n


def fake_grid(n):
    return np.array([FakeDev() for _ in range(n)], dtype=object)


LENGTHS = lists(ints(1, 2048), 1, 64)
PAD = floats(0.01, 0.5)
POOL, ROWS = ints(1, 16), ints(1, 256)


# ---------------------------------------------------------------------------
# choose_length_buckets / bucket_len
# ---------------------------------------------------------------------------


@walk(200, lengths=LENGTHS, max_pad=PAD)
def test_chosen_buckets_cover_their_histogram(pkg, lengths, max_pad):
    a = allocator(pkg)
    edges = a.choose_length_buckets(lengths, max_pad=max_pad)
    assert edges == tuple(sorted(edges))
    assert set(edges) <= {int(v) for v in lengths}   # edges occurred
    for L in lengths:
        b = a.bucket_len(L, edges)
        assert b >= L
        # the fill guarantee the greedy construction promises
        assert L / b >= 1.0 - max_pad - 1e-9


@walk(200, lengths=LENGTHS, max_pad=PAD, L=ints(1, 4096))
def test_bucket_len_idempotent_and_edges_fixed(pkg, lengths, max_pad, L):
    a = allocator(pkg)
    edges = a.choose_length_buckets(lengths, max_pad=max_pad)
    for e in edges:
        assert a.bucket_len(e, edges) == e           # edges are fixed points
    b = a.bucket_len(L, edges)
    assert a.bucket_len(b, edges) == b               # idempotent
    assert b >= L
    if L > max(edges):
        # bounded overflow: the next multiple of the largest edge
        assert b % max(edges) == 0 and b - L < max(edges)


@walk(200, n=ints(1, 10_000))
def test_bucket_rows_properties(pkg, n):
    a = allocator(pkg)
    b = a.bucket_rows(n)
    assert b >= n
    assert a.bucket_rows(b) == b                     # idempotent
    if b > a.BATCH_BUCKETS[-1]:
        assert b % a.BATCH_BUCKETS[-1] == 0 and b < 2 * n
    else:
        assert b in a.BATCH_BUCKETS


@pytest.mark.parametrize("pkg", PKGS)
def test_bucket_tables_deterministic_edges(pkg):
    # always-run anchors for the same invariants
    a = allocator(pkg)
    assert a.choose_length_buckets([]) is None
    assert a.choose_length_buckets([24, 24, 24]) == (24,)
    edges = a.choose_length_buckets([100, 99, 90, 50, 10], max_pad=0.125)
    assert edges == tuple(sorted(edges)) and 100 in edges
    for L in (100, 99, 90, 50, 10):
        assert L / a.bucket_len(L, edges) >= 0.875
    assert a.bucket_len(513) == 1024                 # past the global table
    assert a.bucket_rows(65) == 128


# ---------------------------------------------------------------------------
# grant_for_rows / request_for_rows against a fake pool
# ---------------------------------------------------------------------------


@walk(200, pool=POOL, rows=ROWS, floor=ints(1, 4))
def test_grant_for_rows_pool_bound_and_floored(pkg, pool, rows, floor):
    a = allocator(pkg)
    alloc = a.DeviceAllocator(fake_grid(pool))
    g = alloc.grant_for_rows(rows, floor=floor)
    assert g >= floor
    assert g <= max(floor, alloc.healthy_devices)
    # above the floor the grant splits bucketed batches evenly
    if g > floor:
        assert g & (g - 1) == 0                      # power of two
        assert g <= a.bucket_rows(rows)


@walk(200, pool=POOL, rows_list=lists(ROWS, 2, 8))
def test_grant_for_rows_monotone_in_rows(pkg, pool, rows_list):
    alloc = allocator(pkg).DeviceAllocator(fake_grid(pool))
    grants = [alloc.grant_for_rows(r) for r in sorted(rows_list)]
    assert grants == sorted(grants)


@walk(100, pool=POOL, rows_list=lists(ROWS, 1, 8))
def test_request_for_rows_never_overcommits(pkg, pool, rows_list):
    alloc = allocator(pkg).DeviceAllocator(fake_grid(pool))
    subs = []
    for r in rows_list:
        sub = alloc.request_for_rows(r)
        if sub is None:
            continue                                 # pool exhausted: fine
        assert sub.n_devices <= alloc.grant_for_rows(r)
        subs.append(sub)
    live = sum(s.n_devices for s in subs)
    assert live <= alloc.total_devices
    assert alloc.n_free == alloc.total_devices - live
    for s in subs:
        alloc.release(s)
    assert alloc.n_free == alloc.total_devices       # fully restored


@pytest.mark.parametrize("pkg", PKGS)
def test_request_for_rows_shrinks_under_pressure(pkg):
    # deterministic anchor: with most of an 8-pool held, a 64-row request
    # halves down to what fits instead of failing
    alloc = allocator(pkg).DeviceAllocator(fake_grid(8))
    held = alloc.request(6)
    assert held is not None
    sub = alloc.request_for_rows(64)
    assert sub is not None and sub.n_devices <= 2
    stats = alloc.shape_stats()
    assert stats["grants"] == 1 and stats["downsized"] == 1
    alloc.release(sub)
    alloc.release(held)
    assert alloc.n_free == 8


@pytest.mark.parametrize("pkg", PKGS)
def test_request_for_rows_none_when_floor_cannot_fit(pkg):
    alloc = allocator(pkg).DeviceAllocator(fake_grid(4))
    held = alloc.request(4)
    assert held is not None
    assert alloc.request_for_rows(8, floor=2) is None
    alloc.release(held)


def test_seeded_walk_runs_each_example():
    """The walk that stands in for hypothesis: every example of its seeded
    draws reaches the property, in range, the same on every run."""
    seen = []

    def prop(pkg, n, xs):
        seen.append((pkg, n, tuple(xs)))
    global given
    saved, given = given, None
    try:
        case = walk(5, n=ints(3, 7), xs=lists(floats(0.0, 1.0), 1, 3))(prop)
    finally:
        given = saved
    case("repro_torch")
    first = list(seen)
    case("repro_torch")
    assert len(first) == 5 and seen[5:] == first
    assert all(3 <= n <= 7 and 1 <= len(xs) <= 3
               and all(0.0 <= x <= 1.0 for x in xs) for _, n, xs in first)
