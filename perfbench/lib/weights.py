"""Weights drawn from the run's seed, on the device, in a few large calls.

The leaves of a reference's ``leaves(config)`` are laid end to end in one
flat index. That index is cut into pieces of ``PIECE`` elements; piece ``i``
is one ``torch.randn`` call from a generator on the device seeded from
(seed, i), so any piece can be drawn again alone. Leaf ``n`` takes
``mean + std * z`` over its stretch of the index. The program's module and
the reference's tensors are filled from the same pieces, and the initial
weights can be drawn again piece by piece after the program has updated its
own (``change_norms``) without holding a second copy.
"""

from __future__ import annotations

import numpy as np
import torch

PIECE = 1 << 28          # elements of one draw (1 GiB of fp32)
_MIX = 0x9E3779B97F4A7C15


def piece_seed(seed, i):
    """A 63-bit generator seed for piece ``i`` of run seed ``seed``."""
    return (int(seed) * _MIX + i * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)


def layout(leaves):
    """[(name, shape, mean, std, start, stop)] in the flat index."""
    out, at = [], 0
    for name, shape, _, mean, std in leaves:
        n = int(np.prod(shape))
        out.append((name, tuple(shape), mean, std, at, at + n))
        at += n
    return out


def _pieces(lay, seed, device):
    """Yields (piece start, piece stop, z) over the flat index."""
    total = lay[-1][-1] if lay else 0
    for i, a in enumerate(range(0, total, PIECE)):
        b = min(a + PIECE, total)
        g = torch.Generator(device=device).manual_seed(piece_seed(seed, i))
        yield a, b, torch.randn(b - a, generator=g, device=device)


def _overlaps(lay, a, b):
    for name, shape, mean, std, s, e in lay:
        lo, hi = max(a, s), min(b, e)
        if lo < hi:
            yield name, mean, std, lo - s, hi - s, lo - a, hi - a


@torch.no_grad()
def fill(targets, leaves, seed, device):
    """Fill ``targets`` (name -> tensor of the leaf's shape) from the seed.
    Every leaf must be there, of its shape, and nothing else."""
    lay = layout(leaves)
    names = {n for n, *_ in lay}
    if set(targets) != names:
        raise ValueError(
            f"the program's leaves differ from the reference's: only the "
            f"program's {sorted(set(targets) - names)[:6]}, only the "
            f"reference's {sorted(names - set(targets))[:6]}")
    for name, shape, *_ in lay:
        if tuple(targets[name].shape) != shape:
            raise ValueError(f"{name}: the program's shape "
                             f"{tuple(targets[name].shape)}, the "
                             f"reference's {shape}")
    flat = {n: t.view(-1) for n, t in targets.items()}
    for a, b, z in _pieces(lay, seed, device):
        for name, mean, std, lo, hi, za, zb in _overlaps(lay, a, b):
            flat[name][lo:hi].copy_(z[za:zb] * std + mean)


def draw(leaves, seed, device):
    """The leaves as fresh fp32 tensors (name -> tensor)."""
    out = {name: torch.empty(shape, device=device)
           for name, shape, *_ in layout(leaves)}
    fill(out, leaves, seed, device)
    return out


@torch.no_grad()
def change_norms(current, leaves, seed, device):
    """Each leaf's norm of (current - the initial draw), the initial one
    drawn again piece by piece; name -> float."""
    lay = layout(leaves)
    sums = {n: torch.zeros((), dtype=torch.float64, device=device)
            for n, *_ in lay}
    flat = {n: t.detach().view(-1) for n, t in current.items()}
    for a, b, z in _pieces(lay, seed, device):
        for name, mean, std, lo, hi, za, zb in _overlaps(lay, a, b):
            diff = (z[za:zb] * std + mean).sub_(flat[name][lo:hi])
            sums[name] += torch.linalg.vector_norm(
                diff, dtype=torch.float64).square()
    names = list(sums)
    norms = torch.stack([sums[n] for n in names]).sqrt().cpu().tolist()
    return dict(zip(names, norms))


def leaf_norms(tensors, scale=1.0):
    """name -> float norm of each tensor times ``scale`` (one host read)."""
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(
        tensors[n].detach(), dtype=torch.float64) * scale
        for n in names]).cpu().tolist()
    return dict(zip(names, norms))
