"""Checkpoint manager: periodic async snapshots + restart recovery (a port
of the JAX package's ``repro.checkpoint.manager``).

``save`` snapshots the state to host memory at the call (a module in the
reference's layout, tensors as CPU copies), then writes it on a background
thread, so the train/design loop never waits on the disk. Keeps the
newest ``keep`` checkpoints, tracks a JSON "latest" pointer that is only
advanced after a fully successful write, and can persist arbitrary
JSON-serializable state (``extra``) alongside. ``restore`` verifies every
array and falls back to the newest intact copy.

On a mesh every rank calls ``save`` (the snapshot gathers each sharded
leaf whole, which every rank takes part in) and rank 0 alone writes; every
rank restores from the same file, each leaf distributed to its
``placements``.
"""

from __future__ import annotations

import json
import os
import threading
import time

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.checkpoint.io import (MANIFEST, CheckpointCorruptError,
                                       load_pytree, save_pytree)
from repro_torch.distributed.sharding import whole


def _snapshot(state):
    """A host copy of ``state``, taken now."""
    if isinstance(state, nn.Module):
        from repro_torch.bridge import ref_tree
        return ref_tree(state)
    if isinstance(state, torch.Tensor):
        return whole(state).detach().to("cpu", copy=True)
    if isinstance(state, dict):
        return {k: _snapshot(v) for k, v in state.items()}
    if isinstance(state, (list, tuple)):
        return type(state)(_snapshot(v) for v in state)
    return state


class CheckpointManager:
    def __init__(self, directory, *, keep=3, async_write=True):
        self.dir = directory
        self.keep = keep
        self.async_write = async_write
        self._lock = threading.Lock()
        self._pending: list = []
        os.makedirs(directory, exist_ok=True)

    def _base(self, step):
        return os.path.join(self.dir, f"ckpt_{step:08d}")

    # -- write ---------------------------------------------------------

    def save(self, step, state, *, extra=None, block=False):
        """state: a tree of tensors / arrays, or a module. extra: a
        JSON-serializable dict (coordinator / protocol state). In a
        process group of several ranks only rank 0 writes."""
        state = _snapshot(state)
        if dist.is_initialized() and dist.get_rank() != 0:
            return

        def write():
            base = self._base(step)
            save_pytree(state, base, step=step)
            if extra is not None:
                with open(base + ".extra.json", "w") as f:
                    json.dump(extra, f)
            with self._lock:
                with open(os.path.join(self.dir, "latest.json"), "w") as f:
                    json.dump({"step": step, "time": time.time()}, f)
                self._gc()

        if self.async_write and not block:
            t = threading.Thread(target=write, daemon=True)
            t.start()
            self._pending.append(t)
        else:
            write()

    def wait(self):
        for t in self._pending:
            t.join()
        self._pending.clear()

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep]:
            for suffix in (".npz", MANIFEST, ".extra.json"):
                try:
                    os.remove(self._base(s) + suffix)
                except FileNotFoundError:
                    pass

    # -- read ----------------------------------------------------------

    def all_steps(self):
        out = []
        for f in os.listdir(self.dir):
            if f.startswith("ckpt_") and f.endswith(".npz"):
                out.append(int(f[len("ckpt_"):-len(".npz")]))
        return sorted(out)

    def latest_step(self):
        p = os.path.join(self.dir, "latest.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)["step"]

    def restore(self, template, step=None, *, placements=None):
        """Restore the requested (default: latest) step, each leaf with a
        ``placements`` entry as a DTensor (``io.load_pytree``). Every array is
        checksum-verified against its manifest; a corrupted checkpoint
        falls back to the next-oldest
        retained step instead of failing the restart — the returned step
        tells the caller which copy actually loaded. Raises
        ``CheckpointCorruptError`` only when every retained copy is bad.
        Returns (state, extra, step), or three Nones without a
        checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None, None
        candidates = [step] + [s for s in sorted(self.all_steps(),
                                                 reverse=True) if s < step]
        last_err = None
        for s in candidates:
            base = self._base(s)
            try:
                state = load_pytree(template, base, placements)
            except CheckpointCorruptError as e:
                last_err = e
                print(f"[checkpoint] step {s} failed verification "
                      f"({e}); falling back to an older copy", flush=True)
                continue
            extra = None
            if os.path.exists(base + ".extra.json"):
                with open(base + ".extra.json") as f:
                    extra = json.load(f)
            return state, extra, s
        raise CheckpointCorruptError(
            f"no intact checkpoint among steps {candidates}"
        ) from last_err
