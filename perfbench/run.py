"""Run one cell of the port's benchmark once, on this machine's card.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. ``BENCHMARK.json`` names the cells; the cell's
configuration, traffic mix, loop, reference, limits and metric readers are
found by name under ``perfbench/`` (``lib/manifest.py``). The run loads,
warms up, measures for ``--seconds`` seconds, then checks what the timed
path produced against the plain reference. It prints progress and, as its
last lines on standard error, each number compared beside its limit; the
result is one JSON object, the last line of standard output. ``--trace 1``
reports the per-layer metrics in place of the end-to-end ones.

Exits 2 without a result where there is no CUDA card or fewer than the cell
asks for, and 3 where a module of JAX or of the JAX package ``repro`` is
loaded once the window has closed. Build caches stay in ``build/`` inside
the checkout.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "extensions")

    from perfbench.lib.manifest import Manifest
    manifest = Manifest(ROOT)
    cell = manifest.cell(args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2

    from perfbench.lib.runner import forbidden_modules, run_cell
    line = run_cell(manifest, args.workload, seed=args.seed,
                    seconds=args.seconds, trace=bool(args.trace),
                    device="cuda:0", t_start=T_START, chips=cell["chips"])
    bad = forbidden_modules(sys.modules)
    if bad:
        print(f"modules of JAX or of the JAX package are loaded: {bad}",
              file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
