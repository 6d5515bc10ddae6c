"""The readings that a cell's limits are set from, on this machine's card:
for each seed, one short run of the cell, its numbers compared beside the
reference's, and, on the same inputs, the control's (the reference at a
lower precision put in the program's place) or a planted fault's
(``lib/faults.py``). Never part of a benchmark run.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \\
        [--precision fp8] [--fault half_batch] [--seconds 2]

Prints one JSON object a seed: ``program`` (the numbers of the run, of the
program or of the faulted program) and ``control`` (the control's, unless
``--precision none``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default="fp8")
    ap.add_argument("--fault", default=None)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")

    import torch
    from perfbench.lib import faults
    from perfbench.lib.manifest import Manifest
    from perfbench.lib.runner import run_cell
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    manifest = Manifest(ROOT)
    loop = manifest.mix(manifest.cell(args.workload)["traffic"])["loop"]
    plant = faults.FAULTS[loop][args.fault] if args.fault \
        else contextlib.nullcontext
    for seed in (int(s) for s in args.seeds.split(",")):
        with plant():
            line = run_cell(manifest, args.workload, seed=seed,
                            seconds=args.seconds, trace=False,
                            device="cuda:0", t_start=time.perf_counter(),
                            control=args.precision)
        print(json.dumps({"seed": seed, "fault": args.fault,
                          "correct": line["correct"], **line["control"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
