#!/usr/bin/env python3
"""Time the port's one-query decode kernels of any checkout on one CUDA card.

  python3 tools/time_decode_attention.py [--src DIR] [--label NAME]

Imports ``repro_torch`` from ``DIR`` (default: this checkout's ``src/``),
builds its kernels, and prints, as in ``chip_smoke.py`` phase 2, the
device time of ``paged_decode_bkgh`` (CUDA-graph replay) beside its plain
version's and its bound, in bf16 at progen-s' heads: the protein engine's
shape (24 slots x 43 cached tokens, 11 pages of 8 a row, L2-warm) and a
design length (256 slots x 320 tokens, 40 pages a row, calls rotating over
pools past the L2); then flash's decode form at recurrentgemma-2b's decode
(8 x 10 x 1 over 2048 bf16 ring keys, fp32 q), which shares the paged
kernel's body. Each figure is checked against the plain version. Then one
JSON line of the numbers. Two checkouts are compared by running
this once per checkout on one card, one run after another, in turns (older,
newer, newer, older). Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("time_decode_attention: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(Path(args.src).resolve()))
    import chip_smoke as cs
    from repro_torch.kernels import _cuda
    from repro_torch.kernels import paged_attention as pa

    print(cs.card_line(), flush=True)
    _cuda.lib()
    rng = np.random.default_rng(0)
    out = {"label": args.label, "src": args.src}
    for key, B, n_tok, maxp, cold in (("24x43", 24, 43, 11, False),
                                      ("256x320", 256, 320, 40, True)):
        r = cs.time_paged(torch, pa, rng, B, n_tok, maxp, cold=cold)
        cs.expect(r["max_abs_err"] <= cs.PAGED_TOL["bfloat16"],
                  f"{key}: max_abs_err {r['max_abs_err']}")
        print(f"{args.label}: paged_decode {B} slots x {n_tok} tokens bf16, "
              f"device ms: kernel {r['ms']:.4f}, plain {r['plain_ms']:.4f}, "
              f"bound {r['bound_ms']:.6f} ({r['bound_by']}), "
              f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound; err "
              f"{r['max_abs_err']:.3e}", flush=True)
        out[key] = r
    g = torch.Generator(device="cuda").manual_seed(0)
    flash = cs.time_flash_decode(torch, g, 8, 10, 2048, 256)
    cs.expect(flash["max_abs_err"] <= cs.TOL["float32"],
              f"flash decode: max_abs_err {flash['max_abs_err']}")
    out["flash_decode_8x10x2048"] = flash
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
