"""What decides ``correct``: the program's outputs against the plain
reference's on the same inputs and weights, each number against the limit
in ``perfbench/limits/<cell>.json``.

Training (each a relative gap, the worst one):
  loss_gap    each set-up step's loss
  gnorm_gap   the first step's global gradient norm before clipping
  grad_gap    the first step's gradient as AdamW took it, by the worst leaf:
              |norm(program) - norm(reference)| over the larger of the
              reference's norm of that leaf and of the median leaf
  grad_gap_median  the same gaps' median over the leaves, where the worst
              leaf is not steady from seed to seed (a cell's limits name the
              numbers it compares)
  change_gap  each leaf's change after the set-up steps, the same way; a
              leaf whose reference gradient is under a thousandth of the
              median leaf's is left out (it moves by round-off alone)
Serving, at every served position of the checked requests:
  logit_rms   the root mean square of (the logits the program served from
              - the reference's) over the vocabulary, over that of the
              reference's logits
  logit_gap   the widest of those gaps (logit units)
  token_gap   the widest gap by which a served token's reference logit lies
              below the reference's best at its position (logit units)

With ``ctx.control`` (``perfbench/control.py``, never a benchmark run) every
number is returned, and unless it is ``"none"`` the reference is also
computed at that precision and read as if it were the program, on the same
inputs.
"""

from __future__ import annotations

import gc
import math
import statistics
import sys

import torch

from perfbench.lib import weights

SKIP = 1e-3      # of the median leaf's reference gradient


def _rel(a, b):
    return abs(a - b) / abs(b) if b else (0.0 if a == b else math.inf)


def _gaps(prog, ref, keep):
    """Each kept leaf's |norm(program) - norm(reference)| over the larger
    of the reference's norm of that leaf and of the median kept leaf."""
    names = [n for n in ref if n in keep]
    med = statistics.median(ref[n] for n in names)
    return [abs(prog[n] - ref[n]) / max(ref[n], med) for n in names]


def training_numbers(prog, ref):
    med = statistics.median(ref["grad"].values())
    moving = {n for n, g in ref["grad"].items() if g >= SKIP * med}
    return {
        "loss_gap": max(_rel(p, r) for p, r in zip(prog["loss"],
                                                   ref["loss"])),
        "gnorm_gap": _rel(prog["gnorm"], ref["gnorm"]),
        "grad_gap": max(_gaps(prog["grad"], ref["grad"], set(ref["grad"]))),
        "grad_gap_median": statistics.median(
            _gaps(prog["grad"], ref["grad"], set(ref["grad"]))),
        "change_gap": max(_gaps(prog["change"], ref["change"], moving)),
    }


def checks(numbers, limits):
    """{name: {"value", "limit"}} for every number the limits name."""
    return {n: {"value": numbers[n], "limit": limits[n]["limit"]}
            for n in limits if not n.startswith("_")}


def passed(checked):
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checked.values())


def _follow(ctx, leaves, feed, n, precision):
    W = weights.draw(leaves, ctx.seed, ctx.device)
    out = ctx.reference.follow_training(W, ctx.config, ctx.mix["opt"], feed,
                                        n, precision)
    out["change"] = weights.change_norms(W, leaves, ctx.seed, ctx.device)
    del W
    gc.collect()
    ctx.free()
    return out


def report(prog, ref, out=sys.stderr, top=5):
    """The readings behind the training numbers, on ``out``: losses, global
    norms, and the leaves that read worst."""
    print(f"loss program {prog['loss']} reference {ref['loss']}", file=out)
    print(f"global gradient norm program {prog['gnorm']!r} reference "
          f"{ref['gnorm']!r}", file=out)
    for key in ("grad", "change"):
        med = statistics.median(ref[key].values())
        worst = sorted(ref[key], key=lambda n: -abs(prog[key][n] - ref[key][n])
                       / max(ref[key][n], med))[:top]
        print(f"{key}: median leaf {med!r}; worst " + "; ".join(
            f"{n} {prog[key][n]!r} vs {ref[key][n]!r}" for n in worst),
            file=out)


def train_follow(ctx, leaves, feed, n, prog):
    """(checks of the program, the control's numbers or None)."""
    ref = _follow(ctx, leaves, feed, n, "fp32")
    report(prog, ref)
    numbers = training_numbers(prog, ref)
    control = None
    if ctx.control:
        control = {"program": numbers, "control": None}
        if ctx.control != "none":
            ctl = _follow(ctx, leaves, feed, n, ctx.control)
            control["control"] = training_numbers(ctl, ref)
    return checks(numbers, ctx.limits), control


def _token_gaps(ref_logits, tokens):
    """Each token's gap below the best reference logit at its position."""
    best = ref_logits.amax(-1)
    got = ref_logits.gather(-1, tokens[..., None].long())[..., 0]
    return best - got


def serve_follow(ctx, leaves, prompts, served, logits):
    """prompts (N, P), served (N, G) and the program's logits at the served
    positions (N, G, V), on the host. (checks, every number and the
    control's with ``ctx.control``, else None)."""
    W = weights.draw(leaves, ctx.seed, ctx.device)
    P, rows = prompts.shape[1], ctx.mix["check_rows"]
    numbers = {"logit_gap": 0.0, "token_gap": 0.0}
    low = dict(numbers)
    sq = {"program": 0.0, "control": 0.0, "reference": 0.0}
    for i in range(0, prompts.shape[0], rows):
        ids = torch.cat([prompts[i:i + rows], served[i:i + rows, :-1]],
                        dim=1).to(ctx.device)
        ref = ctx.reference.logits_at(W, ids, P - 1, ctx.config, "fp32")
        got = logits[i:i + rows].to(ctx.device).float()
        V = min(got.shape[-1], ref.shape[-1])
        diff = got[..., :V] - ref[..., :V]
        numbers["logit_gap"] = max(numbers["logit_gap"],
                                   float(diff.abs().max()))
        sq["program"] += float(diff.double().square().sum())
        sq["reference"] += float(ref.double().square().sum())
        numbers["token_gap"] = max(numbers["token_gap"], float(
            _token_gaps(ref, served[i:i + rows].to(ctx.device)).max()))
        if ctx.control and ctx.control != "none":
            ctl = ctx.reference.logits_at(W, ids, P - 1, ctx.config,
                                          ctx.control)
            low["logit_gap"] = max(low["logit_gap"], float(
                (ctl - ref).abs().max()))
            sq["control"] += float((ctl - ref).double().square().sum())
            low["token_gap"] = max(low["token_gap"], float(
                _token_gaps(ref, ctl.argmax(-1)).max()))
            del ctl
        del ref, got
    del W
    gc.collect()
    ctx.free()
    numbers["logit_rms"] = (sq["program"] / sq["reference"]) ** 0.5
    low["logit_rms"] = (sq["control"] / sq["reference"]) ** 0.5
    print(f"served tokens checked {served.numel()}: logits' rms gap over "
          f"their rms {numbers['logit_rms']!r}, widest logit gap "
          f"{numbers['logit_gap']!r}, widest gap of a served token below "
          f"the best {numbers['token_gap']!r}", file=sys.stderr)
    control = None
    if ctx.control:
        control = {"program": numbers,
                   "control": None if ctx.control == "none" else low}
    return checks(numbers, ctx.limits), control
