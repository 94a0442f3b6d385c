"""The comparison that decides `correct`: the numbers a cell compares with
the plain reference, each against its limit (limits/<cell>.json).

Train cells, over the window's own step object's first steps:
  loss_gap    the largest |loss - reference loss| / |reference loss| of a step;
  logit_gap   |logits - reference logits| / |reference logits| of step 1 (the
              past and future action logits of every clip, as made);
  grad_gap    of step 1's gradient, the worst leaf's |norm - reference norm|
              over the larger of the reference's norm of that leaf and of
              the median leaf;
  change_gap  the same of |p_end - p_0|, over the leaves whose reference
              gradient is at least a thousandth of the median leaf's (the
              others move by rounding alone);
  frames_gap  (video) |frames - reference frames| / |reference frames| of
              step 1's preprocessed clips, every clip.
Serve cells, over a sample of the window's requests drawn from the seed:
  logit_gap   the worst answer's |logits - reference| / |reference|, one
              answer a clip (the norms over its actions).
Every cell: `launch_mismatch` (the kernels launched against the path's
count), `failed_units` (the window's non-finite losses or wrong-shaped
answers) and, train, `draw_mismatch` (the reference's draws against the
program's), each with the limit 0.
"""
from __future__ import annotations

import statistics
from typing import Dict, List, Optional, Tuple

import numpy as np

TINY_GRAD = 1e-3  # of the median leaf's reference gradient norm
EXACT = {"launch_mismatch": 0.0, "draw_mismatch": 0.0, "failed_units": 0.0}


def rel_gap(got, want) -> float:
    """|got - want| / |want| over whole tensors; inf where the shapes differ."""
    if got.shape != want.shape:
        return np.inf
    got = got.to(want.device).float()
    return float((got - want.float()).norm() / want.float().norm())


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             keep: Optional[List[str]] = None) -> Tuple[float, str]:
    names = list(ref) if keep is None else keep
    med = statistics.median(ref[n] for n in ref)
    worst = (0.0, "")
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
        if gap > worst[0]:
            worst = (gap, n)
    return worst


def worst_leaves(prog: dict, ref: dict) -> Dict[str, str]:
    """Which leaf sets grad_gap and change_gap, with both norms."""
    out = {}
    for key in ("grad_norms", "change_norms"):
        gap, name = leaf_gap(prog[key], ref[key])
        out[key] = f"{name}: {prog[key].get(name)} vs {ref[key].get(name)} ({gap:.3g})"
    return out


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"], ref["losses"]))
    med = statistics.median(ref["grad_norms"].values())
    kept = [n for n, g in ref["grad_norms"].items() if g >= TINY_GRAD * med]
    numbers = {"loss_gap": loss,
               "logit_gap": rel_gap(prog["logits"], ref["logits"]),
               "grad_gap": leaf_gap(prog["grad_norms"], ref["grad_norms"])[0],
               "change_gap": leaf_gap(prog["change_norms"], ref["change_norms"], kept)[0]}
    if ref.get("frames") is not None:
        got = prog.get("frames")
        numbers["frames_gap"] = np.inf if got is None else rel_gap(got, ref["frames"])
    return numbers


def logit_gap(outputs: List[np.ndarray], refs: List[np.ndarray]) -> float:
    worst = 0.0
    for o, r in zip(outputs, refs):
        if o.shape != r.shape:
            return np.inf
        gaps = np.linalg.norm(o - r, axis=-1) / np.linalg.norm(r, axis=-1)
        worst = max(worst, float(gaps.max()))
    return worst


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Every number at or under its limit; a number that is not finite
    fails. Returns (correct, {name: {'value', 'limit'}})."""
    ok = all(np.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    # a number that is not finite is printed as 1e300, which JSON can hold
    checks = {k: {"value": float(v) if np.isfinite(v) else 1e300, "limit": float(limits[k])}
              for k, v in numbers.items()}
    return ok, checks
