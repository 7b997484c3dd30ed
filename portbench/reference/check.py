"""The numbers that decide `correct`, each set beside its limit.

Images (the frames and request cells): the program's u8 output against
the reference's u8 of the same input, as the largest gap in codes and
the mean gap in codes over every value.

Training: the program's first three steps against the reference's on
the same batches from the same parameters: each step's loss (relative
gap), the first step's gradient and the parameters' change after three
steps, by leaf: the gap between the program's norm of a leaf and the
reference's, over the larger of the reference's norm of that leaf and
of the median leaf, taken at the worst leaf and at the median one; and
for the gradient also the norm of the difference over the same
denominator (``grad_diff``), which unbiased rounding moves to first
order where it moves a norm only to second.
Leaves whose reference gradient is under a thousandth of the median
leaf's move under Adam by round-off alone, and are left out of the
change.  The cell's limits file names the readings compared.
"""

from __future__ import annotations

import numpy as np


def image_gaps(out_u8: np.ndarray, ref_u8: np.ndarray) -> dict:
    if out_u8.shape != ref_u8.shape:
        raise ValueError(f"output {out_u8.shape} for reference "
                         f"{ref_u8.shape}")
    d = np.abs(out_u8.astype(np.int16) - ref_u8.astype(np.int16))
    return {"max_code_gap": int(d.max()), "mean_code_gap": float(d.mean())}


def merge_image_gaps(gaps: list) -> dict:
    """The worst of each number over the images compared; None (which no
    limit passes) where none was compared."""
    if not gaps:
        return {"max_code_gap": None, "mean_code_gap": None}
    return {"max_code_gap": max(g["max_code_gap"] for g in gaps),
            "mean_code_gap": max(g["mean_code_gap"] for g in gaps)}


def _leaf_gaps(prog: dict, ref: dict, names) -> dict:
    """name -> |norm(prog leaf) - norm(ref leaf)| / max(norm(ref leaf),
    median leaf norm)."""
    rn = {k: float(np.linalg.norm(ref[k])) for k in names}
    med = float(np.median(list(rn.values())))
    return {k: abs(float(np.linalg.norm(prog[k])) - rn[k]) / max(rn[k], med)
            for k in names}


def _leaf_diffs(prog: dict, ref: dict, names) -> dict:
    """name -> norm(prog leaf - ref leaf) / max(norm(ref leaf), median
    leaf norm)."""
    rn = {k: float(np.linalg.norm(ref[k])) for k in names}
    med = float(np.median(list(rn.values())))
    return {k: float(np.linalg.norm(np.asarray(prog[k]) - ref[k]))
            / max(rn[k], med) for k in names}


def train_gaps(prog: dict, ref: dict) -> dict:
    """``prog`` and ``ref``: {"losses": [3], "grad1": leaf -> array,
    "delta": leaf -> array}, leaves in one layout.  Every reading; the
    limits file names those compared.  A reading the program gave no
    leaves for (a step that never ran) is None."""
    lp, lr = np.asarray(prog["losses"], np.float64), \
        np.asarray(ref["losses"], np.float64)
    # None for a step whose loss the program lacks or made not finite
    steps = [float(abs(lp[i] - lr[i]) / abs(lr[i]))
             if i < len(lp) and np.isfinite(lp[i]) else None
             for i in range(len(lr))]
    names = sorted(ref["grad1"])
    gn = {k: float(np.linalg.norm(ref["grad1"][k])) for k in names}
    med = float(np.median(list(gn.values())))
    moved = [k for k in names if gn[k] >= 1e-3 * med]
    out = dict.fromkeys(("grad_gap", "grad_diff", "delta_gap",
                         "delta_gap_median"))
    if prog.get("grad1"):
        out["grad_gap"] = max(_leaf_gaps(prog["grad1"], ref["grad1"],
                                         names).values())
        out["grad_diff"] = max(_leaf_diffs(prog["grad1"], ref["grad1"],
                                           names).values())
    if prog.get("delta"):
        d = list(_leaf_gaps(prog["delta"], ref["delta"], moved).values())
        out["delta_gap"] = max(d)
        out["delta_gap_median"] = float(np.median(d))
    return {"loss_gap": steps[0],
            "loss_gap_max3": None if None in steps else max(steps), **out,
            "left_out": [k for k in names if k not in moved]}


def judge(numbers: dict, limits: dict) -> tuple:
    """(ok, {name: {"value", "limit"}}) over the numbers that ``limits``
    names: each at or under its limit; a limit without its number fails.
    The other readings are not compared."""
    rows, ok = {}, True
    for k in sorted(limits):
        v = numbers.get(k)
        rows[k] = {"value": v, "limit": limits[k]}
        if v is None or not v <= limits[k]:
            ok = False
    return ok, rows
