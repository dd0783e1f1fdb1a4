"""
The comparison that decides `correct`: the u8 frames the sink received
against the plain reference's frames of the same clip, frame and inputs.

Numbers, over every compared frame of a run (values are u8 steps):
  mse_steps2   mean of the squared difference
  over1_pct    share of values more than one step apart, in percent
  max_step     the largest difference

A configuration's file gives the limit of each number it compares
("compare": {name: limit}); a run is correct when every compared frame
arrived and each number is at or under its limit. The limits, and the
readings they were set from, are in PERF.md.
"""

from __future__ import annotations

import numpy as np


def numbers(pairs: list) -> dict:
    """pairs: [(port (H, W, 3) u8, reference (H, W, 3) u8)] -> the numbers."""
    if not pairs:
        return {"mse_steps2": float("inf"), "over1_pct": 100.0, "max_step": 255.0}
    squared, over, count, worst = 0.0, 0, 0, 0
    for port, ref in pairs:
        diff = np.abs(port.astype(np.int16) - ref.astype(np.int16))
        squared += float(np.sum(diff.astype(np.float64) ** 2))
        over += int(np.count_nonzero(diff > 1))
        count += diff.size
        worst = max(worst, int(diff.max()))
    return {"mse_steps2": squared / count, "over1_pct": 100.0 * over / count,
            "max_step": float(worst)}


def judge(values: dict, limits: dict, missing: int) -> tuple:
    """(correct, lines): each compared number beside its limit, and the
    count of frames due for the comparison that never arrived."""
    lines = [f"missing_frames {missing} limit 0"]
    correct = missing == 0
    for name, limit in limits.items():
        value = values[name]
        lines.append(f"{name} {value!r} limit {limit!r}")
        correct = correct and value <= limit
    return correct, lines
