"""
Resolution fitting (shaderflow_tpu/resolution.py): given an old size, a
partial override, an optional forced aspect ratio, a bounding box and a
scale, produce the final (width, height) — aspect enforcement prioritizes
width changes, bounding preserves aspect, and the result is rounded to a
multiple (codecs want even dimensions).
"""

from __future__ import annotations

import math
from typing import Optional

Pair = tuple[Optional[int], Optional[int]]

_max = max  # the fit() signature shadows the builtin (API parity)


class Resolution:

    @classmethod
    def fit(
        cls,
        old: Optional[Pair] = None,
        new: Optional[Pair] = None,
        max: Optional[Pair] = None,
        ar: Optional[float] = None,
        scale: float = 1.0,
        multiple: int = 2,
    ) -> tuple[int, int]:
        old_w, old_h = old or (None, None)
        new_w, new_h = new or (None, None)
        max_w, max_h = max or (None, None)

        width = new_w or old_w
        height = new_h or old_h

        if not (width and height):
            raise ValueError(
                f"Can't resolve a resolution with missing component(s): ({width=}, {height=})")

        if ar is not None:
            # Derive the missing component from the aspect ratio; when both
            # are present, width changes win.
            if new_h is None:
                from_width = True
            elif new_w is None:
                from_width = False
            elif new_w != old_w:
                from_width = True
            elif new_h != old_h:
                from_width = False
            else:
                from_width = True

            if from_width:
                width, height = (width, width / ar)
            else:
                width, height = (height * ar, height)

            # Bound to the max box preserving aspect: shrink both by the
            # largest per-component overflow factor.
            overflow = 1.0
            if max_w and width > max_w:
                overflow = width / max_w
            if max_h and height > max_h:
                overflow = _max(overflow, height / max_h)
            width, height = (width / overflow, height / overflow)
        else:
            width = min(width, max_w or math.inf)
            height = min(height, max_h or math.inf)

        return (
            multiple * round((width * scale) / multiple),
            multiple * round((height * scale) / multiple),
        )
