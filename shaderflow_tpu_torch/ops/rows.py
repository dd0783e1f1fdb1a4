"""
Row slabs: the guard of the row-sharded render (parallel/mesh.py).

A row-sharded export renders each program on a window of its rows (a
slab) per shard. A fragment whose pixels are each computed from their own
coordinates and from whole textures renders a slab exactly. An op that
reads across rows of the planes the fragment computes (a blur, a banded
resample, screen-space derivatives), or whose result on a subset of rows
may round differently (a product over rows), or that is computed at the
full render size (a batch prelude, a fused tail), is not exact on a slab.
Such ops call require_whole_rows(): inside a slab it raises WholeRows, and
the engine renders that program whole on every shard from then on. No op
checks anything outside a slab.

The ops that call it: Frag.tail, Frag.prelude, Frag.prelude_indexed
(shader.py); sampling.sample_separable (linear filtering),
sample_separable_planes, sample_rows_planes_blocked,
sample_separable_planes_blocked, apply_resample, convolve2d and the
screen-space derivatives of mip level selection (_screen_diff,
_separable_lod); downsample.box_downsample and ssaa_downsample;
tailfuse.final_equal_resolution.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

_SLAB: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar("slab", default=None)


class WholeRows(Exception):
    """Raised by an op that needs whole rows while a slab renders."""


@contextlib.contextmanager
def slab(rows: Optional[tuple]):
    """Render inside the row window `rows` = (first, end) of a program's
    texture; None renders whole rows (no guard)."""
    token = _SLAB.set(rows)
    try:
        yield
    finally:
        _SLAB.reset(token)


def require_whole_rows(op: str) -> None:
    """Raise WholeRows when called inside a slab."""
    rows = _SLAB.get()
    if rows is not None:
        raise WholeRows(f"{op} needs whole rows (slab rows {rows[0]}:{rows[1]})")
