"""Escape-time counts of the PyTorch port (shaderflow_tpu_torch/ops/fractal.py)
against the JAX package: the plain loop behind kernel K3 must give the same
counts as _escape_xla and as the Pallas lines kernel (interpret mode).

The JAX side runs in a child interpreter on XLA:CPU capped at the AVX ISA
(--xla_cpu_max_isa=AVX, no FMA): XLA:CPU otherwise contracts a*b+c into
fused multiply-adds, which moves the escape step of chaotic boundary pixels
(measured on the Mandelbrot scene's 192x108 view with cap 142: 22 of 20736
pixels, by up to 16 counts). Without contraction the counts are equal
exactly, which is what these tests hold."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from shaderflow_tpu_torch.ops import fractal

REPO = Path(__file__).resolve().parent.parent
MAX_ITER = 100
CAPS = (None, 37)


def _lines(seed: int = 0):
    """The lines of tests/test_fractal.py's lines-kernel test, plus a seeded
    random pair (sorted, so the view stays a camera-like grid)."""
    rng = np.random.default_rng(seed)
    grid = (np.linspace(-2.2, 1.0, 128, dtype=np.float32),
            np.linspace(-1.3, 1.3, 64, dtype=np.float32))
    random = (np.sort(rng.uniform(-2.2, 1.0, 96)).astype(np.float32),
              np.sort(rng.uniform(-1.3, 1.3, 48)).astype(np.float32))
    return {"grid": grid, "random": random}


JAX_SCRIPT = """
import numpy as np
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from shaderflow_tpu.ops.fractal import _escape_pallas, _escape_xla, _interior_mask, escape_iterations
inputs = np.load(IN)
out = {}
for view in ("grid", "random"):
    cx_line, cy_line = inputs[view + "_cx"], inputs[view + "_cy"]
    h, w = cy_line.shape[0], cx_line.shape[0]
    cx = jnp.asarray(np.broadcast_to(cx_line[None, :], (h, w)))
    cy = jnp.asarray(np.broadcast_to(cy_line[:, None], (h, w)))
    for cap in (None, 37):
        key = f"{view}_{cap}"
        out["xla_" + key] = np.asarray(_escape_xla(
            cx, cy, cx, cy, MAX_ITER, 3.0, interior=_interior_mask(cx, cy), saturate=cap))
        with pltpu.force_tpu_interpret_mode():
            out["pallas_" + key] = np.asarray(_escape_pallas(
                jnp.asarray(cx_line).reshape(1, w), jnp.asarray(cy_line).reshape(h, 1),
                None, None, MAX_ITER, 3.0, tile=(32, 64), unroll=16, saturate=cap,
                sub_rows=16, monotone=True, lines=True))
out["known"] = np.asarray(escape_iterations(jnp.array([[[0.0, 0.0]], [[3.0, 3.0]]]), 50))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def jax_counts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fractal")
    arrays = {}
    for view, (cx, cy) in _lines().items():
        arrays[view + "_cx"], arrays[view + "_cy"] = cx, cy
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    script = (f"IN, OUT, MAX_ITER = {str(tmp / 'in.npz')!r}, "
              f"{str(tmp / 'out.npz')!r}, {MAX_ITER}\n" + JAX_SCRIPT)
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("view", ["grid", "random"])
def test_plain_lines_match_jax(jax_counts, view, cap):
    """K3's plain version (what the CPU path runs) equals _escape_xla and the
    Pallas lines kernel exactly, interior shortcut and saturation included."""
    cx, cy = _lines()[view]
    got = fractal.escape_iterations_sep(torch.from_numpy(cx), torch.from_numpy(cy),
                                        MAX_ITER, radius=3.0, saturate=cap).numpy()
    key = f"{view}_{cap}"
    np.testing.assert_array_equal(got, jax_counts["xla_" + key])
    np.testing.assert_array_equal(got, jax_counts["pallas_" + key])
    assert got.max() == MAX_ITER  # the view holds interior pixels
    if cap is not None:
        # counts are exact below the cap, clamped at it
        assert ((got <= cap) | (got == MAX_ITER)).all()


def test_known_points(jax_counts):
    """tests/test_fractal.py:19-23: the origin is interior (max_iter), a point
    outside the radius escapes at once (0)."""
    c = torch.tensor([[[0.0, 0.0]], [[3.0, 3.0]]])
    got = fractal.escape_iterations(c, 50).numpy()
    assert got[0, 0] == 50 and got[1, 0] == 0
    np.testing.assert_array_equal(got, jax_counts["known"])


def test_plane_form_equals_lines_form():
    """The plane form (per-pixel c) on the broadcast grid gives the lines
    form's counts, in float32 as the scene asks for them."""
    cx, cy = (torch.from_numpy(a) for a in _lines()["random"])
    c = torch.stack(torch.broadcast_tensors(cx[None, :], cy[:, None]), dim=-1)
    lines = fractal.escape_iterations_sep(cx, cy, 80, saturate=23, out_dtype=torch.float32)
    plane = fractal.escape_iterations(c, 80, saturate=23, out_dtype=torch.float32)
    assert lines.dtype == plane.dtype == torch.float32
    torch.testing.assert_close(lines, plane, rtol=0, atol=0)


def test_lines_validation():
    line = torch.zeros(8)
    with pytest.raises(ValueError, match="1-D"):
        fractal.escape_iterations_sep(torch.zeros(2, 8), line, 10)
    with pytest.raises(ValueError, match="out_dtype"):
        fractal.escape_iterations_sep(line, line, 10, out_dtype=torch.float64)
