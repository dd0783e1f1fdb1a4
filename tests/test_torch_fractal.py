"""Escape-time counts of the PyTorch port (shaderflow_tpu_torch/ops/fractal.py)
against the JAX package: the plain loop behind kernel K3 must give the same
counts as _escape_xla and as the Pallas lines kernel (interpret mode), and
the plane forms (escape_iterations, escape_iterations_z0) the same counts as
the JAX package's; then the two scenes of K3's plane form, Julia and
Mandelbrot under a rotated camera, exported by both packages; then the
Mandelbrot scene against the GL oracle and its golden frame.

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
from shaderflow_tpu.ops.fractal import escape_iterations_z0
for cap in (None, 37):
    out[f"planes_mandelbrot_{cap}"] = np.asarray(escape_iterations(
        jnp.asarray(inputs["planes_c"]), MAX_ITER, 3.0, saturate=cap))
    out[f"planes_julia_{cap}"] = np.asarray(escape_iterations_z0(
        jnp.asarray(inputs["planes_z0"]), jnp.float32(JULIA_C[0]), jnp.float32(JULIA_C[1]),
        MAX_ITER, 3.0, saturate=cap, monotone=True))
    out[f"planes_cplanes_{cap}"] = np.asarray(escape_iterations_z0(
        jnp.asarray(inputs["planes_z0"]), jnp.asarray(inputs["planes_c"][..., 0]),
        jnp.asarray(inputs["planes_c"][..., 1]), MAX_ITER, 3.0,
        interior=jnp.asarray(inputs["planes_interior"]), saturate=cap))
np.savez(OUT, **out)
"""
JULIA_C = (-0.78, 0.151)


def _planes(seed: int = 3) -> dict:
    """Per-pixel operands of the plane forms: a rotated Mandelbrot view
    (c = a rotated, shifted grid), a Julia z0 grid, and an interior mask."""
    rng = np.random.default_rng(seed)
    h, w = 48, 80
    x = np.linspace(-1.8, 1.8, w, dtype=np.float32)
    y = np.linspace(-1.1, 1.1, h, dtype=np.float32)
    gx, gy = np.meshgrid(x, y)
    angle = np.float32(rng.uniform(0.3, 1.2))
    c = np.stack([np.cos(angle) * gx - np.sin(angle) * gy - 0.5,
                  np.sin(angle) * gx + np.cos(angle) * gy], axis=-1).astype(np.float32)
    z0 = np.stack([gx, gy], axis=-1).astype(np.float32)
    return {"planes_c": c, "planes_z0": z0,
            "planes_interior": rng.random((h, w)) > 0.9}


@pytest.fixture(scope="module")
def jax_counts(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("fractal")
    arrays = dict(_planes())
    for view, (cx, cy) in _lines().items():
        arrays[view + "_cx"], arrays[view + "_cy"] = cx, cy
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    script = (f"IN, OUT, MAX_ITER = {str(tmp / 'in.npz')!r}, "
              f"{str(tmp / 'out.npz')!r}, {MAX_ITER}\nJULIA_C = {JULIA_C!r}\n" + JAX_SCRIPT)
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


@pytest.mark.parametrize("cap", CAPS)
@pytest.mark.parametrize("form", ["mandelbrot", "julia", "cplanes"])
def test_plain_planes_match_jax(jax_counts, form, cap):
    """K3's plane forms as the CPU path runs them (escape_plain) equal the
    JAX package's escape_iterations / escape_iterations_z0 exactly: the
    Mandelbrot form on a rotated view (z0 = c, interior shortcut), the
    Julia form (per-pixel z0, 0-d c), and c as planes with an interior
    plane."""
    operands = {k: torch.from_numpy(v) for k, v in _planes().items()}
    if form == "mandelbrot":
        got = fractal.escape_iterations(operands["planes_c"], MAX_ITER, 3.0, saturate=cap)
    elif form == "julia":
        got = fractal.escape_iterations_z0(
            operands["planes_z0"], torch.tensor(JULIA_C[0]), torch.tensor(JULIA_C[1]),
            MAX_ITER, 3.0, saturate=cap, monotone=True)
    else:
        c = operands["planes_c"]
        got = fractal.escape_iterations_z0(operands["planes_z0"], c[..., 0], c[..., 1],
                                           MAX_ITER, 3.0, interior=operands["planes_interior"],
                                           saturate=cap)
    want = jax_counts[f"planes_{form}_{cap}"]
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(np.unique(want)) > 10   # a structured view, not a flat field


def test_lines_validation():
    line = torch.zeros(8)
    with pytest.raises(ValueError, match="1-D"):
        fractal.escape_iterations_sep(torch.zeros(2, 8), line, 10)
    with pytest.raises(ValueError, match="out_dtype"):
        fractal.escape_iterations_sep(line, line, 10, out_dtype=torch.float64)


# --------------------------------------------------------------------------- #
# The scenes of K3's plane form

SCENE_SIZE = dict(width=128, height=72, fps=10, ssaa=2, time=0.3)

SCENE_SCRIPT = """
import sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())
fractals = _import_example("fractals", "fractals")


class MandelbrotRotated(fractals.Mandelbrot):
    def build(self):
        super().build()
        self.camera.rotate2d(ANGLE)
        self.camera.rotation.set(self.camera.rotation.target)


for name, cls in (("julia", fractals.Julia), ("rotated", MandelbrotRotated)):
    scene = cls()
    scene.main(output=f"{TMP}/jax_{name}.rgb", **SIZE)
    frames = scene.engine._frame_uniforms
    np.savez(f"{TMP}/jax_{name}.npz", rotation=np.asarray(scene.camera.rotation.value),
             **{f"{index}/{key}": value for index, frame in enumerate(frames)
                for key, value in frame.items()})
"""


def _read_frames(path: Path) -> np.ndarray:
    return np.fromfile(path, np.uint8).reshape(-1, SCENE_SIZE["height"], SCENE_SIZE["width"], 3)


def _u8_stats(got: np.ndarray, want: np.ndarray) -> tuple:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    mse = float(np.mean(diff.astype(np.float64) ** 2))
    psnr = float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
    return int(diff.max()), float((diff != 0).mean()), psnr


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """Julia and MandelbrotRotated exported by the JAX package in a child on
    XLA:CPU capped at the AVX ISA (no FMA), then by the port on the CPU:
    independently, and (the rotated camera) with the JAX run's rotation
    carried across by engine.load_reference_state."""
    from shaderflow_tpu_torch.engine import load_reference_state
    from test_torch_scene import _import_example
    torch_fractals = _import_example("torch", "torch_fractals")
    tmp = tmp_path_factory.mktemp("fractal_scenes")
    script = (f"TESTS, TMP = {str(REPO / 'tests')!r}, {str(tmp)!r}\n"
              f"SIZE, ANGLE = {SCENE_SIZE!r}, {torch_fractals.MandelbrotRotated.angle!r}\n"
              + SCENE_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    runs = {}
    for name, cls in (("julia", torch_fractals.Julia),
                      ("rotated", torch_fractals.MandelbrotRotated)):
        scene = cls()
        scene.main(output=str(tmp / f"torch_{name}.rgb"), device="cpu", **SCENE_SIZE)
        state = dict(np.load(tmp / f"jax_{name}.npz"))
        runs[name] = dict(port=scene, jax=_read_frames(tmp / f"jax_{name}.rgb"),
                          torch=_read_frames(tmp / f"torch_{name}.rgb"),
                          rotation=state.pop("rotation"), uniforms=state)
    carried = torch_fractals.Mandelbrot()
    load_reference_state(carried, modules={"iCamera": {"rotation": runs["rotated"]["rotation"]}})
    carried.main(output=str(tmp / "carried_rotated.rgb"), device="cpu", **SCENE_SIZE)
    runs["rotated"]["carried"] = _read_frames(tmp / "carried_rotated.rgb")
    return runs


def _assert_uniforms_equal(run) -> None:
    frames = run["port"].engine._frame_uniforms
    assert len(frames) == 3
    for index, frame in enumerate(frames):
        for name, value in frame.items():
            np.testing.assert_array_equal(np.asarray(value), run["uniforms"][f"{index}/{name}"],
                                          err_msg=name)


def test_julia_frames_match_jax(scenes):
    """Julia at 128x72, 2x SSAA, 3 frames, fully independent runs (c from
    iTime's cos and sin on each side): at most one u8 step on < 1 % of
    values (measured: equal bit for bit). Counts of chaotic boundary
    pixels would move with one ulp of c; torch's and XLA's cos and sin
    agree on these frames' arguments, so no state needs carrying."""
    run = scenes["julia"]
    _assert_uniforms_equal(run)
    assert run["torch"].shape == run["jax"].shape == (3, 72, 128, 3)
    assert run["torch"].std() > 10
    max_diff, share, psnr = _u8_stats(run["torch"], run["jax"])
    print(f"Julia independent: max {max_diff} u8 steps on {share:.4%}, PSNR {psnr:.2f} dB")
    assert max_diff <= 1 and share < 0.01


def test_rotated_mandelbrot_frames_match_jax(scenes):
    """Mandelbrot under a camera rolled 30 degrees (camera.rotate2d), 128x72,
    2x SSAA, 3 frames: c from the general cameralib.project, K3's plane
    form with the interior test, K1 with an oob plane. Independent runs
    and a run with the JAX rotation carried across
    (engine.load_reference_state) both within one u8 step on < 1 %
    (measured: equal bit for bit); the captured camera basis is equal."""
    run = scenes["rotated"]
    _assert_uniforms_equal(run)
    assert not np.allclose(run["rotation"], [1.0, 0.0, 0.0, 0.0])
    assert run["torch"].std() > 10
    for kind in ("torch", "carried"):
        max_diff, share, psnr = _u8_stats(run[kind], run["jax"])
        print(f"rotated Mandelbrot {kind}: max {max_diff} u8 steps on {share:.4%}, "
              f"PSNR {psnr:.2f} dB")
        assert max_diff <= 1 and share < 0.01, kind


# --------------------------------------------------------------------------- #
# The Mandelbrot scene against the GL oracle and the golden frame

def _export_frames(tmp_path: Path, width: int, height: int, **options):
    """The port's Mandelbrot exported on the CPU -> (scene, u8 frames)."""
    from test_torch_scene import _import_example
    scene = _import_example("torch", "torch_fractals").Mandelbrot()
    output = tmp_path / "mandelbrot.rgb"
    scene.main(width=width, height=height, fps=10, output=str(output), device="cpu", **options)
    return scene, np.fromfile(output, np.uint8).reshape(-1, height, width, 3)


def test_mandelbrot_psnr_against_oracle(tmp_path):
    """tests/test_psnr_reference.py:61-79 for the port: Mandelbrot at
    320x180, 2x SSAA (subsample 2), quality 5, two frames, against the
    oracle's escape loop (tools/gl_oracle.py:168): >= 40 dB a frame. `-s`
    prints each frame's dB."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import gl_oracle
    finally:
        sys.path.remove(str(REPO / "tools"))
    width, height = 320, 180
    scene, frames = _export_frames(tmp_path, width, height, time=0.2, ssaa=2, subsample=2,
                                   quality=5)
    engine = scene.engine
    uniforms = [{**engine._statics, **snapshot} for snapshot in engine._frame_uniforms]
    assert len(uniforms) == len(frames) == 2
    for index, uniform in enumerate(uniforms):
        uniform = {name: np.asarray(value) for name, value in uniform.items()}
        uniform.setdefault("iQuality", uniform.get("iQualityS", 0.05))
        oracle = gl_oracle.render_scene(gl_oracle.mandelbrot_fragment, uniform,
                                        *scene.render_resolution, width, height, 2,
                                        scene.aspect_ratio)
        value = gl_oracle.psnr(frames[index], oracle)
        print(f"Mandelbrot frame {index}: {value:.2f} dB against the oracle")
        assert value >= 40.0, f"frame {index}: PSNR {value:.1f} dB < 40"


def test_mandelbrot_matches_golden_frame(tmp_path):
    """tests/test_golden.py:46-61 for the port: the last of three frames at
    96x54 and 10 fps with the scene's defaults (ssaa 1, subsample 2,
    quality 50) against tests/golden/mandelbrot.png: > 50 dB."""
    from PIL import Image
    golden = np.array(Image.open(REPO / "tests" / "golden" / "mandelbrot.png"))
    _, frames = _export_frames(tmp_path, 96, 54, time=0.3)
    assert frames.shape[0] == 3 and frames[-1].shape == golden.shape
    mse = np.mean((frames[-1].astype(np.float64) - golden.astype(np.float64)) ** 2)
    value = np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    print(f"Mandelbrot against the golden frame: {value:.2f} dB")
    assert value > 50.0, f"PSNR {value:.1f} dB vs golden"
