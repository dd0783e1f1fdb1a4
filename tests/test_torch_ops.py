"""Ops of the PyTorch port against the JAX package, on the same inputs made
from a seeded numpy generator: coordinates, the trivial and the general
camera, the final pass, the tail transcendentals, the stdlib (constants,
GLSL built-ins, vector algebra, piano keys), texelFetch and the host-side
dynamics / quaternion helpers. float32 results agree to 1e-6 relative, or
exactly where the JAX function is exact."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shaderflow_tpu import shader as jax_shader
from shaderflow_tpu.ops import cameralib as jax_cameralib
from shaderflow_tpu.ops import downsample as jax_downsample
from shaderflow_tpu.ops import dynamics as jax_dynamics
from shaderflow_tpu.ops import quaternion as jax_quaternion
from shaderflow_tpu.ops import sampling as jax_sampling
from shaderflow_tpu.ops import stdlib as jax_stdlib
from shaderflow_tpu.ops import tailfuse as jax_tailfuse
from shaderflow_tpu_torch import shader
from shaderflow_tpu_torch.ops import (cameralib, downsample, dynamics, quaternion, sampling,
                                     stdlib, tailfuse)

RTOL = 1e-6
REPO = Path(__file__).resolve().parent.parent


def _assert_close(got, want, err_msg=""):
    """1e-6 relative; near zero, one float32 ulp of the field's largest
    magnitude (a value computed as a - b or a * b from order-1 operands
    carries their absolute rounding, not a relative one)."""
    got, want = _np(got), np.asarray(want)
    scale = np.abs(want[np.isfinite(want)]).max(initial=1.0)
    np.testing.assert_allclose(got, want, rtol=RTOL, err_msg=err_msg,
                               atol=float(np.spacing(np.float32(scale))))


def _np(value):
    return value.numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


@pytest.mark.parametrize("height,width", [(36, 64), (54, 96), (2, 3)])
def test_make_finish_coords_match_jax(height, width):
    """Every coordinate flavor, with the per-frame iResolution, against the
    reference engine's coordinates (jitted, as render_batch builds them).
    The axis lines are equal exactly: XLA folds x / n into x * (1 / n), and
    the port does the same (eager jnp divides: an ulp apart, within 1e-6).
    The flavors agree to 1e-6 relative (an ulp near zero, see
    _assert_close): XLA:CPU's fused multiply-adds round once where the port
    rounds twice."""
    aspect = width / height
    resolution = np.array([width / 2, height / 2], np.float32)
    jitted = jax.jit(lambda r: jax_shader.finish_coords(
        jax_shader.make_coords(height, width, aspect), r))(jnp.asarray(resolution))
    eager = jax_shader.finish_coords(jax_shader.make_coords(height, width, aspect),
                                     jnp.asarray(resolution))
    coords = shader.finish_coords(shader.make_coords(height, width, aspect),
                                  torch.from_numpy(resolution))
    assert set(coords) == set(jitted)
    for name in jitted:
        if name == "aspect":
            assert coords[name] == jitted[name]
            continue
        if name in ("u_line", "v_line"):
            np.testing.assert_array_equal(_np(coords[name]), np.asarray(jitted[name]))
            _assert_close(coords[name], eager[name], err_msg=name)
        _assert_close(coords[name], jitted[name], err_msg=name)


def test_project_trivial_matches_jax():
    """The separable camera at random uniform values: every field, from the
    same lines and per-frame scalars."""
    rng = np.random.default_rng(3)
    height, width = 24, 40
    gluv_x = ((np.arange(width, dtype=np.float32) + 0.5) / width * 2 - 1) * np.float32(width / height)
    gluv_y = ((1 - (np.arange(height, dtype=np.float32) + 0.5) / height) * 2 - 1).astype(np.float32)
    scalars = {name: np.float32(rng.uniform(lo, hi)) for name, lo, hi in (
        ("zoom", 0.5, 2.0), ("isometric", 0.0, 1.0), ("orbital", -0.5, 0.5),
        ("dolly", -0.3, 0.3), ("focal_length", 0.5, 2.0), ("want_aspect", 1.0, 2.0))}
    position = rng.uniform(-1, 1, 3).astype(np.float32)
    resolution = np.array([width, height], np.float32)
    aspect = np.float32(width / height)
    ref = jax_cameralib.project_trivial(
        gluv_x=jnp.asarray(gluv_x), gluv_y=jnp.asarray(gluv_y), position=jnp.asarray(position),
        aspect=jnp.asarray(aspect), resolution=jnp.asarray(resolution),
        **{k: jnp.asarray(v) for k, v in scalars.items()})
    got = cameralib.project_trivial(
        gluv_x=torch.from_numpy(gluv_x), gluv_y=torch.from_numpy(gluv_y),
        position=torch.from_numpy(position), aspect=torch.tensor(aspect),
        resolution=torch.from_numpy(resolution),
        **{k: torch.tensor(v) for k, v in scalars.items()})
    for name in ("origin", "target", "gluv", "agluv", "stuv", "astuv", "stxy",
                 "glxy", "out_of_bounds", "position", "forward", "up", "right"):
        _assert_close(getattr(got, name), getattr(ref, name), err_msg=name)
    x, y = got.line("gluv")
    np.testing.assert_array_equal(_np(got.gluv)[0, :, 0], _np(x))
    np.testing.assert_array_equal(_np(got.gluv)[:, 0, 1], _np(y))


def _rotated_basis(rng):
    """A seeded camera orientation: the global basis rotated by a random
    unit quaternion (the camera module's own algebra)."""
    q = quaternion.qnormalize(quaternion.quaternion(rng.normal(size=3), 37.0))
    return [quaternion.rotate_vector(np.eye(3)[k], q).astype(np.float32) for k in range(3)]


PROJECTIONS = (cameralib.PROJECTION_PERSPECTIVE, cameralib.PROJECTION_STEREOSCOPIC,
               cameralib.PROJECTION_EQUIRECTANGULAR)
CAMERA_FIELDS = ("origin", "target", "gluv", "agluv", "stuv", "astuv", "stxy", "glxy",
                 "out_of_bounds", "position", "forward", "up", "right")


def _camera_inputs(projection: int) -> dict:
    """Screen grids, a rotated basis and per-frame scalars, seeded."""
    rng = np.random.default_rng(4 + projection)
    height, width = 18, 32
    aspect = np.float32(width / height)
    x = ((np.arange(width, dtype=np.float32) + 0.5) / width * 2 - 1)
    y = (1 - (np.arange(height, dtype=np.float32) + 0.5) / height) * 2 - 1
    agluv = np.stack(np.broadcast_arrays(x[None, :], y[:, None]), axis=-1).astype(np.float32)
    right, up, forward = _rotated_basis(rng)
    inputs = dict(gluv=(agluv * np.array([aspect, 1.0], np.float32)).astype(np.float32),
                  agluv=agluv, aspect=aspect, right=right, up=up, forward=forward,
                  position=rng.uniform(-0.5, 0.5, 3).astype(np.float32),
                  resolution=np.array([width, height], np.float32))
    for name, lo, hi in (("zoom", 0.5, 2.0), ("isometric", 0.0, 0.5), ("orbital", -0.3, 0.3),
                         ("dolly", -0.2, 0.2), ("focal_length", 0.8, 2.0),
                         ("separation", 0.0, 0.1), ("want_aspect", 1.0, 2.0)):
        inputs[name] = np.float32(rng.uniform(lo, hi))
    return inputs


def _stdlib_cases() -> dict:
    """name -> (function of a stdlib module and its arguments, seeded
    numpy arguments): the GLSL built-ins, the vector algebra and rotate3d."""
    rng = np.random.default_rng(12)
    a = rng.normal(size=(64, 3)).astype(np.float32)
    b = rng.normal(size=(64, 3)).astype(np.float32)
    t = rng.uniform(-0.2, 1.2, 64).astype(np.float32)
    angle = rng.uniform(-3, 3, 64).astype(np.float32)
    axis = (a[0] / np.linalg.norm(a[0])).astype(np.float32)
    return {
        "mix": (lambda m, x, y, z: m.mix(x, y, z[:, None]), (a, b, t)),
        "clamp": (lambda m, x: m.clamp(x, -0.5, 0.75), (a,)),
        "smoothstep": (lambda m, x: m.smoothstep(0.02, 0.12, x), (t,)),
        "smoothstep_down": (lambda m, x: m.smoothstep(0.98, 0.88, x), (t,)),
        "dot": (lambda m, x, y: m.dot(x, y), (a, b)),
        "cross": (lambda m, x, y: m.cross(x, y), (a, b)),
        "length": (lambda m, x: m.length(x), (a,)),
        "normalize": (lambda m, x: m.normalize(x), (a,)),
        "rotate3d": (lambda m, x, y, z: m.rotate3d(x, y, z), (a, axis, angle)),
    }


CHILD_SCRIPT = """
import sys
import numpy as np
import jax, jax.numpy as jnp
sys.path.insert(0, TESTS)
import test_torch_ops as t
from shaderflow_tpu.ops import cameralib, stdlib
out = {}
for projection in t.PROJECTIONS:
    inputs = {k: jnp.asarray(v) for k, v in t._camera_inputs(projection).items()}
    rays = jax.jit(lambda v: cameralib.project(mode=cameralib.MODE_FREE,
                                               projection=projection, **v))(inputs)
    for name in t.CAMERA_FIELDS:
        out[f"{projection}/{name}"] = np.asarray(getattr(rays, name))
for name, (fn, args) in t._stdlib_cases().items():
    out["stdlib/" + name] = np.asarray(jax.jit(lambda *v: fn(stdlib, *v))(*map(jnp.asarray, args)))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def jax_child(tmp_path_factory):
    """The reference's cameralib.project (every projection) and stdlib
    functions, jitted, in a child on XLA:CPU capped at the AVX ISA: without
    fused multiply-adds, as the scene tests run the reference (in-process
    XLA:CPU contracts a + (b - a) * t; an FMA in the ray origin moves
    origin.z by an ulp, and den = target.z - origin.z cancels)."""
    tmp = tmp_path_factory.mktemp("ops")
    script = (f"TESTS, OUT = {str(REPO / 'tests')!r}, {str(tmp / 'out.npz')!r}\n"
              + CHILD_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


@pytest.mark.parametrize("projection", PROJECTIONS)
def test_project_matches_jax(jax_child, projection):
    """The general camera on a rotated basis, every projection, against the
    reference's cameralib.project: the perspective and stereoscopic fields
    are products and sums in the reference's order and equal it exactly;
    the equirectangular rays go through cos/sin, whose libraries differ by
    an ulp, composed by two Rodrigues rotations: the rays within 8 ulps of
    their largest magnitude, and the plane-hit fields within 1e-4 relative
    or 1e-6 of the field's largest magnitude (the hit divides by target.z -
    origin.z, which cancels near the horizon; measured 3.7e-5 relative)."""
    inputs = _camera_inputs(projection)
    got = cameralib.project(mode=cameralib.MODE_FREE, projection=projection,
                            **{k: torch.from_numpy(np.array(v)) for k, v in inputs.items()})
    for name in CAMERA_FIELDS:
        want = jax_child[f"{projection}/{name}"]
        if projection == cameralib.PROJECTION_EQUIRECTANGULAR and name in ("origin", "target"):
            scale = np.abs(want).max()
            np.testing.assert_allclose(_np(getattr(got, name)), want, rtol=0, err_msg=name,
                                       atol=8 * float(np.spacing(np.float32(scale))))
        elif projection == cameralib.PROJECTION_EQUIRECTANGULAR and want.dtype != bool:
            np.testing.assert_allclose(_np(getattr(got, name)), want, rtol=1e-4, err_msg=name,
                                       atol=1e-6 * float(np.abs(want).max()))
        else:
            np.testing.assert_array_equal(_np(getattr(got, name)), want, err_msg=name)
    if projection != cameralib.PROJECTION_EQUIRECTANGULAR:
        assert _np(got.out_of_bounds).any() and not _np(got.out_of_bounds).all()


def test_quantize_u8_matches_jax():
    """GL u8 rounding, ties and out-of-range values included: exact."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-0.5, 1.5, 4096),
                        (np.arange(256) + 0.5) / 255.0,     # ties
                        [np.inf, -np.inf]]).astype(np.float32)
    np.testing.assert_array_equal(downsample.quantize_u8(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_downsample.quantize_u8(jnp.asarray(x))))


@pytest.mark.parametrize("factor", [2, 3])
def test_box_downsample_matches_jax(factor):
    rng = np.random.default_rng(factor)
    x = rng.random((12 * factor + 1, 10 * factor, 3), np.float32)  # VALID crop
    np.testing.assert_allclose(
        downsample.box_downsample(torch.from_numpy(x), factor).numpy(),
        np.asarray(jax_downsample.box_downsample(jnp.asarray(x), factor)), rtol=RTOL)


@pytest.mark.parametrize("shape,subsample", [((48, 80), 2), ((24, 40), 1), ((24, 40), 2)])
def test_final_pass_matches_jax(shape, subsample):
    """Exact pooling (render = out * s), identity (s = 1) and the
    equal-resolution 3-tap stencil: u8 equal but for summation-order ties."""
    rng = np.random.default_rng(11)
    out_h, out_w = 24, 40
    render = rng.random(shape + (4,), np.float32)
    got = downsample.final_pass(torch.from_numpy(render), out_h, out_w, subsample).numpy()
    ref = np.asarray(jax_downsample.final_pass(jnp.asarray(render), out_h, out_w, subsample))
    assert got.shape == ref.shape == (out_h, out_w, 3) and got.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - ref.astype(np.int16))
    assert diff.max() <= 1 and (diff != 0).mean() < 0.01


def test_ssaa_general_path_not_ported():
    """The general path, once missing here, against the JAX function: a
    50x30 render to 40x24 at subsample 2 (ssaa 1.25), float32 within 3e-6
    (the JAX package's bar against the dense band product)."""
    render = np.random.default_rng(13).random((30, 50, 3), np.float32)
    got = downsample.ssaa_downsample(torch.from_numpy(render), 24, 40, 2).numpy()
    want = np.asarray(jax_downsample.ssaa_downsample(jnp.asarray(render), 24, 40, 2))
    assert got.shape == want.shape == (24, 40, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=3e-6)


def test_atan2_powf_match_jax():
    rng = np.random.default_rng(7)
    y = rng.normal(0, 3, 4096).astype(np.float32)
    x = rng.normal(0, 3, 4096).astype(np.float32)
    inf = np.float32(np.inf)
    y = np.concatenate([y, [inf, inf, -inf, 1.0, 0.0, 5.0]]).astype(np.float32)
    x = np.concatenate([x, [inf, -inf, inf, inf, 0.0, -5.0]]).astype(np.float32)
    _assert_close(tailfuse.atan2(torch.from_numpy(y), torch.from_numpy(x)),
                  jax_tailfuse.atan2(jnp.asarray(y), jnp.asarray(x)))
    # |p log x| <= 1: exp(p log x) multiplies log's rounding error by p log x,
    # so larger exponents compare the two libraries' exp/log, not powf
    base = rng.uniform(0.5, 1.5, 4096).astype(np.float32)
    for p in (0.1, 0.5, 2.0):
        np.testing.assert_allclose(
            tailfuse.powf(torch.from_numpy(base), p).numpy(),
            np.asarray(jax_tailfuse.powf(jnp.asarray(base), p)), rtol=RTOL)


def test_stdlib_matches_jax():
    for index in range(1, 5):
        name = f"PALETTE_MAGMA_{index}"
        np.testing.assert_array_equal(getattr(stdlib, name).numpy(),
                                      np.asarray(getattr(jax_stdlib, name)))
    rng = np.random.default_rng(1)
    a, b = rng.random((5, 3), np.float32), rng.random((5, 3), np.float32)
    np.testing.assert_array_equal(stdlib.vec2(torch.from_numpy(a), 0.5).numpy(),
                                  np.asarray(jax_stdlib.vec2(jnp.asarray(a), 0.5)))
    np.testing.assert_array_equal(stdlib.vec4(torch.from_numpy(b), 1.0).numpy(),
                                  np.asarray(jax_stdlib.vec4(jnp.asarray(b), 1.0)))
    np.testing.assert_array_equal(stdlib.vec2(0.25).numpy(), np.asarray(jax_stdlib.vec2(0.25)))
    assert (stdlib.PI, stdlib.TAU) == (jax_stdlib.PI, jax_stdlib.TAU)


def test_stdlib_functions_match_jax(jax_child):
    """mix, clamp, smoothstep (constant edges: the compiled division is a
    product with the reciprocal), dot, cross, length, normalize and
    rotate3d on seeded inputs, against the reference's stdlib under jit:
    equal, but for the library functions (sqrt's neighbours, cos/sin) at
    1e-6 relative; and the piano-key tests, exactly."""
    for name, (fn, args) in _stdlib_cases().items():
        want = jax_child["stdlib/" + name]
        got = fn(stdlib, *(torch.from_numpy(np.array(v)) for v in args))
        if name in ("rotate3d", "normalize"):
            _assert_close(got, want, err_msg=name)
        else:
            np.testing.assert_array_equal(_np(got), want, err_msg=name)
    keys = np.arange(-14, 140, dtype=np.int32)
    np.testing.assert_array_equal(stdlib.is_black_key(torch.from_numpy(keys)).numpy(),
                                  np.asarray(jax_stdlib.is_black_key(jnp.asarray(keys))))
    np.testing.assert_array_equal(stdlib.is_white_key(torch.from_numpy(keys)).numpy(),
                                  np.asarray(jax_stdlib.is_white_key(jnp.asarray(keys))))


@pytest.mark.parametrize("shape", [(1, 128, 1), (128, 256, 4), (5, 7, 2)])
def test_texel_fetch_matches_jax(shape):
    """texelFetch at in-range and out-of-range integer coordinates (GL
    bottom-left origin, zero outside): equal to the reference's gather."""
    rng = np.random.default_rng(sum(shape))
    data = rng.random(shape, np.float32)
    h, w, _ = shape
    xy = np.stack([rng.integers(-3, w + 3, 200), rng.integers(-3, h + 3, 200)],
                  axis=-1).astype(np.int32)
    want = jax_sampling.texel_fetch(jax_sampling.Sampler2D(jnp.asarray(data)), jnp.asarray(xy))
    got = sampling.texel_fetch(sampling.Sampler2D(torch.from_numpy(data)), torch.from_numpy(xy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_host_dynamics_and_quaternions_match_jax():
    """Host numpy state crosses unchanged: the second-order smoother (both
    coefficient branches) and the quaternion camera algebra."""
    rng = np.random.default_rng(9)
    for frequency, zeta, response, dt in ((1.0, 1.0, 0.0, 1 / 60), (40.0, 0.3, 2.0, 1 / 10)):
        ours = dynamics.DynamicNumber(value=np.zeros(3), frequency=frequency, zeta=zeta,
                                      response=response, integrate=True)
        theirs = jax_dynamics.DynamicNumber(value=np.zeros(3), frequency=frequency, zeta=zeta,
                                            response=response, integrate=True)
        for target in rng.normal(size=(20, 3)):
            np.testing.assert_array_equal(ours.next(target, dt), theirs.next(target, dt))
        np.testing.assert_array_equal(ours.integral, theirs.integral)
    axis, degrees = rng.normal(size=3), 37.0
    q = quaternion.quaternion(axis, degrees)
    np.testing.assert_array_equal(q, jax_quaternion.quaternion(axis, degrees))
    vector = rng.normal(size=3)
    np.testing.assert_array_equal(quaternion.rotate_vector(vector, quaternion.qnormalize(q)),
                                  jax_quaternion.rotate_vector(vector, jax_quaternion.qnormalize(q)))
    assert quaternion.angle(axis, vector) == jax_quaternion.angle(axis, vector)
