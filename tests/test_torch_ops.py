"""Ops of the PyTorch port against the JAX package, on the same inputs made
from a seeded numpy generator: coordinates, the trivial camera, the final
pass, the tail transcendentals, the stdlib constants and the host-side
dynamics / quaternion helpers. float32 results agree to 1e-6 relative, or
exactly where the JAX function is exact."""

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
from shaderflow_tpu.ops import stdlib as jax_stdlib
from shaderflow_tpu.ops import tailfuse as jax_tailfuse
from shaderflow_tpu_torch import shader
from shaderflow_tpu_torch.ops import cameralib, downsample, dynamics, quaternion, stdlib, tailfuse

RTOL = 1e-6


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
    with pytest.raises(NotImplementedError):
        cameralib.project()


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
    with pytest.raises(NotImplementedError, match="resample_separable_blocked"):
        downsample.ssaa_downsample(torch.zeros(30, 50, 3), 24, 40, 2)


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
