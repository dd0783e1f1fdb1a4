"""The PyTorch port's shader library (shaderflow_tpu_torch/ops/stdlib.py,
complexmath.py and the GL sampler in sampling.py) against the JAX package's
(shaderflow_tpu/ops/stdlib.py, complexmath.py, sampling.py), function by
function on the same seeded inputs.

The JAX side runs each function compiled (jax.jit, as every scene runs it)
in a child interpreter on XLA:CPU capped at the AVX ISA (no FMA
contraction): XLA folds a division by a constant into a product with the
f32 reciprocal and reassociates constant products, and the port computes
what that compiled program computes. Arithmetic-only functions are held to
bit equality. Functions that call a transcendental (sin, cos, arctan,
arccos, exp, log, pow) or sqrt are held to ULPS units in the last place of
the case's largest output: torch's and XLA's float32 libraries differ by
one ulp on 1-14 % of inputs (and torch's CPU sqrt is not correctly
rounded), and a chain of a few ops carries that. The hash noise multiplies
sin by 39758.381532, so an ulp of sin moves its fraction by up to
NOISE_TOL; it is compared on the circle (the fraction wraps)."""

import os
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

from shaderflow_tpu_torch.ops import complexmath, sampling, stdlib

REPO = Path(__file__).resolve().parent.parent
N = 512
ULPS = 4
NOISE_TOL = 2 * 39758.381532 * 2.0 ** -23
PALETTE = tuple(np.array(stop, np.float32) for stop in (
    (0.1, 0.2, 0.3), (0.9, 0.1, 0.4), (0.2, 0.8, 0.6), (1.0, 1.0, 0.1)))


def F(*shape, lo=-1.0, hi=1.0):
    return ("f", shape, lo, hi)


def I(*shape, lo=0, hi=128):
    return ("i", shape, lo, hi)


S = F(N)
S01 = F(N, lo=0.0, hi=1.0)
P = F(N, 2)
P01 = F(N, 2, lo=0.0, hi=1.0)
V3 = F(N, 3)
V4 = F(N, 4, lo=0.0, hi=1.0)
POS = F(N, lo=0.5, hi=2.0)

# case id -> (module, function, arguments, tolerance): an argument is an
# input spec (seeded array, passed as a traced array) or a constant (a
# Python number, tuple or numpy array, closed over as the scenes do);
# tolerance "exact", "ulps" or "noise"
CASES = {
    "vec2": ("stdlib", "vec2", (S, S), "exact"),
    "vec2[x]": ("stdlib", "vec2", (S,), "exact"),
    "vec2[x,const]": ("stdlib", "vec2", (S, 0.5), "exact"),
    "vec3": ("stdlib", "vec3", (S, S, S), "exact"),
    "vec3[vec3]": ("stdlib", "vec3", (V3,), "exact"),
    "vec4": ("stdlib", "vec4", (S, S, S, S), "exact"),
    "vec4[vec3,w]": ("stdlib", "vec4", (V3, 1.0), "exact"),
    "X": ("stdlib", "X", (V4,), "exact"),
    "Y": ("stdlib", "Y", (V4,), "exact"),
    "Z": ("stdlib", "Z", (V4,), "exact"),
    "W": ("stdlib", "W", (V4,), "exact"),
    "XY": ("stdlib", "XY", (V4,), "exact"),
    "YX": ("stdlib", "YX", (V4,), "exact"),
    "RGB": ("stdlib", "RGB", (V4,), "exact"),
    "A": ("stdlib", "A", (V4,), "exact"),
    "with_rgb": ("stdlib", "with_rgb", (V4, V3), "exact"),
    "with_alpha": ("stdlib", "with_alpha", (V4, 0.5), "exact"),
    "fract": ("stdlib", "fract", (F(N, lo=-20.0, hi=20.0),), "exact"),
    "mix": ("stdlib", "mix", (S, S, S01), "exact"),
    "clamp": ("stdlib", "clamp", (S, -0.3, 0.6), "exact"),
    "step": ("stdlib", "step", (0.1, S), "exact"),
    "smoothstep": ("stdlib", "smoothstep", (-0.3, 0.7, S), "exact"),
    "smoothstep[arrays]": ("stdlib", "smoothstep", (F(N, lo=-1.0, hi=-0.5),
                                                    F(N, lo=0.5, hi=1.0), S), "exact"),
    "glsl_mod": ("stdlib", "glsl_mod", (F(N, lo=-20.0, hi=20.0), 3.0), "exact"),
    "length": ("stdlib", "length", (V3,), "ulps"),
    "distance": ("stdlib", "distance", (V3, V3), "ulps"),
    "dot": ("stdlib", "dot", (V3, V3), "exact"),
    "cross": ("stdlib", "cross", (V3, V3), "exact"),
    "normalize": ("stdlib", "normalize", (V3,), "ulps"),
    "reflect": ("stdlib", "reflect", (V3, V3), "exact"),
    "sign": ("stdlib", "sign", (S,), "exact"),
    "radians": ("stdlib", "radians", (F(N, lo=-360.0, hi=360.0),), "exact"),
    "degrees": ("stdlib", "degrees", (F(N, lo=-7.0, hi=7.0),), "exact"),
    "proportion": ("stdlib", "proportion", (POS, S, S), "exact"),
    "lerp": ("stdlib", "lerp", (F(N, lo=0.0, hi=1.0), S, F(N, lo=2.0, hi=3.0), S, S), "exact"),
    "smoothlerp": ("stdlib", "smoothlerp", (S, S, 0.7), "exact"),
    "smin": ("stdlib", "smin", (S, S, 0.5), "exact"),
    "smax": ("stdlib", "smax", (S, S, 0.5), "exact"),
    "smoothmix": ("stdlib", "smoothmix", (S, S, -0.2, 0.8, S), "exact"),
    "smix": ("stdlib", "smix", (S, S, -0.2, 0.8, S), "exact"),
    "triangle_wave": ("stdlib", "triangle_wave", (F(N, lo=-10.0, hi=10.0), 3.0), "exact"),
    "angle_between": ("stdlib", "angle_between", (V3, V3), "ulps"),
    "rotate2d": ("stdlib", "rotate2d", (P, F(N, lo=-7.0, hi=7.0)), "ulps"),
    "rotate2deg": ("stdlib", "rotate2deg", (P, F(N, lo=-360.0, hi=360.0)), "ulps"),
    "rotate3d": ("stdlib", "rotate3d", (V3, V3, F(N, lo=-7.0, hi=7.0)), "ulps"),
    "rotate3deg": ("stdlib", "rotate3deg", (V3, V3, F(N, lo=-360.0, hi=360.0)), "ulps"),
    "stuv2gluv": ("stdlib", "stuv2gluv", (P01,), "exact"),
    "s2g": ("stdlib", "s2g", (P01,), "exact"),
    "gluv2stuv": ("stdlib", "gluv2stuv", (P,), "exact"),
    "g2s": ("stdlib", "g2s", (P,), "exact"),
    "agluv2gluv": ("stdlib", "agluv2gluv", (P, 1.7), "exact"),
    "gluv2agluv": ("stdlib", "gluv2agluv", (P, 1.7), "exact"),
    "stuv2stxy": ("stdlib", "stuv2stxy", (P01, (1920.0, 1080.0)), "exact"),
    "stxy2stuv": ("stdlib", "stxy2stuv", (F(N, 2, lo=0.0, hi=2000.0), (1920.0, 1080.0)),
                  "exact"),
    "astuv2stuv": ("stdlib", "astuv2stuv", (P01, 1.7), "exact"),
    "stuv2astuv": ("stdlib", "stuv2astuv", (P01, 1.7), "exact"),
    "agluv_mirrored_repeat": ("stdlib", "agluv_mirrored_repeat", (F(N, 2, lo=-5.0, hi=5.0),),
                              "exact"),
    "gluv_mirrored_repeat": ("stdlib", "gluv_mirrored_repeat",
                             (F(N, 2, lo=-5.0, hi=5.0), 1.7), "exact"),
    "astuv_oob": ("stdlib", "astuv_oob", (F(N, 2, lo=-0.3, hi=1.3),), "exact"),
    "stuv_oob": ("stdlib", "stuv_oob", (F(N, 2, lo=-0.5, hi=1.5), 1.7), "exact"),
    "agluv_oob": ("stdlib", "agluv_oob", (F(N, 2, lo=-1.3, hi=1.3),), "exact"),
    "gluv_oob": ("stdlib", "gluv_oob", (F(N, 2, lo=-2.0, hi=2.0), 1.7), "exact"),
    "polar2rect": ("stdlib", "polar2rect", (F(N, 1, lo=0.0, hi=2.0), F(N, lo=-7.0, hi=7.0)),
                   "ulps"),
    "sphere2rect": ("stdlib", "sphere2rect", (S01, F(N, lo=0.0, hi=3.2),
                                              F(N, lo=-7.0, hi=7.0)), "ulps"),
    "palette": ("stdlib", "palette", (F(N, lo=-0.2, hi=1.2),) + PALETTE, "exact"),
    "palette_magma": ("stdlib", "palette_magma", (F(N, lo=-0.2, hi=1.2),), "exact"),
    "is_black_key": ("stdlib", "is_black_key", (I(N),), "exact"),
    "is_white_key": ("stdlib", "is_white_key", (I(N),), "exact"),
    "sd_line": ("stdlib", "sd_line", (V3, V3, V3), "ulps"),
    "sd_line_segment": ("stdlib", "sd_line_segment", (V3, V3, V3), "ulps"),
    "sd_sphere": ("stdlib", "sd_sphere", (V3, V3, 0.5), "ulps"),
    "sd_plane": ("stdlib", "sd_plane", (V3, V3, V3), "ulps"),
    "sd_box": ("stdlib", "sd_box", (F(N, 3, lo=-3.0, hi=3.0), V3, F(N, 3, lo=0.2, hi=2.0)),
               "ulps"),
    "sd_box[const]": ("stdlib", "sd_box", (F(N, 3, lo=-3.0, hi=3.0),
                                           np.array([0.0, 0.0, 4.0], np.float32),
                                           np.array([3.0, 3.0, 3.0], np.float32)), "ulps"),
    "sd_octahedron": ("stdlib", "sd_octahedron", (V3, V3, 0.7), "exact"),
    "sd_union": ("stdlib", "sd_union", (S, S), "exact"),
    "sd_smooth_union": ("stdlib", "sd_smooth_union", (S, S, 0.3), "exact"),
    "sd_subtraction": ("stdlib", "sd_subtraction", (S, S), "exact"),
    "sd_smooth_subtraction": ("stdlib", "sd_smooth_subtraction", (S, S, 0.3), "exact"),
    "sd_intersection": ("stdlib", "sd_intersection", (S, S), "exact"),
    "sd_smooth_intersection": ("stdlib", "sd_smooth_intersection", (S, S, 0.3), "exact"),
    "blend": ("stdlib", "blend", (V4, V4), "exact"),
    "alpha_composite": ("stdlib", "alpha_composite", (V4, V4), "exact"),
    "saturate": ("stdlib", "saturate", (V4, 1.3), "exact"),
    "zoom": ("stdlib", "zoom", (P01, 0.9), "exact"),
    "zoom[anchor]": ("stdlib", "zoom", (P01, 0.95, (0.5, 0.5)), "exact"),
    "atan_normalized": ("stdlib", "atan_normalized", (F(N, lo=-5.0, hi=5.0),), "ulps"),
    "atan1": ("stdlib", "atan1", (P,), "ulps"),
    "atan1n": ("stdlib", "atan1n", (P,), "ulps"),
    "atan2": ("stdlib", "atan2", (S, S), "ulps"),
    "atan2[point]": ("stdlib", "atan2", (P,), "ulps"),
    "atan2n": ("stdlib", "atan2n", (S, S), "ulps"),
    "hsv2rgb": ("stdlib", "hsv2rgb", (F(N, 3, lo=-1.0, hi=8.0),), "exact"),
    "hsv2rgb[alpha]": ("stdlib", "hsv2rgb", (F(N, 4, lo=0.0, hi=7.0),), "exact"),
    "hsv2rgb3": ("stdlib", "hsv2rgb3", (F(N, lo=0.0, hi=7.0), S01, S01), "exact"),
    "rgb2hsv": ("stdlib", "rgb2hsv", (F(N, 3, lo=0.0, hi=1.0),), "exact"),
    "rgb2hsv[alpha]": ("stdlib", "rgb2hsv", (V4,), "exact"),
    "noise21": ("stdlib", "noise21", (F(N, 2, lo=-100.0, hi=100.0),), "noise"),
    "noise22": ("stdlib", "noise22", (F(N, 2, lo=-100.0, hi=100.0),), "noise"),
    "noise11": ("stdlib", "noise11", (F(N, lo=-100.0, hi=100.0),), "noise"),
    "cadd": ("complexmath", "cadd", (P, P), "exact"),
    "csub": ("complexmath", "csub", (P, P), "exact"),
    "cmag": ("complexmath", "cmag", (P,), "ulps"),
    "cpol": ("complexmath", "cpol", (P,), "ulps"),
    "ccar": ("complexmath", "ccar", (F(N, 2, lo=-4.0, hi=4.0),), "ulps"),
    "cmul": ("complexmath", "cmul", (P, P), "exact"),
    "cdiv": ("complexmath", "cdiv", (P, F(N, 2, lo=0.5, hi=2.0)), "exact"),
    "cconj": ("complexmath", "cconj", (P,), "exact"),
    "cexp": ("complexmath", "cexp", (F(N, 2, lo=-3.0, hi=3.0),), "ulps"),
    "cpow": ("complexmath", "cpow", (F(N, 2, lo=0.2, hi=2.0), P), "ulps"),
}
# The sampler: filter x wrap x the four coordinate spaces (tests/test_sampling.py)
SAMPLER_CASES = {f"{space}[{'linear' if linear else 'nearest'},"
                 f"{'repeat' if repeat else 'clamp'}]": (space, linear, repeat)
                 for space in ("sample", "astexture", "stexture", "gtexture", "agtexture",
                               "gtexture[mirror]", "gmtexture", "agtexture[mirror]")
                 for linear in (True, False) for repeat in (True, False)}
TEXTURE = (24, 40, 3)
ASPECT = 1.7


def inputs(case: str, arguments: tuple) -> list:
    """The case's arguments: input specs become seeded float32 / int32
    arrays (the seed is the case id's CRC), constants stay as they are."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    values = []
    for argument in arguments:
        if isinstance(argument, tuple) and argument and argument[0] in ("f", "i"):
            kind, shape, lo, hi = argument
            if kind == "f":
                values.append(rng.uniform(lo, hi, shape).astype(np.float32))
            else:
                values.append(rng.integers(lo, hi, shape).astype(np.int32))
        else:
            values.append(argument)
    return values


def sampler_inputs(case: str):
    """A seeded texture and coordinates reaching past [0, 1] (wraps and
    clamps), in the space the accessor reads."""
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    data = rng.random(TEXTURE, np.float32)
    uv = rng.uniform(-0.3, 1.3, (N, 2)).astype(np.float32)
    return data, uv


JAX_SCRIPT = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
sys.path.insert(0, TESTS)
import test_torch_stdlib as t
from shaderflow_tpu.ops import complexmath, sampling, stdlib
modules = {"stdlib": stdlib, "complexmath": complexmath}
out = {}
for case, (module, name, arguments, _) in t.CASES.items():
    values = t.inputs(case, arguments)
    traced = [i for i, v in enumerate(values) if isinstance(v, np.ndarray)
              and v.shape[:1] == (t.N,)]
    def run(*arrays, values=values, traced=traced, fn=getattr(modules[module], name)):
        args = list(values)
        for i, array in zip(traced, arrays):
            args[i] = array
        return fn(*args)
    out[case] = np.asarray(jax.jit(run)(*(values[i] for i in traced)))
for case, (space, linear, repeat) in t.SAMPLER_CASES.items():
    data, uv = t.sampler_inputs(case)
    def run(data, uv, space=space, linear=linear, repeat=repeat):
        tex = sampling.Sampler2D(data, linear=linear, repeat_x=repeat, repeat_y=repeat)
        if space == "sample":
            return sampling.sample(tex, uv)
        if space == "agtexture":
            return sampling.agtexture(tex, uv, t.ASPECT)
        if space == "agtexture[mirror]":
            return sampling.agtexture(tex, uv, t.ASPECT, mirror=True)
        if space == "gtexture[mirror]":
            return sampling.gtexture(tex, uv, mirror=True)
        if space == "gmtexture":
            return sampling.gmtexture(tex, uv, t.ASPECT)
        return getattr(sampling, space)(tex, uv)
    out["sampler/" + case] = np.asarray(jax.jit(run)(data, uv))
np.savez(OUT, **out)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every case through the JAX package, compiled, in a child on XLA:CPU
    capped at the AVX ISA."""
    tmp = tmp_path_factory.mktemp("stdlib")
    script = (f"TESTS, OUT = {str(REPO / 'tests')!r}, {str(tmp / 'out.npz')!r}\n"
              + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    return dict(np.load(tmp / "out.npz"))


def _port(case: str):
    module, name, arguments, _ = CASES[case]
    fn = getattr({"stdlib": stdlib, "complexmath": complexmath}[module], name)
    values = [torch.from_numpy(v) if isinstance(v, np.ndarray) and v.shape[:1] == (N,) else v
              for v in inputs(case, arguments)]
    return fn(*values).numpy()


def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    """The largest difference in units of the last place of the case's
    largest output."""
    scale = np.spacing(np.float32(np.max(np.abs(want))))
    return float(np.max(np.abs(got.astype(np.float64) - want.astype(np.float64))) / scale)


@pytest.mark.parametrize("case", sorted(CASES))
def test_function_matches_jax(reference, case):
    """One case per public function (and a few per form of its
    arguments): the port's output has the reference's shape and dtype
    kind, and is bit-equal, within ULPS, or (the hash noise) within
    NOISE_TOL on the circle."""
    got, want = _port(case), reference[case]
    tolerance = CASES[case][3]
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype.kind == want.dtype.kind, (got.dtype, want.dtype)
    if tolerance == "exact":
        np.testing.assert_array_equal(got, want)
    elif tolerance == "ulps":
        assert _ulps(got, want) <= ULPS, f"{_ulps(got, want):.2f} ulps"
    else:
        first = got if got.ndim == 1 else got[..., 0]
        want_first = want if want.ndim == 1 else want[..., 0]
        circle = np.abs((first - want_first + 0.5) % 1.0 - 0.5)
        assert circle.max() <= NOISE_TOL, circle.max()
        if got.ndim == 2:
            # noise22 hashes coords + its first component: its second is
            # compared where the first agrees bit for bit
            same = first == want_first
            assert same.mean() > 0.5, same.mean()
            second = np.abs((got[same, 1] - want[same, 1] + 0.5) % 1.0 - 0.5)
            assert second.max() <= NOISE_TOL, second.max()


@pytest.mark.parametrize("case", sorted(SAMPLER_CASES))
def test_sampler_matches_jax(reference, case):
    """sample and its accessors (tests/test_sampling.py's cases: filter x
    wrap x the coordinate spaces, mirrored forms too) bit-equal to the
    JAX package's on a seeded 24x40x3 texture at coordinates past the
    edges."""
    space, linear, repeat = SAMPLER_CASES[case]
    data, uv = sampler_inputs(case)
    tex = sampling.Sampler2D(torch.from_numpy(data), linear=linear, repeat_x=repeat,
                             repeat_y=repeat)
    uv = torch.from_numpy(uv)
    if space == "sample":
        got = sampling.sample(tex, uv)
    elif space == "agtexture":
        got = sampling.agtexture(tex, uv, ASPECT)
    elif space == "agtexture[mirror]":
        got = sampling.agtexture(tex, uv, ASPECT, mirror=True)
    elif space == "gtexture[mirror]":
        got = sampling.gtexture(tex, uv, mirror=True)
    elif space == "gmtexture":
        got = sampling.gmtexture(tex, uv, ASPECT)
    else:
        got = getattr(sampling, space)(tex, uv)
    np.testing.assert_array_equal(got.numpy(), reference["sampler/" + case])


def _public(module) -> dict:
    return {name: value for name, value in vars(module).items()
            if not name.startswith("_") and name not in ("annotations", "jax", "jnp", "Array")}


@pytest.mark.parametrize("module", ["stdlib", "complexmath"])
def test_every_public_name_is_ported(module):
    """Every public name of the reference module has a counterpart of the
    same kind in the port (constants equal), and every reference function
    has a parity case above."""
    from shaderflow_tpu.ops import complexmath as jax_complexmath
    from shaderflow_tpu.ops import stdlib as jax_stdlib
    reference = _public({"stdlib": jax_stdlib, "complexmath": jax_complexmath}[module])
    port = {"stdlib": stdlib, "complexmath": complexmath}[module]
    missing = sorted(set(reference) - set(vars(port)))
    assert not missing, missing
    covered = {name for (m, name, _, _) in CASES.values() if m == module}
    for name, value in reference.items():
        if callable(value):
            assert callable(getattr(port, name)), name
            assert name in covered, f"{name} has no parity case"
        else:
            np.testing.assert_array_equal(np.asarray(getattr(port, name)), np.asarray(value),
                                          err_msg=name)


def test_mipmaps_raise():
    """Mip pyramids, once refused here, are ported: a MipSampler is built
    from its levels, and the stdlib's accessors sample one (the level from
    the uv field) to what sample() gives it, within float32 rounding."""
    data = torch.from_numpy(np.random.default_rng(3).random((32, 32, 3), np.float32))
    mip = sampling.mip_pyramid(sampling.Sampler2D(data))
    assert len(sampling.MipSampler(mip.levels, 1).levels) == 6
    stuv = torch.stack(torch.meshgrid(torch.linspace(0, 1, 8), torch.linspace(0, 1, 8),
                                      indexing="xy"), dim=-1)
    np.testing.assert_allclose(sampling.astexture(mip, stuv).numpy(),
                               sampling.sample_mip(mip, stuv).numpy(), atol=1e-6)
