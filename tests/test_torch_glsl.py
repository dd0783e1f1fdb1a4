"""The PyTorch port's GLSL front-end (shaderflow_tpu_torch/glsl.py) against
the JAX package's (shaderflow_tpu/glsl.py).

Every inline source shape of tests/test_glsl.py (and a few more: a uniform
condition, integer division and remainder, the builtins) runs through both
front-ends at tests/test_glsl.py's 8x4 size on the same uniforms and
textures. The JAX side runs each fragment compiled (jax.jit, as the engine
runs it) in one child interpreter on XLA:CPU capped at the AVX ISA (no FMA
contraction). Arithmetic and selects are held to bit equality; sources
that call a transcendental (sin, cos, exp, log, pow, atan, sqrt, ...) to
ULPS units in the last place of the case's largest output, the stdlib's
bar (tests/test_torch_stdlib.py). The same sources raise GlslError in
both. The masked loop's host reads every k trips give the values of a read
every trip. The Plasma scene (examples/glsl/shaders/plasma.frag) and a
`.frag` file export through both packages within one u8 step on < 1 % of
values. `-s` prints the measured figures."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_scene import _import_example

import shaderflow_tpu_torch
from shaderflow_tpu_torch import glsl
from shaderflow_tpu_torch.glsl import GlslError, compile_fragment, looks_like_glsl
from shaderflow_tpu_torch.shader import Frag, finish_coords, make_coords, missing_fragment

REPO = Path(__file__).resolve().parent.parent
W, H = 8, 4
ULPS = 4
TIME = 0.75
EXPORT = dict(width=96, height=54, fps=10, time=0.2, ssaa=2)
FRAG_EXPORT = dict(width=64, height=32, fps=10, time=0.2)
RAMP_FRAG = """
    void main() {
        GetCamera(iCamera);
        fragColor = vec4(astuv.x, astuv.y, 0.5 + 0.5*sin(iTime), 1.0);
    }
"""


class Meta:
    """A texture's sampler state, as ShaderTexture carries it."""

    def __init__(self, linear=True, repeat=True):
        self.linear = linear
        self.repeat_x = repeat
        self.repeat_y = repeat
        self.mipmaps = False


def textures(kind: str) -> tuple[dict, dict]:
    """Texture boxes (T, L, H, W, C) float32 and their sampler state."""
    if kind == "ramp":
        data = np.zeros((4, 8, 4), np.float32)
        data[..., 0] = np.arange(8, dtype=np.float32) / 8.0   # red ramp over x
        data[0, :, 1] = 1.0                                     # top row green
        return {"iTex": data[None, None]}, {"iTex": Meta(linear=False)}
    if kind == "temporal":
        data = np.zeros((2, 1, 4, 8, 4), np.float32)
        data[0, 0, ..., 0] = 0.25   # newest frame red
        data[1, 0, ..., 0] = 0.75   # previous frame red
        rng = np.random.default_rng(5)
        data[..., 1] = rng.random((2, 1, 4, 8), np.float32)
        return {"iScreen": data}, {"iScreen": Meta()}
    if kind == "flat":
        data = np.full((4, 8, 4), 0.5, np.float32)
        data[..., 2] = np.random.default_rng(6).random((4, 8), np.float32)
        return {"iTex": data[None, None]}, {"iTex": Meta()}
    return {}, {}


def uniforms() -> dict:
    return {"iResolution": np.array([W, H], np.float32),
            "iTime": np.float32(TIME),
            "iWantAspect": np.float32(W / H),
            "iFrame": np.int32(3)}


STATICS = {"iLayer": 0, "iQualityS": 0.5}

# name -> (source, textures, tolerance "exact" or "ulps")
SOURCES = {
    "arithmetic_constructors": ("""
        void main() {
            float x = astuv.x;
            vec3 c = vec3(x*x + 0.5, 2.0/4.0, mod(3.0, 2.0));
            fragColor = vec4(c, 1.0);
        }""", None, "exact"),
    "swizzle_compound_assign": ("""
        void main() {
            vec4 c = vec4(0);
            c.xy = astuv;
            c.zw = c.yx * 2;
            c.x += 1;
            fragColor = c;
        }""", None, "exact"),
    "duplicated_swizzle_index": ("""
        void main() {
            vec3 s = astuv.xyx;
            fragColor = vec4(s.z, s[1], astuv[0], 1.0);
        }""", None, "exact"),
    "matrix_column_major": ("""
        void main() {
            mat2 rot = mat2(0, 1, -1, 0);
            vec2 r = rot * astuv;
            fragColor = vec4(r, 0, 1);
        }""", None, "exact"),
    "matrix_products": ("""
        void main() {
            mat2 m = mat2(astuv.x, astuv.y * 0.5, -astuv.x, astuv.y);
            mat2 n = m * mat2(1.5, 0.0, 0.25, 2.0) * 0.5;
            vec2 a = n * astuv;
            vec2 b = astuv * n;
            fragColor = vec4(a, b);
        }""", None, "exact"),
    "ternary_per_pixel": ("""
        void main() {
            float v = (astuv.x < 0.5) ? 1.0 : 0.25;
            fragColor = vec4(v, 0, 0, 1);
        }""", None, "exact"),
    "define_and_comments": ("""
        /* block comment
           #define NOPE 9 */
        #define K 0.25   // trailing comment
        #define TWO_K (K + K)
        void main() {
            fragColor = vec4(K, TWO_K, 0, 1); // line comment
        }""", None, "exact"),
    "int_float_interop": ("""
        void main() {
            int n = 3;
            float x = n / 2;        // int division = 1
            float y = n / 2.0;      // float division = 1.5
            fragColor = vec4(x, y, float(n), 1);
        }""", None, "exact"),
    "int_division_remainder": ("""
        void main() {
            int a = int(astuv.x * 10.0) - 4;
            int q = a / 3;
            int r = a % 3;
            int pq = -7 / 2;
            int pr = -7 % 3;
            float f = mod(astuv.x * 7.0 - 3.0, 2.0) + float(iFrame / 2) + float(iFrame % 2);
            fragColor = vec4(float(q), float(r), float(pq) + float(pr) * 10.0, f / 3.0);
        }""", None, "exact"),
    "if_else_mask_merge": ("""
        void main() {
            fragColor = vec4(0, 0, 0, 1);
            if (astuv.x < 0.5) {
                fragColor.r = 1.0;
            } else {
                fragColor.g = 1.0;
            }
        }""", None, "exact"),
    "uniform_condition": ("""
        void main() {
            float t = iTime * 2.0;
            fragColor = vec4(astuv, 0, 1);
            if (iTime > 0.5) { fragColor.b = t / 3.0; } else { fragColor.r = 1.0; }
            if (iTime > 2.0) { fragColor.g = 1.0; }
        }""", None, "exact"),
    "early_return_divergent": ("""
        void main() {
            fragColor = vec4(0, 0, 0, 1);
            if (astuv.x < 0.5) { fragColor.r = 1.0; return; }
            fragColor.g = 1.0;
        }""", None, "exact"),
    "for_per_pixel_break": ("""
        void main() {
            int n = int(astuv.x * 10);
            int count = 0;
            for (int i = 0; i < 10; i++) {
                if (i >= n) break;
                count++;
            }
            fragColor = vec4(float(count) / 10.0, 0, 0, 1);
        }""", None, "exact"),
    "for_continue_rejoins_step": ("""
        void main() {
            int k = int(astuv.x * 4);
            int sum = 0;
            for (int i = 0; i < 4; i++) {
                if (i == k) continue;
                sum += i;
            }
            fragColor = vec4(float(sum) / 8.0, 0, 0, 1);
        }""", None, "exact"),
    "nested_inner_break": ("""
        void main() {
            int k = int(astuv.x * 3);
            int total = 0;
            for (int i = 0; i < 3; i++) {
                for (int j = 0; j < 5; j++) {
                    if (j > k) break;
                    total += 1;
                }
            }
            fragColor = vec4(float(total) / 16.0, 0, 0, 1);
        }""", None, "exact"),
    "outer_continue_inner_loop": ("""
        void main() {
            int k = int(astuv.x * 3);
            int total = 0;
            for (int i = 0; i < 3; i++) {
                if (i == k) continue;
                for (int j = 0; j < 2; j++) { total += 1; }
            }
            fragColor = vec4(float(total) / 8.0, 0, 0, 1);
        }""", None, "exact"),
    "return_inside_loop": ("""
        void main() {
            fragColor = vec4(0, 0, 0, 1);
            int n = int(astuv.x * 4);
            for (int i = 0; i < 4; i++) {
                if (i == n) { fragColor.r = float(i) / 4.0; return; }
            }
            fragColor.g = 1.0;
        }""", None, "exact"),
    "while_uniform_condition": ("""
        void main() {
            float x = 1.0;
            int n = 0;
            while (n < 5) { x *= 2.0; n++; }
            fragColor = vec4(x / 32.0, 0, 0, 1);
        }""", None, "exact"),
    "float_counter_local_bound": ("""
        void main() {
            float quality = 4;
            float total = 0;
            for (float walk = 1.0/quality; walk <= 1.001; walk += 1.0/quality) {
                total += walk;
            }
            fragColor = vec4(total / 2.5, 0, 0, 1);
        }""", None, "exact"),
    "lowered_per_pixel_break": ("""
        void main() {
            int n = int(astuv.x * 40);
            int count = 0;
            for (int i = 0; i < 40; i++) {
                if (i >= n) break;
                count++;
            }
            fragColor = vec4(float(count) / 40.0, 0, 0, 1);
        }""", None, "exact"),
    "lowered_data_dependent_while": ("""
        void main() {
            float x = astuv.x;
            int n = 0;
            while (x < 0.9) { x += 0.1; n++; }
            fragColor = vec4(float(n) / 16.0, x, 0, 1);
        }""", None, "exact"),
    "lowered_return_continue": ("""
        void main() {
            fragColor = vec4(0, 0, 0, 1);
            int k = int(astuv.x * 50);
            int sum = 0;
            for (int i = 0; i < 50; i++) {
                if (i == 7) continue;
                if (i == k) { fragColor.g = 1.0; return; }
                sum += 1;
            }
            fragColor.r = float(sum) / 49.0;
        }""", None, "exact"),
    "lowered_escape_iteration": ("""
        void main() {
            vec2 c = vec2(astuv.x * 0.5 - 1.5, astuv.y * 0.2);
            vec2 z = vec2(0);
            int n = 0;
            for (int i = 0; i < 64; i++) {
                if (dot(z, z) > 4.0) break;
                z = vec2(z.x*z.x - z.y*z.y, 2.0*z.x*z.y) + c;
                n++;
            }
            fragColor = vec4(float(n) / 64.0, 0, 0, 1);
        }""", None, "exact"),
    "lowered_cap_hit": ("""
        void main() {
            float x = astuv.x;
            for (int i = 0; i < 41; i++) { x = x * 0.97 + 0.01; }
            fragColor = vec4(x, 0, 0, 1);
        }""", None, "exact"),
    "user_function_divergent_return": ("""
        float pick(float x) {
            if (x < 0.5) return 1.0;
            return 2.0;
        }
        void main() {
            fragColor = vec4(pick(astuv.x) / 2.0, 0, 0, 1);
        }""", None, "exact"),
    "const_array_dynamic_index": ("""
        const int table[4] = int[4](7, 1, 5, 3);
        void main() {
            int k = int(astuv.x * 4);
            fragColor = vec4(float(table[k]) / 7.0, 0, 0, 1);
        }""", None, "exact"),
    "discard": ("""
        void main() {
            fragColor = vec4(1);
            if (astuv.x < 0.5) discard;
        }""", None, "exact"),
    "texture_texel_fetch_size": ("""
        void main() {
            vec4 a = texture(iTex, astuv);
            vec4 b = texelFetch(iTex, ivec2(3, 3), 0);
            ivec2 size = textureSize(iTex);
            fragColor = vec4(a.r, b.g, float(size.x) / 8.0, 1.0);
        }""", "ramp", "exact"),
    "temporal_box_naming": ("""
        void main() {
            float now = texture(iScreen0x0, astuv).r;
            float before = texture(iScreen1x0, astuv).g;
            float also_before = iScreenTexture(1, 0, astuv).r;
            float alias = texture(iScreen1, astuv * 1.5).g;
            fragColor = vec4(now, before, also_before, alias);
        }""", "temporal", "exact"),
    "sampler_parameter": ("""
        vec4 fetch(sampler2D image, vec2 uv) {
            return texture(image, uv);
        }
        void main() { fragColor = fetch(iTex, astuv * 1.3 - 0.1); }""", "flat", "exact"),
    "builtins_arithmetic": ("""
        void main() {
            vec2 uv = astuv * 4.0 - 2.0;
            float a = min(uv.x, uv.y) + max(uv.x, 0.5) + clamp(uv.x, -0.5, 0.5);
            vec3 m = mix(vec3(0.1, 0.2, 0.3), vec3(uv, 1.0), astuv.y);
            float s = step(0.0, uv.x) + abs(uv.y) + sign(uv.x) + floor(uv.x)
                    + ceil(uv.y) + round(uv.x * 1.3) + trunc(uv.y * 1.7);
            vec3 x = cross(m, vec3(0.0, 1.0, 0.5));
            fragColor = vec4(a, s, dot(m, x), m.z / 3.0);
        }""", None, "exact"),
    "builtins_transcendental": ("""
        void main() {
            vec2 uv = astuv * 2.0 - 1.0;
            float a = sin(uv.x * 3.0) + cos(uv.y * 2.0) + tan(uv.x * 0.5);
            float b = atan(uv.y, uv.x) + atan(uv.x) + asin(uv.x * 0.5) + acos(uv.y * 0.5);
            float c = exp(uv.x) + log(astuv.y + 0.5) + pow(astuv.x + 0.1, 0.25)
                    + sqrt(astuv.x) + inversesqrt(astuv.y + 0.1);
            float d = smoothstep(0.1, 0.9, astuv.x) + fract(uv.x * 3.3) + length(uv)
                    + distance(uv, vec2(0.3, 0.1));
            vec3 p = palette(astuv.x, vec3(0.5), vec3(0.5), vec3(1.0), vec3(0.0, 0.33, 0.67));
            vec3 h = hsv2rgb(vec3(astuv.x, 0.8, 0.9));
            float e = exp2(uv.y) + log2(astuv.x + 1.0) + sinh(uv.x) + cosh(uv.y)
                    + tanh(uv.x * 2.0);
            fragColor = vec4(a + b, c + d, e, dot(p, h));
        }""", None, "ulps"),
    "rotate2d": ("""
        void main() {
            vec2 r = rotate2d(iTime) * (astuv - 0.5);
            vec2 q = rotate2d(0.3) * astuv;
            fragColor = vec4(r, q);
        }""", None, "ulps"),
}

# (source, runs the fragment, message): GlslError in both front-ends
ERRORS = {
    "out_parameter": ("void f(out float x) { x = 1.0; } void main() {}", False, "out/inout"),
    "missing_main": ("float helper() { return 1.0; }", False, "main"),
    "syntax_error_line": ("void main()\n{\n    float x = @;\n}", False, ":3"),
    "unknown_identifier": ("void main() { fragColor = vec4(mystery); }", True, "mystery"),
    "loop_cannot_lower": ("""
        void main() {
            float x = astuv.x;
            float seen[2] = float[2](0.0, 0.0);
            int k = 0;
            while (x < 0.9) { seen[k] = x; k++; x += 0.1; }
            fragColor = vec4(x);
        }""", True, "data-dependent loop"),
}


JAX_SCRIPT = """
import sys
import jax
import jax.numpy as jnp
import numpy as np
import pytest
sys.path.insert(0, TESTS)
import test_torch_glsl as t
from test_torch_scene import _fix_reference_texture, _import_example
from shaderflow_tpu.glsl import compile_fragment
from shaderflow_tpu.scene import ShaderScene
from shaderflow_tpu.shader import Frag, finish_coords, make_coords
out = {}
for name, (source, kind, _) in t.SOURCES.items():
    main = compile_fragment(source)
    data, metas = t.textures(kind)
    def run(uniforms, data, main=main, metas=metas):
        coords = finish_coords(make_coords(t.H, t.W, t.W / t.H), uniforms["iResolution"])
        sf = Frag(coords=coords, uniforms=uniforms, statics=dict(t.STATICS), textures=data,
                  texture_meta=metas)
        color = main(sf)
        discard = sf._discard if sf._discard is not None else jnp.zeros((t.H, t.W), bool)
        return color, discard
    color, discard = jax.jit(run)(t.uniforms(), data)
    out[name] = np.asarray(color)
    out[name + "/discard"] = np.asarray(discard)
np.savez(OUT + "/sources.npz", **out)
_fix_reference_texture(pytest.MonkeyPatch())
_import_example("glsl", "glsl_demo").Plasma().main(output=OUT + "/plasma.rgb", **t.EXPORT)
(OUT_PATH / "ramp.frag").write_text(t.RAMP_FRAG)
class GlslRamp(ShaderScene):
    def build(self):
        self.shader.fragment = OUT_PATH / "ramp.frag"
GlslRamp().main(output=OUT + "/ramp.rgb", **t.FRAG_EXPORT)
"""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Thousands of small torch ops a frame: this file's tests run on one
    thread beside the other test workers (tests/test_torch_scenes.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Every source, the Plasma export and the .frag export through the JAX
    package, compiled, in a child on XLA:CPU capped at the AVX ISA."""
    tmp = tmp_path_factory.mktemp("glsl")
    script = (f"from pathlib import Path\nTESTS, OUT = {str(REPO / 'tests')!r}, {str(tmp)!r}\n"
              "OUT_PATH = Path(OUT)\n" + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stderr[-4000:]
    return tmp, dict(np.load(tmp / "sources.npz"))


def port_frag(kind=None) -> Frag:
    values = {name: torch.from_numpy(np.asarray(value)) for name, value in uniforms().items()}
    data, metas = textures(kind)
    return Frag(coords=finish_coords(make_coords(H, W, W / H), values["iResolution"]),
                uniforms=values, statics=dict(STATICS),
                textures={name: torch.from_numpy(box) for name, box in data.items()},
                texture_meta=metas)


def run_port(source: str, kind=None, sync_every=None):
    main = compile_fragment(source)
    if sync_every is not None:
        main.glsl_interpreter.sync_every = sync_every
    sf = port_frag(kind)
    color = main(sf)
    discard = sf._discard if sf._discard is not None else torch.zeros((H, W), dtype=torch.bool)
    return color.numpy(), discard.numpy(), main.glsl_interpreter.stats


def _ulps(got: np.ndarray, want: np.ndarray) -> float:
    scale = np.spacing(np.float32(np.max(np.abs(want))))
    return float(np.max(np.abs(got.astype(np.float64) - want.astype(np.float64))) / scale)


@pytest.mark.parametrize("name", sorted(SOURCES))
def test_source_matches_jax(reference, name):
    """Each source's (H, W, 4) color and discard mask, the port's against
    the compiled JAX front-end's: bit-equal, or within ULPS for the
    transcendental sources."""
    _, want = reference
    source, kind, tolerance = SOURCES[name]
    color, discard, _ = run_port(source, kind)
    assert color.shape == want[name].shape == (H, W, 4)
    assert color.dtype == np.float32
    np.testing.assert_array_equal(discard, want[name + "/discard"])
    if tolerance == "exact":
        np.testing.assert_array_equal(color, want[name])
    else:
        ulps = _ulps(color, want[name])
        print(f"{name}: {ulps:.2f} ulps of the largest output")
        assert ulps <= ULPS, f"{ulps:.2f} ulps"


@pytest.mark.parametrize("name", sorted(ERRORS))
def test_same_sources_raise_in_both(name):
    """Out parameters, a missing main and a syntax error (with its line)
    raise at compile time; an unknown identifier and a data-dependent loop
    that cannot run masked raise when the fragment runs; in both
    front-ends."""
    from shaderflow_tpu import glsl as jax_glsl
    from shaderflow_tpu.shader import Frag as JaxFrag
    from shaderflow_tpu.shader import finish_coords as jax_finish, make_coords as jax_coords
    source, runs, message = ERRORS[name]
    jax_sf = JaxFrag(coords=jax_finish(jax_coords(H, W, W / H), (W, H)),
                     uniforms=uniforms(), statics=dict(STATICS), textures={},
                     texture_meta={})
    for compile_, sf in ((jax_glsl.compile_fragment, jax_sf), (compile_fragment, port_frag())):
        with pytest.raises((GlslError, jax_glsl.GlslError), match=message) as raised:
            main = compile_(source)
            if runs:
                main(sf)
        assert type(raised.value).__name__ == "GlslError"


@pytest.mark.parametrize("name,k", [(name, k) for name in (
    "lowered_escape_iteration", "lowered_cap_hit", "lowered_data_dependent_while",
    "lowered_return_continue") for k in (2, 8)])
def test_sync_every_k_trips_matches_every_trip(name, k):
    """The masked loop reads `any(active)` on the host every k trips: the
    trips it runs after every lane stopped are masked, so every value is
    the one a read every trip gives, and it never runs past its cap (41
    trips in lowered_cap_hit, where every lane runs them all)."""
    source = SOURCES[name][0]
    color_1, discard_1, stats_1 = run_port(source, sync_every=1)
    color_k, discard_k, stats_k = run_port(source, sync_every=k)
    np.testing.assert_array_equal(color_k, color_1)
    np.testing.assert_array_equal(discard_k, discard_1)
    assert stats_1["lowered_loops"] == stats_k["lowered_loops"] == 1
    assert stats_1["trips"] <= stats_k["trips"] < stats_1["trips"] + k
    reads = -(-stats_k["trips"] // k)
    assert reads <= stats_k["syncs"] <= reads + 1   # + the read that finds no lane
    if name == "lowered_cap_hit":
        assert stats_1["trips"] == stats_k["trips"] == 41
    print(f"{name} k={k}: trips {stats_1['trips']} -> {stats_k['trips']}, "
          f"syncs {stats_1['syncs']} -> {stats_k['syncs']}")


def _u8_diff(got: np.ndarray, want: np.ndarray) -> tuple[int, float]:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(diff.max()), float((diff != 0).mean())


def test_plasma_export_matches_jax(reference, tmp_path):
    """examples/torch/torch_glsl_demo.py::Plasma at 96x54, 2x SSAA, two
    frames, against the JAX package's examples/glsl/glsl_demo.py::Plasma:
    at most one u8 step on < 1 % of values; the program is the GLSL
    interpreter, not the missing-texture fallback."""
    tmp, _ = reference
    scene = _import_example("torch", "torch_glsl_demo").Plasma()
    scene.main(output=str(tmp_path / "plasma.rgb"), device="cpu", **EXPORT)
    assert scene.shader.fragment is not missing_fragment
    assert getattr(scene.shader.fragment, "glsl_interpreter", None) is not None
    shape = (-1, EXPORT["height"], EXPORT["width"], 3)
    got = np.fromfile(tmp_path / "plasma.rgb", np.uint8).reshape(shape)
    want = np.fromfile(tmp / "plasma.rgb", np.uint8).reshape(shape)
    assert got.shape == want.shape == (2, *shape[1:])
    assert got.std() > 10
    steps, share = _u8_diff(got, want)
    print(f"Plasma 96x54 2x SSAA: max {steps} u8 steps on {share:.4%} of values")
    assert steps <= 1 and share < 0.01


def test_frag_file_export_matches_jax(reference, tmp_path):
    """A `.frag` file assigned to shader.fragment renders through the whole
    engine path (GetCamera, a uniform, the coordinate ramps) as the JAX
    package renders it."""
    from shaderflow_tpu_torch.scene import ShaderScene
    tmp, _ = reference
    frag = tmp_path / "ramp.frag"
    frag.write_text(RAMP_FRAG)

    class GlslRamp(ShaderScene):
        def build(self):
            self.shader.fragment = frag

    scene = GlslRamp()
    scene.main(output=str(tmp_path / "ramp.rgb"), device="cpu", **FRAG_EXPORT)
    assert getattr(scene.shader.fragment, "glsl_interpreter", None) is not None
    shape = (-1, FRAG_EXPORT["height"], FRAG_EXPORT["width"], 3)
    got = np.fromfile(tmp_path / "ramp.rgb", np.uint8).reshape(shape)
    want = np.fromfile(tmp / "ramp.rgb", np.uint8).reshape(shape)
    assert got.shape == want.shape == (2, *shape[1:])
    assert got[0, 0, -1, 0] > got[0, 0, 0, 0] and got[0, 0, 0, 1] > got[0, -1, 0, 1]
    steps, share = _u8_diff(got, want)
    print(f"ramp.frag 64x32: max {steps} u8 steps on {share:.4%} of values")
    assert steps <= 1 and share < 0.01


def test_program_sources_and_build_errors(tmp_path, monkeypatch):
    """ShaderProgram's fragment setter takes GLSL text, Python `def main(sf)`
    text or a path; unchanged source keeps its callable; a source that fails
    to build writes a report to the user log directory and resolves to the
    missing-texture program."""
    from shaderflow_tpu_torch.scene import ShaderScene
    for attribute in ("user_data_path", "user_log_path", "user_cache_path"):
        monkeypatch.setattr(shaderflow_tpu_torch.directories, attribute,
                            tmp_path / attribute)
    scene = ShaderScene()
    scene.initialize()
    glsl_source = "void main() { fragColor = vec4(astuv, 0.5, 1.0); }"
    scene.shader.fragment = glsl_source
    first = scene.shader.fragment
    assert first.glsl_interpreter is not None
    scene.shader.compile()
    assert scene.shader.fragment is first
    scene.shader.fragment = "def main(sf):\n    return sf.astuv\n"
    assert scene.shader.fragment.__name__ == "main" and not looks_like_glsl(
        "def main(sf):\n    return None\n")
    path = tmp_path / "broken.frag"
    path.write_text("void main() { float x = @; }")
    scene.shader.fragment = path
    assert scene.shader.fragment is missing_fragment
    reports = list((tmp_path / "user_log_path").glob("*-error.md"))
    assert len(reports) == 1 and "bad character" in reports[0].read_text()
    assert glsl.Interpreter.UNROLL_LIMIT == 32
