"""The bf16 tail mode (SHADERFLOW_TAIL_BF16=1) and the exact blur level
(SHADERFLOW_VIZ_BLUR_LEVEL=1) of the PyTorch port against the JAX package,
on the CPU. The JAX side runs its fused path (the Pallas kernel in
interpret mode, SHADERFLOW_TAILFUSE_INTERPRET=1) in a child on XLA:CPU
without FMA (--xla_cpu_max_isa=AVX), as tests/test_torch_visualizer.py and
tests/test_torch_piano.py run it; the port runs its plain versions (every
bf16 op computed in float32 and rounded, typed by JAX's promotion rules).

  * the visualizer at 128x72, 2x SSAA, 3 frames, blur levels 1 and 4, bf16:
    independently and with the JAX state carried across;
  * the same scene at 320x180, level 1, bf16, against tools/gl_oracle.py
    (tests/test_psnr_reference.py:153-206's bar, 40 dB);
  * the Mandelbrot, Julia and PianoRoll tails under bf16 at small sizes;
  * each of these scenes with its tail run eagerly on tensors (no tracer),
    near the JAX frames (tailfuse.EAGER_BF16_BAR);
  * one synthetic tail through both packages' K1 in process;
  * the tracer's bf16 typing, and the trace cache across the dtype flip.

`-s` prints the measured figures.
"""

import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from shaderflow_tpu.ops import tailfuse as jax_tailfuse
from shaderflow_tpu_torch.ops import tailfuse, tailgen
from test_torch_scene import _import_example
from test_torch_tailfuse import _assert_u8_close, _specs
from test_torch_visualizer import (HEIGHT, JAX_SCRIPT, WIDTH, _load_state, _read_rgb,
                                   _u8_stats, oracle_psnr)

REPO = Path(__file__).resolve().parent.parent
BF16_ENV = {"SHADERFLOW_TAIL_BF16": "1"}


def _jax_child(script: str, tmp: Path, **env) -> None:
    """Run `script` in a JAX child on XLA:CPU without FMA, the JAX
    package's fused path in interpret mode."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", SHADERFLOW_TAILFUSE_INTERPRET="1",
               HOME=str(tmp), **env)
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stderr[-4000:]


def _eager(eval_reference):
    """eval_reference with eager=True: the tail function run on tensors,
    not through the tracer (what chip_smoke.py holds K1's bf16 form to as
    well as the traced plain version)."""
    return lambda spec, height, width, aspect, eager=False: eval_reference(
        spec, height, width, aspect, eager=True)


def _check_eager(name: str, got: np.ndarray, want: np.ndarray) -> None:
    max_diff, share, psnr = _u8_stats(got, want)
    print(f"{name}: max {max_diff} u8 steps on {share:.4%}, PSNR {psnr:.2f} dB")
    steps, psnr_bar = tailfuse.EAGER_BF16_BAR
    assert max_diff <= steps and psnr >= psnr_bar, (max_diff, psnr)


def _check_parity(name: str, got: np.ndarray, want: np.ndarray, share_bar: float) -> None:
    """Target: bit-equal. Floor: at most one u8 step on < share_bar of the
    values (the JAX package's bar for the scene)."""
    assert got.shape == want.shape
    max_diff, share, psnr = _u8_stats(got, want)
    print(f"{name}: max {max_diff} u8 steps on {share:.4%}, PSNR {psnr:.2f} dB")
    assert max_diff <= 1 and share < share_bar, (max_diff, share)


# --------------------------------------------------------------------------- #
# The visualizer slice

@pytest.fixture(scope="module", params=[1, 4])
def visualizer_runs(request, tmp_path_factory):
    """The JAX fused export at bf16 and blur level `param`, then the port's:
    one independent, one with the JAX sequences and static fields carried
    across (engine.load_reference_state)."""
    level = request.param
    tmp = tmp_path_factory.mktemp(f"visualizer_bf16_level{level}")
    seconds = 0.3                              # 3 frames at 10 fps
    script = (f"TESTS, OUTPUT = {str(REPO / 'tests')!r}, {str(tmp / 'jax.rgb')!r}\n"
              f"STATE, UNIFORMS = {str(tmp / 'state.npz')!r}, {str(tmp / 'uniforms.npz')!r}\n"
              f"WIDTH, HEIGHT, FPS, SECONDS = {WIDTH}, {HEIGHT}, 10, {seconds}\n" + JAX_SCRIPT)
    env = dict(BF16_ENV, SHADERFLOW_VIZ_BLUR_LEVEL=str(level))
    _jax_child(script, tmp, **env)
    demo = _import_example("torch", "torch_demo")
    from shaderflow_tpu_torch.engine import load_reference_state
    with pytest.MonkeyPatch.context() as patch:
        for key, value in env.items():
            patch.setenv(key, value)
        assert demo.blur_level() == level and tailfuse.tail_dtype() == torch.bfloat16
        demo.Visualizer().main(width=WIDTH, height=HEIGHT, fps=10, ssaa=2, time=seconds,
                               output=str(tmp / "torch.rgb"), device="cpu")
        carried = demo.Visualizer()
        load_reference_state(carried, *_load_state(tmp / "state.npz"))
        carried.main(width=WIDTH, height=HEIGHT, fps=10, ssaa=2, time=seconds,
                     output=str(tmp / "carried.rgb"), device="cpu")
        patch.setattr(tailfuse, "eval_reference", _eager(tailfuse.eval_reference))
        demo.Visualizer().main(width=WIDTH, height=HEIGHT, fps=10, ssaa=2, time=seconds,
                               output=str(tmp / "eager.rgb"), device="cpu")
    return dict(level=level, jax=_read_rgb(tmp / "jax.rgb"), torch=_read_rgb(tmp / "torch.rgb"),
                carried=_read_rgb(tmp / "carried.rgb"), eager=_read_rgb(tmp / "eager.rgb"))


@pytest.mark.parametrize("run", ["independent", "carried"])
def test_visualizer_bf16_matches_jax(visualizer_runs, run):
    """Frames of the bf16 visualizer at blur levels 1 and 4 against the JAX
    package's fused path: target bit-equal (measured: 0 u8 steps at both
    levels, both runs); floor: one u8 step on < 2 % of values, the JAX
    package's bar for this scene (tests/test_tailfuse.py:128-130)."""
    want = visualizer_runs["jax"]
    got = visualizer_runs["torch" if run == "independent" else "carried"]
    assert got.shape == (3, HEIGHT, WIDTH, 3) and got.std() > 10
    _check_parity(f"visualizer bf16 level {visualizer_runs['level']} {run}", got, want, 0.02)


def test_visualizer_bf16_eager_near_jax(visualizer_runs):
    """The tail function run eagerly on bf16 tensors (no tracer; 0-d
    scalars as (1, 1) tensors, so torch promotes as JAX does) against the
    JAX fused path. Torch rounds every bf16 op, the reference not where an
    upcast reads the value (an output included), so this path sits a step
    or two away: tailfuse.EAGER_BF16_BAR (max u8 steps, min PSNR), the
    bar chip_smoke.py holds K1's bf16 form to against it on the card."""
    got, want = visualizer_runs["eager"], visualizer_runs["jax"]
    assert got.shape == want.shape == (3, HEIGHT, WIDTH, 3) and got.std() > 10
    _check_eager(f"visualizer bf16 level {visualizer_runs['level']} eager", got, want)


def test_visualizer_bf16_level1_psnr_against_oracle(monkeypatch, tmp_path):
    """The port's visualizer at 320x180 (ssaa=1, subsample=1, 3 frames at
    10 fps), bf16
    tail, blur level 1, against the pointwise GLSL transcription
    (tools/gl_oracle.py): >= 40 dB per frame, the bar
    tests/test_psnr_reference.py:153-206 holds the JAX package to in this
    mode, on a frame with live audio."""
    values = oracle_psnr(monkeypatch, tmp_path, dict(BF16_ENV, SHADERFLOW_VIZ_BLUR_LEVEL="1"))
    for index, value in enumerate(values):
        print(f"visualizer bf16 level 1 frame {index}: {value:.2f} dB against the oracle")
        assert value >= 40.0, f"frame {index}: PSNR {value:.1f} dB < 40"


# --------------------------------------------------------------------------- #
# The other ported tails under bf16

SCENES_SCRIPT = """
import sys, pytest
sys.path.insert(0, TESTS)
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())
fractals = _import_example("fractals", "fractals")
for name in ("Mandelbrot", "Julia"):
    getattr(fractals, name)().main(width=96, height=54, fps=10, ssaa=2, time=0.3,
                                   output=f"{OUT}/jax_{name}.rgb")
_import_example("basic", "piano_roll").PianoRoll().main(
    width=96, height=54, fps=10, ssaa=1, time=0.3, output=f"{OUT}/jax_PianoRoll.rgb")
"""


@pytest.fixture(scope="module")
def scene_runs(tmp_path_factory):
    """Mandelbrot and Julia (96x54, 2x SSAA) and PianoRoll (96x54, ssaa=1:
    K1's bf16 planes, then the bf16 stencil), 3 frames each, bf16, from
    both packages."""
    tmp = tmp_path_factory.mktemp("scenes_bf16")
    _jax_child(f"TESTS, OUT = {str(REPO / 'tests')!r}, {str(tmp)!r}\n" + SCENES_SCRIPT, tmp,
               **BF16_ENV)
    fractals = _import_example("torch", "torch_fractals")
    piano = _import_example("torch", "torch_piano_roll")
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("SHADERFLOW_TAIL_BF16", "1")
        for name in ("Mandelbrot", "Julia"):
            getattr(fractals, name)().main(width=96, height=54, fps=10, ssaa=2, time=0.3,
                                           output=str(tmp / f"torch_{name}.rgb"), device="cpu")
        piano.PianoRoll().main(width=96, height=54, fps=10, ssaa=1, time=0.3,
                               output=str(tmp / "torch_PianoRoll.rgb"), device="cpu")
        patch.setattr(tailfuse, "eval_reference", _eager(tailfuse.eval_reference))
        for name in ("Mandelbrot", "Julia"):
            getattr(fractals, name)().main(width=96, height=54, fps=10, ssaa=2, time=0.3,
                                           output=str(tmp / f"eager_{name}.rgb"), device="cpu")
        piano.PianoRoll().main(width=96, height=54, fps=10, ssaa=1, time=0.3,
                               output=str(tmp / "eager_PianoRoll.rgb"), device="cpu")
    read = lambda path: np.fromfile(path, np.uint8).reshape(-1, 54, 96, 3)
    return {name: (read(tmp / f"torch_{name}.rgb"), read(tmp / f"jax_{name}.rgb"),
                   read(tmp / f"eager_{name}.rgb"))
            for name in ("Mandelbrot", "Julia", "PianoRoll")}


@pytest.mark.parametrize("name", ["Mandelbrot", "Julia", "PianoRoll"])
def test_scene_tails_bf16_match_jax(scene_runs, name):
    """The fractal tails read the escape counts in the color dtype (counts
    above 256 round in bf16, as the reference's do); PianoRoll's tail feeds
    K1's bf16 planes. Target bit-equal (measured: 0 u8 steps for all
    three); floor: one u8 step on < 1 %, the JAX package's fused-kernel
    bar (tests/test_tailfuse.py:56-60)."""
    got, want, _ = scene_runs[name]
    assert got.shape == want.shape == (3, 54, 96, 3) and got.std() > 0
    _check_parity(f"{name} bf16", got, want, 0.01)


@pytest.mark.parametrize("name", ["Mandelbrot", "Julia", "PianoRoll"])
def test_scene_tails_bf16_eager_near_jax(scene_runs, name):
    """The same tails run eagerly on bf16 tensors (no tracer) against the
    JAX fused path: within tailfuse.EAGER_BF16_BAR (see
    test_visualizer_bf16_eager_near_jax)."""
    _, want, got = scene_runs[name]
    assert got.shape == want.shape and got.std() > 0
    _check_eager(f"{name} bf16 eager", got, want)


# --------------------------------------------------------------------------- #
# K1's bf16 form on one synthetic tail, and the tracer

@pytest.mark.parametrize("out_h,out_w,subsample", [(48, 128, 2), (30, 100, 1)])
def test_plain_k1_bf16_matches_jax(monkeypatch, out_h, out_w, subsample):
    """tests/test_tailfuse.py's tail (planes, a row, a column, a 0-d float32
    scalar that promotes the bf16 chain back to float32, coordinates,
    selects) under bf16, through the port's K1 on CPU tensors (its plain
    version) and the JAX fused kernel in interpret mode in process (FMA
    contraction allowed there): one u8 step on < 1 %."""
    monkeypatch.setenv("SHADERFLOW_TAIL_BF16", "1")
    render_h, render_w = out_h * subsample, out_w * subsample
    aspect = out_w / out_h
    jax_spec, spec = _specs(render_h, render_w)
    got = tailfuse.fused_tail_final(spec, render_h, render_w, out_h, out_w, subsample, aspect)
    fused = jax_tailfuse.fused_tail_final(jax_spec, render_h, render_w, out_h, out_w,
                                          subsample, aspect, interpret=True)
    _assert_u8_close(got.numpy(), fused)


# The types JAX gives the values _typing_spec's tail computes
JAX_TYPES = dict(weak=torch.bfloat16, strong=torch.float32, select=torch.bfloat16,
                 cast=torch.bfloat16, geometry=torch.float32)


def _typing_spec():
    """A tail that records the dtype of each value JAX_TYPES names -> (its
    spec on (4, 8) planes and a 0-d float32 scalar, the record)."""
    seen = {}

    def tail(tp):
        c = tp.plane("c")
        seen.update(weak=(c * 0.5).dtype, strong=(c * tp.scalar("s")).dtype,
                    select=torch.where(tp.plane("g", dtype=torch.float32) > 0.5, 0.25, c).dtype,
                    cast=tp.f(tp.plane("g", dtype=torch.float32) * 2.0).dtype,
                    geometry=tp.plane("g", dtype=torch.float32).dtype)
        return c, c, c

    return tailfuse.make_spec(tail, 4, 8, c=torch.ones((4, 8)), g=torch.ones((4, 8)),
                              s=torch.tensor(2.0)), seen


def test_tracer_types_as_jax(monkeypatch):
    """The tracer's value kinds follow JAX's promotion: a bf16 plane times a
    Python number stays bf16; times a 0-d float32 scalar (strong) it becomes
    float32 (torch alone would keep bf16_tensor * f32_0d_tensor in bf16);
    torch.where of a Python number and a bf16 value is bf16; tp.f casts
    into the color dtype; geometry planes read with dtype=float32 stay
    float32."""
    monkeypatch.setenv("SHADERFLOW_TAIL_BF16", "1")
    spec, seen = _typing_spec()
    tailgen.trace(spec, 4, 8, 2.0)
    assert seen == JAX_TYPES
    # The same program as JAX compiles it (under jit, as its render runs):
    # the cast of the plane rounds for every reader; c * 0.3 rounds where a
    # bf16 op reads it, but its upcasts (the float32 product with g, the
    # output) read the unrounded float32 value: XLA drops the convert pair
    # it added around the bf16 op, and keeps the explicit one
    def program(float32):
        def tail(tp):
            c, g = tp.plane("c"), tp.plane("g", dtype=float32)
            return c * tp.scalar("s"), c * 0.3, (c * 0.3) * g + c * c
        return tail

    rng = np.random.default_rng(3)
    c, g = (rng.uniform(0.5, 4.0, (4, 8)).astype(np.float32) for _ in range(2))
    want = jax.jit(lambda c, g, s: jax_tailfuse.eval_reference(
        jax_tailfuse.make_spec(program(jnp.float32), 4, 8, c=c, g=g, s=s), 4, 8, 2.0))(
            c, g, np.float32(2.7))
    got = tailfuse.eval_reference(tailfuse.make_spec(
        program(torch.float32), 4, 8, c=torch.from_numpy(c), g=torch.from_numpy(g),
        s=torch.tensor(2.7)), 4, 8, 2.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_eager_tail_types_as_jax(monkeypatch):
    """eval_reference(eager=True) runs the tail on tensors with the 0-d
    scalars as (1, 1) tensors: torch then types each value as the tracer
    and JAX do (a bf16 plane times a float32 scalar is float32)."""
    monkeypatch.setenv("SHADERFLOW_TAIL_BF16", "1")
    spec, seen = _typing_spec()
    tailfuse.eval_reference(spec, 4, 8, 2.0, eager=True)
    assert seen == JAX_TYPES


def _cached_tail(tp):
    """A tail with no closure: K1's trace cache keys it."""
    c = tp.plane("c")
    return c * 0.5, c + 0.25, c * c


def test_trace_cache_keeps_dtypes_apart(monkeypatch):
    """K1's trace cache (tailgen.compiled) holds the color dtype in its key:
    after SHADERFLOW_TAIL_BF16 flips, the same tail is traced and compiled
    again (with bf16 rounding) instead of reusing the float32 kernel, and
    flipping back reuses the first."""
    from shaderflow_tpu_torch import build
    sources = []

    def fake_module(source, stem="tail"):
        sources.append(source)
        return SimpleNamespace(tail_kernel=len(sources))

    monkeypatch.setattr(build, "triton_module", fake_module)
    monkeypatch.setattr(tailgen, "_PREPARED", {})
    spec = tailfuse.make_spec(_cached_tail, 16, 32, c=torch.ones((16, 32)))
    args = (spec, 16, 32, 2, 2.0, True, torch.device("cpu"))
    monkeypatch.delenv("SHADERFLOW_TAIL_BF16", raising=False)
    f32 = tailgen.compiled(*args)
    monkeypatch.setenv("SHADERFLOW_TAIL_BF16", "1")
    bf16 = tailgen.compiled(*args)
    monkeypatch.delenv("SHADERFLOW_TAIL_BF16")
    again = tailgen.compiled(*args)
    assert (f32[1], bf16[1], again[1]) == (1, 2, 1)
    assert "tl.bfloat16" not in sources[0] and "tl.bfloat16" in sources[1]
