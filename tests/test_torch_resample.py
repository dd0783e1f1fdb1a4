"""The general supersampling path of the PyTorch port against the JAX
package, on the CPU: the banded separable resampler
(ops/sampling.py resample_separable_blocked, sample_separable_planes and
its banded form), the general branch of the final pass
(ops/downsample.py), the tail's final pass in that regime
(ops/tailfuse.py run_tail_final: the plain tail, no kernel K1), and the
scenes that reach it: the music visualizer at ssaa 1.5, Mandelbrot at
ssaa 3 and 0.75 (the export's freewheel resize), Basic through the
command line at -s 4, and a realtime Mandelbrot at ssaa 0.5 frame by
frame.

Bars: float32 within 3e-6 of the JAX function (its own bar against the
dense band product, tests/test_downsample.py); u8 frames at most one step
on < 1 % of values (the visualizer < 2 %). The JAX scenes run in a child
interpreter on XLA:CPU capped at the AVX ISA, as tests/test_torch_scene.py
runs them."""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_scene import _import_example

from shaderflow_tpu.ops import downsample as jax_downsample
from shaderflow_tpu.ops import sampling as jax_sampling
from shaderflow_tpu_torch.ops import downsample, sampling, tailfuse

REPO = Path(__file__).resolve().parent.parent
WIDTH, HEIGHT, FPS = 96, 54, 10
ATOL = 3e-6
# (render height, render width, out height, out width, subsample): ssaa
# 0.75, 1.5, 3 with subsample 2, and 4 with subsample 3
GENERAL = [(36, 48, 48, 64, 2), (81, 144, 54, 96, 2), (162, 288, 54, 96, 2),
           (216, 384, 54, 96, 3)]
GENERAL_IDS = ["ssaa0.75", "ssaa1.5", "ssaa3", "ssaa4-s3"]


def _u8_stats(got, want):
    diff = np.abs(np.asarray(got).astype(np.int16) - np.asarray(want).astype(np.int16))
    return int(diff.max()), float((diff != 0).mean())


def _tap_positions(rng, taps, out_len, n, scale, offset):
    """(taps, out_len) monotone positions: an affine map with a tap spread."""
    base = np.arange(out_len, dtype=np.float32) * scale + offset
    spread = (np.arange(taps, dtype=np.float32)[:, None] - (taps - 1) / 2) * scale / taps
    jitter = rng.uniform(-0.01, 0.01, (1, out_len)).astype(np.float32)
    return (base[None, :] + spread + jitter).astype(np.float32)


RESAMPLE_CASES = {
    # 2x upsampling of a 300x260 texture (windows of 128 < 300 texels)
    "upsample2x-windows": dict(shape=(300, 260, 3), out=(600, 520), scale=0.5, taps=2,
                               block=240),
    # 3x minification in blocks of 64 outputs
    "minify-block64": dict(shape=(480, 420, 4), out=(160, 140), scale=3.0, taps=3,
                           block=64),
    # windows that would cover the texture: the dense products
    "dense": dict(shape=(70, 90, 3), out=(35, 45), scale=2.0, taps=2, block=240),
}


@pytest.mark.parametrize("case", sorted(RESAMPLE_CASES))
def test_resample_separable_blocked_matches_jax(case):
    """resample_separable_blocked against the JAX function on the same
    seeded texture and tap positions: float32 within 3e-6."""
    spec = RESAMPLE_CASES[case]
    rng = np.random.default_rng(len(case))
    data = rng.random(spec["shape"], np.float32)
    out_h, out_w = spec["out"]
    scale = spec["scale"]
    pos_rows = _tap_positions(rng, spec["taps"], out_h, spec["shape"][0], scale, scale / 2 - 0.5)
    pos_cols = _tap_positions(rng, spec["taps"], out_w, spec["shape"][1], scale, scale / 2 - 0.5)
    bound = scale * (1.0 + 1.0 / spec["taps"]) + 0.05
    got = sampling.resample_separable_blocked(
        torch.from_numpy(data), torch.from_numpy(pos_rows), torch.from_numpy(pos_cols),
        bound, bound, block=spec["block"]).numpy()
    want = np.asarray(jax_sampling.resample_separable_blocked(
        jnp.asarray(data), jnp.asarray(pos_rows), jnp.asarray(pos_cols), bound, bound,
        block=spec["block"]))
    plan = sampling.resample_plan(pos_rows, pos_cols, *spec["shape"][:2], bound, bound,
                                  "cpu", spec["block"])
    assert (plan.row_offsets is None) == (case == "dense")
    assert got.shape == want.shape == (out_h, out_w, spec["shape"][2])
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("blocked", [False, True], ids=["dense", "banded"])
@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
def test_sample_separable_planes_matches_jax(blocked, precision):
    """sample_separable_planes and its banded form against the JAX
    functions: a 2.5x zoom into a 400x360 texture (its windows engaged),
    float32 within 3e-6; bfloat16 operands within a bf16 step of the
    value (the rounding points agree, the sums' order differs)."""
    rng = np.random.default_rng(3)
    data = rng.random((400, 360, 3), np.float32)
    u = (0.1 + (np.arange(300, dtype=np.float32) + 0.5) / 300 * 0.4).astype(np.float32)
    v = (0.9 - (np.arange(250, dtype=np.float32) + 0.5) / 250 * 0.4).astype(np.float32)
    args = (u, v)
    if blocked:
        got = sampling.sample_separable_planes_blocked(
            sampling.Sampler2D(torch.from_numpy(data), repeat_x=False, repeat_y=False),
            *map(torch.from_numpy, args), (0.5, 0.7), precision=precision)
        want = jax_sampling.sample_separable_planes_blocked(
            jax_sampling.Sampler2D(jnp.asarray(data), repeat_x=False, repeat_y=False),
            *map(jnp.asarray, args), (0.5, 0.7), precision=precision)
    else:
        got = sampling.sample_separable_planes(
            sampling.Sampler2D(torch.from_numpy(data)), *map(torch.from_numpy, args),
            precision=precision)
        want = jax_sampling.sample_separable_planes(
            jax_sampling.Sampler2D(jnp.asarray(data)), *map(jnp.asarray, args),
            precision=precision)
    atol = ATOL if precision == "float32" else 2.0 ** -7
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (250, 300)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=atol)


@pytest.mark.parametrize("sizes", GENERAL, ids=GENERAL_IDS)
def test_ssaa_downsample_general_matches_jax(sizes):
    """The general branch of ssaa_downsample (render neither the output
    nor the output times the subsample) against the JAX function: float32
    within 3e-6 on a seeded RGBA render."""
    rh, rw, oh, ow, s = sizes
    render = np.random.default_rng(rh).random((rh, rw, 4), np.float32)
    got = downsample.ssaa_downsample(torch.from_numpy(render), oh, ow, s).numpy()
    want = np.asarray(jax_downsample.ssaa_downsample(jnp.asarray(render), oh, ow, s))
    assert got.shape == want.shape == (oh, ow, 3)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("sizes", GENERAL, ids=GENERAL_IDS)
def test_final_pass_general_matches_jax(sizes):
    """final_pass in the general regime: u8 at most one step on < 1 % of
    values (a summation-order tie at a rounding boundary)."""
    rh, rw, oh, ow, s = sizes
    render = np.random.default_rng(rw).random((rh, rw, 4), np.float32)
    got = downsample.final_pass(torch.from_numpy(render), oh, ow, s).numpy()
    want = np.asarray(jax_downsample.final_pass(jnp.asarray(render), oh, ow, s))
    assert got.shape == want.shape == (oh, ow, 3) and got.dtype == np.uint8
    worst, share = _u8_stats(got, want)
    assert worst <= 1 and share < 0.01


def test_general_plan_is_made_once():
    """The general path's weights depend on the sizes only: one plan per
    configuration and device, reused by every frame."""
    render = torch.rand(81, 144, 3)
    downsample.ssaa_downsample(render, 54, 96, 2)
    plan = downsample._general_plan(81, 144, 54, 96, 2, render.device)
    downsample.ssaa_downsample(render, 54, 96, 2)
    assert downsample._general_plan(81, 144, 54, 96, 2, render.device) is plan


def test_run_tail_final_general_regime_is_the_plain_tail():
    """run_tail_final at ssaa 1.5 (render 144x81 -> 96x54, subsample 2)
    evaluates the tail with eval_reference and runs the general final pass,
    as the JAX package does on every backend: equal to tail_plain, and
    kernel K1 is not launched."""
    rng = np.random.default_rng(9)
    plane = torch.from_numpy(rng.random((81, 144), np.float32))
    spec = tailfuse.make_spec(lambda tp: (tp.plane("a"), tp.plane("a") * 0.5, 1.0 - tp.plane("a")),
                              81, 144, a=plane)
    before = (tailfuse.fused_tail_final.launches, tailfuse.fused_tail_final.planes_launches)
    out = torch.empty((54, 96, 3), dtype=torch.uint8)
    tailfuse.run_tail_final(spec, 81, 144, 54, 96, 2, 96 / 54, out=out)
    assert torch.equal(out, tailfuse.tail_plain(spec, 81, 144, 54, 96, 2, 96 / 54))
    assert (tailfuse.fused_tail_final.launches,
            tailfuse.fused_tail_final.planes_launches) == before
    assert not tailfuse.supports_fusion(81, 144, 54, 96, 2)


# --------------------------------------------------------------------------- #
# The scenes, against the JAX package in one AVX child

EXPORTS = {
    # name -> (example module, class, options)
    "visualizer-1.5": ("demo", "Visualizer", dict(ssaa=1.5, time=0.3)),
    "mandelbrot-3": ("fractals", "Mandelbrot", dict(ssaa=3, time=0.3)),
    "mandelbrot-0.75": ("fractals", "Mandelbrot", dict(ssaa=0.75, time=0.3)),
    "mandelbrot-raw": ("fractals", "Mandelbrot", dict(ssaa=2, raw=True, time=0.3)),
}
REALTIME_FRAMES = 4

JAX_SCRIPT = """
import os, sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
os.environ["SHADERFLOW_AUDIO_BACKEND"] = "none"
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())
from shaderflow_tpu.scene import WindowBackend
modules = {"demo": _import_example("basic", "demo"),
           "fractals": _import_example("fractals", "fractals")}
results = {}
for name, (module, cls, options) in EXPORTS.items():
    out = os.path.join(TMP, name + ".rgb")
    scene = getattr(modules[module], cls)()
    # ssaa < 1 and raw export at equal resolution, subsample 2: the fused
    # path (bf16 planes, the bf16 stencil), as the port runs it
    equal = options["ssaa"] < 1 or options.get("raw")
    os.environ["SHADERFLOW_TAILFUSE_INTERPRET"] = "1" if equal else "0"
    scene.main(width=WIDTH, height=HEIGHT, fps=FPS, output=out, **options)
    results["export/" + name] = np.fromfile(out, np.uint8)
os.environ["SHADERFLOW_TAILFUSE_INTERPRET"] = "0"
from shaderflow_tpu.cli import launch
out = os.path.join(TMP, "basic-4.rgb")
launch([modules["demo"].Basic], ["Basic", "main", "-w", str(WIDTH), "-h", str(HEIGHT),
                                 "-f", str(FPS), "-t", "0.3", "-s", "4", "-o", out])
results["export/basic-4"] = np.fromfile(out, np.uint8)
scene = modules["fractals"].Mandelbrot(backend=WindowBackend.Headless)
scene._setup_run(width=WIDTH, height=HEIGHT, fps=60, ssaa=0.5)
for k in range(FRAMES_RT):
    scene.engine.begin_batch()
    scene.next(dt=1.0 / 60.0)
    results[f"realtime/{k}"] = np.asarray(scene.engine.flush(1))[0]
np.savez(OUTPUT, **results)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("general")
    script = (f"TESTS, TMP, OUTPUT = {str(REPO / 'tests')!r}, {str(tmp)!r}, "
              f"{str(tmp / 'jax.npz')!r}\n"
              f"WIDTH, HEIGHT, FPS, FRAMES_RT = {WIDTH}, {HEIGHT}, {FPS}, {REALTIME_FRAMES}\n"
              f"EXPORTS = {EXPORTS!r}\n" + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp), WINDOW_BACKEND="headless")
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stderr[-4000:]
    return dict(np.load(tmp / "jax.npz"))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Beside the other test workers, torch's intra-op threads spin against
    theirs: this file's tests run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", sorted(EXPORTS))
def test_general_ssaa_scene_matches_jax(reference, tmp_path, monkeypatch, name):
    """The visualizer at ssaa 1.5 (render 144x81, kernel K2's bar field at
    render size, the tail through the plain path) and Mandelbrot at ssaa 3
    (render 288x162), 0.75 and 2 with raw=True (an export at ssaa < 1 or
    raw renders and writes 72x40 / 192x108 frames: the freewheel resize,
    scene.py; then the equal-resolution
    regime at subsample 2, held against the JAX package's fused path, the
    Pallas kernel in interpret mode, as tests/test_torch_piano.py holds
    PianoRoll) against the JAX package: the same bytes count, at most one
    u8 step on < 1 % of values (the visualizer < 2 %)."""
    monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", "none")
    module, cls, options = EXPORTS[name]
    example = _import_example("torch", {"demo": "torch_demo", "fractals": "torch_fractals"}[module])
    out = tmp_path / "port.rgb"
    scene = getattr(example, cls)()
    scene.main(width=WIDTH, height=HEIGHT, fps=FPS, output=str(out), device="cpu", **options)
    got = np.fromfile(out, np.uint8)
    want = reference[f"export/{name}"]
    frames = round(options["time"] * FPS)
    ssaa = options["ssaa"]
    width, height = ((int(WIDTH * ssaa), int(HEIGHT * ssaa)) if ssaa < 1 or "raw" in options
                     else (WIDTH, HEIGHT))
    assert got.size == want.size == frames * height * width * 3
    if ssaa < 1 or "raw" in options:    # rendered and written at the same size
        assert scene.render_resolution == scene.resolution == (width, height)
    else:
        assert scene.render_resolution == (int(width * ssaa), int(height * ssaa))
    worst, share = _u8_stats(got, want)
    print(f"{name}: max {worst} u8 steps on {share:.4%}")
    assert worst <= 1 and share < (0.02 if name.startswith("visualizer") else 0.01)
    assert got.reshape(frames, -1)[-1].std() > 5


def test_cli_export_at_ssaa_4_matches_jax(reference, tmp_path):
    """Basic through the command line at -s 4 (render 384x216, subsample
    2: the general path) against the JAX package's command line."""
    from shaderflow_tpu_torch import cli
    out = tmp_path / "basic.rgb"
    cli.main([str(REPO / "examples" / "torch" / "torch_demo.py"), "Basic", "main",
              "-w", str(WIDTH), "-h", str(HEIGHT), "-f", str(FPS), "-t", "0.3", "-s", "4",
              "--device", "cpu", "-o", str(out)])
    got = np.fromfile(out, np.uint8)
    want = reference["export/basic-4"]
    assert got.size == want.size == 3 * HEIGHT * WIDTH * 3
    worst, share = _u8_stats(got, want)
    print(f"Basic -s 4: max {worst} u8 steps on {share:.4%}")
    assert worst <= 1 and share < 0.01


def test_realtime_mandelbrot_at_half_ssaa_matches_jax(reference):
    """A realtime Mandelbrot at ssaa 0.5 (render 48x27, upsampled to 96x54
    by the general resampler) driven frame by frame at dt = 1/60: at most
    one u8 step on < 1 % of values."""
    from shaderflow_tpu_torch.scene import WindowBackend
    fractals = _import_example("torch", "torch_fractals")
    scene = fractals.Mandelbrot(backend=WindowBackend.Headless)
    scene._setup_run(width=WIDTH, height=HEIGHT, fps=60, ssaa=0.5, device="cpu")
    assert scene.render_resolution == (48, 27) and scene.resolution == (WIDTH, HEIGHT)
    for k in range(REALTIME_FRAMES):
        scene.engine.begin_batch()
        scene.next(dt=1.0 / 60.0)
        frame = scene.engine.flush(1)[0].numpy()
        assert frame.shape == (HEIGHT, WIDTH, 3)
        worst, share = _u8_stats(frame, reference[f"realtime/{k}"])
        print(f"realtime Mandelbrot ssaa 0.5 frame {k}: max {worst} u8 steps on {share:.4%}")
        assert worst <= 1 and share < 0.01
