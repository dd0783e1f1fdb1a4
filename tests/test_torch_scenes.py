"""The offline example scenes of the PyTorch port (examples/torch/
torch_demo.py, torch_fractals.py: Basic, ShaderToy, Waveform, MusicBars,
RayMarch, Tetration, Dynamics, MultiShader, Multipass, MotionBlur, Life)
against the JAX package's (examples/basic/demo.py, examples/fractals/
fractals.py), against the GL oracle (tools/gl_oracle.py) and against the
golden frames (tests/golden/), at the JAX package's own bars
(tests/test_psnr_reference.py, tests/test_golden.py).

The JAX package exports every scene in one child interpreter on XLA:CPU
capped at the AVX ISA (no FMA contraction, as tests/test_torch_scene.py
runs it); the port exports on the CPU. Both capture their uniforms through
their own host paths; the audio scenes are also exported with the JAX
run's spectrogram and waveform sequences carried across
(engine.load_reference_state). `-s` prints each measured figure."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_scene import _import_example

REPO = Path(__file__).resolve().parent.parent
WIDTH, HEIGHT, FPS = 96, 54, 10
# name -> (example module, export options): a few frames each; the
# temporal scenes run past their 10-deep rings and two Life steps
SCENES = {
    "Basic": ("demo", dict(time=0.3)),
    "ShaderToy": ("demo", dict(time=0.3)),
    "MultiShader": ("demo", dict(time=0.3)),
    "Multipass": ("demo", dict(time=0.3)),
    "MotionBlur": ("demo", dict(time=1.3)),
    "Dynamics": ("demo", dict(time=0.5)),
    "Waveform": ("demo", dict(time=0.5)),
    "MusicBars": ("demo", dict(time=0.5)),
    "RayMarch": ("demo", dict(time=0.3)),
    "Life": ("demo", dict(time=1.3)),
    # the JAX package's Tetration bar is set at ssaa 1, subsample 1
    # (tests/test_psnr_reference.py:209-247)
    "Tetration": ("fractals", dict(time=0.2, width=160, height=90, ssaa=1, subsample=1)),
}
AUDIO = ("Waveform", "MusicBars")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU frames are thousands of small torch ops (RayMarch:
    13,592 a frame). Beside the other test workers on one machine, torch's
    intra-op threads spin against theirs (a 7 s test took 497 s in a run
    of six workers): this file's tests run on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

JAX_SCRIPT = """
import sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())
modules = {"demo": _import_example("basic", "demo"),
           "fractals": _import_example("fractals", "fractals")}
for name, (module, options) in SCENES.items():
    scene = getattr(modules[module], name)()
    scene.main(output=f"{TMP}/jax_{name}.rgb", **{**SIZE, **options})
    engine = scene.engine
    arrays = {f"uniform/{index}/{key}": value
              for index, frame in enumerate(engine._frame_uniforms)
              for key, value in frame.items()}
    arrays.update({f"sequence/{key}": np.asarray(value)
                   for key, value in engine._sequences.items()})
    np.savez(f"{TMP}/jax_{name}.npz", **arrays)
"""


def _read(path: Path, height: int, width: int) -> np.ndarray:
    return np.fromfile(path, np.uint8).reshape(-1, height, width, 3)


def _u8_stats(got: np.ndarray, want: np.ndarray) -> tuple:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(diff.max()), float((diff != 0).mean())


def _port_class(name: str):
    module = SCENES[name][0] if name in SCENES else "demo"
    example = {"demo": "torch_demo", "fractals": "torch_fractals"}[module]
    return getattr(_import_example("torch", example), name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every scene exported by the JAX package (one child), then by the
    port: independently, and (the audio scenes) with the JAX sequences."""
    from shaderflow_tpu_torch.engine import load_reference_state
    tmp = tmp_path_factory.mktemp("scenes")
    size = dict(width=WIDTH, height=HEIGHT, fps=FPS)
    script = (f"TESTS, TMP = {str(REPO / 'tests')!r}, {str(tmp)!r}\n"
              f"SIZE, SCENES = {size!r}, {SCENES!r}\n" + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stderr[-4000:]
    out = {}
    for name, (_, options) in SCENES.items():
        options = {**size, **options}
        height, width = options["height"], options["width"]
        state = dict(np.load(tmp / f"jax_{name}.npz"))
        uniforms = {}
        for key, value in state.items():
            if key.startswith("uniform/"):
                _, index, uniform = key.split("/", 2)
                uniforms.setdefault(int(index), {})[uniform] = value
        run = dict(jax=_read(tmp / f"jax_{name}.rgb", height, width),
                   uniforms=[uniforms[i] for i in sorted(uniforms)])
        scene = _port_class(name)()
        scene.main(output=str(tmp / f"torch_{name}.rgb"), device="cpu", **options)
        run.update(port=scene, torch=_read(tmp / f"torch_{name}.rgb", height, width))
        if name in AUDIO:
            sequences = {key.split("/", 1)[1]: torch.from_numpy(value)
                         for key, value in state.items() if key.startswith("sequence/")}
            carried = _port_class(name)()
            load_reference_state(carried, sequences)
            carried.main(output=str(tmp / f"carried_{name}.rgb"), device="cpu", **options)
            run["carried"] = _read(tmp / f"carried_{name}.rgb", height, width)
        out[name] = run
    return out


@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_matches_jax(runs, name):
    """Each scene's frames and captured uniforms against the JAX package's.
    The uniforms (the host state that crosses into the render: time, the
    camera, the dynamics, the audio levels) are equal. The frames are
    within one u8 step on < 1 % of values (PERF.md §2; measured: every
    scene but Tetration and MotionBlur bit-equal, MotionBlur one step on
    0.006 % of values); the bars and the waveform with the JAX sequences
    carried across are bit-equal. Tetration's 67 chaotic cpow steps carry
    the float32 libraries' one-ulp differences in pow, exp, log, cos, sin
    and atan2 into flipped escapes: it is held to the JAX package's own bar
    for it (tests/test_psnr_reference.py:209-247): >= 99 % of pixels
    exact, and the rest on the escape boundary (at most 5 % of them plus 3
    more than 2 px from the reference's own boundary)."""
    run = runs[name]
    port_frames = run["port"].engine._frame_uniforms
    assert len(run["uniforms"]) == len(port_frames) == run["jax"].shape[0]
    for ref, got in zip(run["uniforms"], port_frames):
        assert sorted(ref) == sorted(got)
        for key in ref:
            np.testing.assert_array_equal(np.asarray(got[key]), ref[key], err_msg=key)
    assert run["torch"].shape == run["jax"].shape
    assert run["torch"].std() > 5   # a structured image, not a constant frame
    max_diff, share = _u8_stats(run["torch"], run["jax"])
    print(f"{name}: max {max_diff} u8 steps on {share:.4%} of values")
    if name == "Tetration":
        _assert_tetration_bar(run["torch"], run["jax"])
        return
    assert max_diff <= 1 and share < 0.01
    if name in AUDIO:
        carried_max, _ = _u8_stats(run["carried"], run["jax"])
        print(f"{name} with the JAX sequences: max {carried_max} u8 steps")
        assert np.array_equal(run["carried"], run["jax"])


def _assert_tetration_bar(got: np.ndarray, want: np.ndarray, any_step: bool = True) -> None:
    """tests/test_psnr_reference.py:225-247 on each frame: the exact share
    (any difference counts when any_step, > 1 u8 step otherwise) and the
    flips hugging the reference's escape boundary (dilated 2 px)."""
    for index, (ours, ref) in enumerate(zip(got.astype(np.int16), want.astype(np.int16))):
        height, width = ref.shape[:2]
        disagree = np.abs(ours - ref).max(-1) > (0 if any_step else 1)
        print(f"Tetration frame {index}: {1 - disagree.mean():.4%} of pixels agree")
        assert (1 - disagree.mean()) >= 0.99, f"frame {index}: {disagree.mean():.2%} differ"
        k = (ref[..., 0] > 127).astype(np.int16)
        pad = np.pad(k, 2, mode="edge")
        stacked = np.stack([pad[dy:dy + height, dx:dx + width]
                            for dy in range(5) for dx in range(5)])
        boundary = stacked.min(0) != stacked.max(0)
        stray = (disagree & ~boundary).sum()
        assert stray <= disagree.sum() * 0.05 + 3, f"frame {index}: {stray} stray flips"


# --------------------------------------------------------------------------- #
# Tetration's tail: XLA's reassociation and the tracer

TAIL_SCRIPT = """
import sys
import numpy as np
import jax
import jax.numpy as jnp
sys.path.insert(0, TESTS)
from test_torch_scene import _import_example
from shaderflow_tpu.ops import tailfuse
fractals = _import_example("fractals", "fractals")
planes = dict(np.load(IN))


class Capture:
    # what tetration_frag reads: the camera's gluv; sf.tail hands back the tail
    class camera:
        gluv = jnp.zeros((2, 2, 2), jnp.float32)

    @staticmethod
    def tail(fn, **inputs):
        return fn


class JuliaCapture(Capture):
    class camera:
        gluv = jnp.zeros((2, 2, 2), jnp.float32)
        out_of_bounds = jnp.zeros((2, 2), bool)

    iTime = jnp.float32(0.0)

    @staticmethod
    def uniform(name, default=None):
        return QUALITY / 1000.0


def run(fn, **inputs):
    height, width = next(iter(inputs.values())).shape
    spec = tailfuse.make_spec(fn, height, width, **inputs)
    return tailfuse.eval_reference(spec, height, width, 1.0)


tetration = fractals.tetration_frag(Capture())
julia = fractals.julia_frag(JuliaCapture())
np.savez(OUT, tetration=np.asarray(jax.jit(lambda k, zx, zy: run(tetration, k=k, zx=zx, zy=zy))(
                  planes["k"], planes["zx"], planes["zy"])),
         julia=np.asarray(jax.jit(lambda iters, oob: run(julia, iters=iters, oob=oob))(
             planes["iters"], planes["oob"])))
"""
QUALITY = 500


def _tail_planes(height: int = 96, width: int = 128) -> dict:
    """Seeded escape planes: z over the range escaped orbits reach, and k
    binary (about half the pixels interior)."""
    rng = np.random.default_rng(7)
    return {"zx": rng.uniform(-120.0, 120.0, (height, width)).astype(np.float32),
            "zy": rng.uniform(-120.0, 120.0, (height, width)).astype(np.float32),
            "k": (rng.random((height, width)) < 0.5).astype(np.float32)}


def _julia_planes() -> dict:
    """Every escape count of Julia's default quality, 0..QUALITY, inside
    the view."""
    iters = np.arange(16 * 32, dtype=np.float32).reshape(16, 32) % (QUALITY + 1)
    return {"iters": iters, "oob": np.zeros_like(iters)}


def _naive_tail(tp):
    """Tetration's tail with 6 * (h * (1 / tau)) written as two products,
    where XLA multiplies h by one folded constant: the form the port had to
    repair (only the sector differs from torch_fractals.tetration_tail)."""
    import math
    from shaderflow_tpu_torch.ops import reciprocal, tailfuse
    tau = 2.0 * math.pi
    h = torch.remainder(tailfuse.atan2(tp.plane("zy"), tp.plane("zx")), tau) * reciprocal(tau)
    value = tp.plane("k")
    x = value * (1.0 - torch.abs(torch.remainder(h * reciprocal(math.pi / 3.0), 2.0) - 1.0))
    sector = torch.floor(6.0 * (h * reciprocal(tau)))
    zero = torch.zeros_like(value)

    def pick(options):
        out = zero
        for index, option in enumerate(options):
            out = torch.where(sector == float(index), option, out)
        return out

    return (pick([value, x, zero, zero, x, value]), pick([x, value, value, x, zero, zero]),
            pick([zero, zero, x, value, value, x]))


def test_tetration_tail_matches_jax_tail(tmp_path):
    """The reassociation item (ROADMAP queue 3): Tetration's tail on the
    same seeded zx, zy and k planes through the JAX package's tail
    (compiled, in a child on XLA:CPU capped at the AVX ISA) and through the
    port's plain path. XLA computes 6 * (h / tau) as h * f32(6 * (1 / tau));
    the port's tail writes it so (stdlib.scaled_quotient), and the tail
    function is the one the tracer reads for kernel K1: equal bit for bit.
    The tail with the two products as written differs by an ulp on about a
    tenth of the pixels."""
    from shaderflow_tpu_torch.ops import tailfuse
    planes = _tail_planes()
    want = _reference_tails(tmp_path)["tetration"]
    height, width = planes["k"].shape
    inputs = {name: torch.from_numpy(plane) for name, plane in planes.items()}
    fractals = _import_example("torch", "torch_fractals")
    got = tailfuse.eval_reference(tailfuse.make_spec(fractals.tetration_tail, height, width,
                                                     **inputs), height, width, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)
    naive = tailfuse.eval_reference(tailfuse.make_spec(_naive_tail, height, width, **inputs),
                                    height, width, 1.0).numpy()
    moved = (naive != want).any(-1)
    print(f"6 * (h * (1 / tau)) as two products: {int(moved.sum())} of {moved.size} "
          f"pixels differ from the JAX tail, by up to {np.abs(naive - want).max():.3g}")
    assert moved.any()


def _reference_tails(tmp_path: Path) -> dict:
    """The JAX package's Tetration and Julia tails (captured from their
    fragments), compiled, on _tail_planes and _julia_planes, in a child on
    XLA:CPU capped at the AVX ISA."""
    np.savez(tmp_path / "in.npz", **_tail_planes(), **_julia_planes())
    script = (f"TESTS, IN, OUT = {str(REPO / 'tests')!r}, {str(tmp_path / 'in.npz')!r}, "
              f"{str(tmp_path / 'out.npz')!r}\nQUALITY = {QUALITY}\n" + TAIL_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp_path))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    return dict(np.load(tmp_path / "out.npz"))


def test_julia_tail_matches_jax_tail(tmp_path):
    """Julia's hue tail over every count of its default quality equals the
    JAX tail bit for bit. XLA computes 6 * (h / tau) as h * f32(6 * (1 /
    tau)), the port as two products: at count 32 they floor to sectors 2
    and 3, on the sectors' boundary, where x == c and both give the same
    color."""
    from shaderflow_tpu_torch.ops import tailfuse
    want = _reference_tails(tmp_path)["julia"]
    planes = {name: torch.from_numpy(plane) for name, plane in _julia_planes().items()}
    height, width = planes["iters"].shape
    fractals = _import_example("torch", "torch_fractals")
    got = tailfuse.eval_reference(tailfuse.make_spec(fractals.julia_tail(QUALITY), height,
                                                     width, **planes), height, width, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)


def test_tetration_tail_traces_for_k1():
    """The tracer behind kernel K1 covers the tail's ops (remainder, floor,
    abs, the six-way where pick, tailfuse.atan2): the traced graph
    evaluated with torch equals the direct call bit for bit, and the
    generated Triton source compiles as Python and loads exactly the three
    planes."""
    from shaderflow_tpu_torch.ops import tailfuse, tailgen
    fractals = _import_example("torch", "torch_fractals")
    planes = {name: torch.from_numpy(plane) for name, plane in _tail_planes(24, 64).items()}
    render_h, render_w = 24, 64
    spec = tailfuse.make_spec(fractals.tetration_tail, render_h, render_w, **planes)
    graph, outputs = tailgen.trace(spec, render_h, render_w, 1.5)
    shape = (render_h, render_w)
    env = {("row_index", "", 0): torch.arange(render_h, dtype=torch.float32)[:, None].expand(shape),
           ("col_index", "", 0): torch.arange(render_w, dtype=torch.float32)[None, :].expand(shape)}
    env.update({("plane", name, c): plane for name, channels in spec.planes.items()
                for c, plane in enumerate(channels)})
    traced = torch.stack([torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32), shape)
                          for v in tailgen.evaluate(graph, outputs, env)], dim=-1)
    assert torch.equal(traced, tailfuse.eval_reference(spec, render_h, render_w, 1.5))
    source, keys = tailgen.generate(graph, outputs, 2, frozenset())
    compile(source, "<generated K1>", "exec")
    assert set(keys) == {("plane", name, 0) for name in ("k", "zx", "zy")}
    assert "libdevice.fmod" in source and "tl.floor" in source


# --------------------------------------------------------------------------- #
# Against the GL oracle and the golden frames (the port alone, on the CPU)

def _oracle():
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import gl_oracle
    finally:
        sys.path.remove(str(REPO / "tools"))
    return gl_oracle


def _frames(scene, frames: int, step=None, **options):
    """tests/test_psnr_reference.py's engine_frames_and_uniforms for the
    port: `frames` frames at 10 fps through the engine on the CPU ->
    (u8 frames, each frame's uniforms with the statics, as numpy). `step`
    runs before each frame's update (the MotionBlur camera teleport)."""
    scene._setup_run(fps=10, time=frames / 10, freewheel=True, device="cpu", **options)
    scene._prewarm_modules()
    engine = scene.engine
    engine.begin_batch()
    for index in range(frames):
        if step is not None:
            step(scene, index)
        scene.next(dt=scene.frametime)
    uniforms = [{name: np.asarray(value) for name, value in
                 {**engine._statics, **snapshot}.items()}
                for snapshot in engine._frame_uniforms]
    return engine.flush(frames).numpy(), uniforms


@pytest.mark.parametrize("ssaa,subsample", [(1.0, 1), (2.0, 2)])
def test_default_scene_against_oracle(ssaa, subsample):
    """Config 1, the built-in welcome program (Basic) at 512x288, three
    frames: >= 40 dB a frame against the oracle (test_psnr_reference.py:42-58)."""
    oracle = _oracle()
    scene = _port_class("Basic")()
    width, height = 512, 288
    frames, uniforms = _frames(scene, 3, width=width, height=height, ssaa=ssaa,
                               subsample=subsample)
    for index, uniform in enumerate(uniforms):
        want = oracle.render_scene(oracle.default_fragment, uniform, *scene.render_resolution,
                                   width, height, subsample, scene.aspect_ratio)
        value = oracle.psnr(frames[index], want)
        print(f"Basic ssaa {ssaa} frame {index}: {value:.2f} dB")
        assert value >= 40.0, f"frame {index}: PSNR {value:.1f} dB < 40"


def test_raymarch_against_oracle():
    """Config 4, the ray marcher at 320x180, two frames: >= 40 dB
    (test_psnr_reference.py:82-98; the oracle's masked loop with GLSL's
    break semantics)."""
    oracle = _oracle()
    scene = _port_class("RayMarch")()
    width, height = 320, 180
    frames, uniforms = _frames(scene, 2, width=width, height=height, ssaa=1.0, subsample=1)
    for index, uniform in enumerate(uniforms):
        want = oracle.render_scene(oracle.raymarch_fragment, uniform, *scene.render_resolution,
                                   width, height, 1, scene.aspect_ratio)
        value = oracle.psnr(frames[index], want)
        print(f"RayMarch frame {index}: {value:.2f} dB")
        assert value >= 40.0, f"frame {index}: PSNR {value:.1f} dB < 40"


def test_bars_against_oracle():
    """Config 2, the music bars at 320x180, three frames with live audio:
    >= 40 dB (test_psnr_reference.py:101-122)."""
    oracle = _oracle()
    scene = _port_class("MusicBars")()
    width, height = 320, 180
    frames, uniforms = _frames(scene, 3, width=width, height=height, ssaa=1.0, subsample=1)
    assert any(float(u["iAudioVolume"]) > 0.1 for u in uniforms)
    spectrogram = scene.engine.bound_sequences()["iSpectrogram"].numpy()
    for index, uniform in enumerate(uniforms):
        k = int(uniform["iFrameIndex"])
        textures = dict(spectrogram=spectrogram[min(k, len(spectrogram) - 1)][:, 0, :][::-1])
        want = oracle.render_scene(
            lambda u, w, h, a: oracle.bars_fragment(u, w, h, a, textures),
            uniform, *scene.render_resolution, width, height, 1, scene.aspect_ratio)
        value = oracle.psnr(frames[index], want)
        print(f"MusicBars frame {index}: {value:.2f} dB")
        assert value >= 40.0, f"frame {index}: PSNR {value:.1f} dB < 40"


def test_waveform_against_oracle():
    """The oscilloscope at 320x180, three frames: < 0.5 % of pixels more
    than 2 u8 steps from the oracle (test_psnr_reference.py:125-150: the
    fragment's binary thresholds flip single pixels at an ulp)."""
    oracle = _oracle()
    scene = _port_class("Waveform")()
    width, height = 320, 180
    frames, uniforms = _frames(scene, 3, width=width, height=height, ssaa=1.0, subsample=1)
    waveform = scene.engine.bound_sequences()["iWaveform"].numpy()
    for index, uniform in enumerate(uniforms):
        k = int(uniform["iFrameIndex"])
        textures = dict(waveform=waveform[min(k, len(waveform) - 1)][0])
        want = oracle.render_scene(
            lambda u, w, h, a: oracle.waveform_fragment(u, w, h, a, textures),
            uniform, *scene.render_resolution, width, height, 1, scene.aspect_ratio)
        diff = np.abs(frames[index].astype(np.int16) - want.astype(np.int16))
        disagree = (diff.max(-1) > 2).mean()
        print(f"Waveform frame {index}: {disagree:.4%} of pixels > 2 steps")
        assert disagree < 0.005, f"frame {index}: {disagree:.2%} pixels differ"


def test_tetration_against_oracle():
    """Tetration at 320x180, two frames, against the oracle's tetration
    (test_psnr_reference.py:209-247): >= 99 % of pixels within one u8
    step, the flips on the oracle's escape boundary."""
    oracle = _oracle()
    scene = _port_class("Tetration")()
    width, height = 320, 180
    frames, uniforms = _frames(scene, 2, width=width, height=height, ssaa=1.0, subsample=1)
    want = np.stack([oracle.render_scene(oracle.tetration_fragment, uniform,
                                         *scene.render_resolution, width, height, 1,
                                         scene.aspect_ratio) for uniform in uniforms])
    _assert_tetration_bar(frames, want, any_step=False)


def test_life_against_oracle():
    """Conway's Life at 192x108 over 15 frames (three simulation periods)
    against the NumPy replay of both programs and the ring
    (test_psnr_reference.py:250-318): the seed at slot 1, render into slot
    0 then roll, the visuals reading slots 0-4 of the rolled ring, the
    texelFetch zero border and the iFrame % iLifePeriod hold: >= 40 dB."""
    oracle = _oracle()
    scene = _port_class("Life")()
    width, height = 192, 108
    n_frames = 15
    frames, uniforms = _frames(scene, n_frames, width=width, height=height, ssaa=1.0,
                               subsample=1)
    sim_h, sim_w = 108, 192
    period = scene.life_period
    seed = np.random.default_rng(0).integers(0, 2, (sim_h, sim_w)).astype(np.float32)
    ring = np.zeros((10, sim_h, sim_w), np.float32)
    ring[1] = seed

    def sim_step(prev):
        padded = np.pad(prev, 1)
        near = sum(padded[1 + dy:1 + dy + sim_h, 1 + dx:1 + dx + sim_w] > 0.5
                   for dy in (-1, 0, 1) for dx in (-1, 0, 1)) - (prev > 0.5)
        alive = np.where(prev > 0.5, (near == 2) | (near == 3), near == 3)
        return alive.astype(np.float32)

    colors = [np.array(c, np.float32) for c in oracle.MAGMA]

    def visuals(uniform, ring):
        def fragment(u, w, h, a):
            co = oracle.coords(w, h, a)
            cam = oracle.get_camera(u, co)
            uv = (cam["gluv"] + 1) / 2
            tex_aspect = np.float32(sim_h / sim_w)
            su = ((uv[..., 0] * 2 - 1) * tex_aspect + 1) / 2
            sv = uv[..., 1]
            ix = np.clip(np.floor(su * sim_w).astype(np.int32), 0, sim_w - 1)
            iy = np.clip(np.floor(sv * sim_h).astype(np.int32), 0, sim_h - 1)
            exponent = 1.3
            area = 1 / (exponent + 1)
            life = ring[0][iy, ix].astype(np.float32)
            for slot, factor in zip(range(1, 5), (0.8, 0.6, 0.4, 0.2)):
                life = life + ring[slot][iy, ix] * np.float32(factor ** exponent)
            life = (life / np.float32(5 * area)).astype(np.float32)
            rgb = oracle.palette(life, *colors)
            return np.where(cam["out_of_bounds"][..., None], colors[0], rgb)
        return oracle.render_scene(fragment, uniform, *scene.render_resolution,
                                   width, height, 1, scene.aspect_ratio)

    for index, uniform in enumerate(uniforms):
        if int(uniform["iFrame"]) % period != 0:
            out = ring[1].copy()
        else:
            out = sim_step(ring[1])
        ring[0] = out
        ring = np.roll(ring, 1, axis=0)
        value = oracle.psnr(frames[index], visuals(uniform, ring))
        print(f"Life frame {index}: {value:.2f} dB")
        assert value >= 40.0, f"frame {index}: PSNR {value:.1f} dB < 40"


def test_motionblur_against_oracle():
    """MotionBlur at 160x90 over 12 frames, the camera teleported every
    frame so the ring's mixing shows, against the NumPy replay of the main
    program's ring (test_psnr_reference.py:321-378): layer 1 reads this
    frame's layer 0 at slot 0, the ring rolls, the final pass reads slot
    1: >= 40 dB."""
    oracle = _oracle()
    scene = _port_class("MotionBlur")()
    width, height = 160, 90
    n_frames = 12

    def teleport(scene, i):
        p = np.array([0.05 * i, 0.04 * np.sin(i * 0.9), 0.0], np.float32)
        scene.camera.position.value = p
        scene.camera.position.target = p

    frames, uniforms = _frames(scene, n_frames, step=teleport, width=width, height=height,
                               ssaa=1.0, subsample=1)
    background = scene.engine._static_tex["background"][0, 0].numpy()[::-1]
    tex_aspect = np.float32(background.shape[0] / background.shape[1])
    temporal = 10
    ring = np.zeros((temporal, 2, height, width, 3), np.float32)

    def sstep01(x):
        t = np.clip(x, 0, 1).astype(np.float32)
        return (t * t * (3 - 2 * t)).astype(np.float32)

    for index, uniform in enumerate(uniforms):
        def fragment(u, w, h, a, ring=ring):
            co = oracle.coords(w, h, a)
            cam = oracle.get_camera(u, co)
            st = ((cam["gluv"] + 1) / 2).astype(np.float32)
            su = ((st[..., 0] * 2 - 1) * tex_aspect + 1) / 2
            layer0 = oracle._sample_bilinear(
                background, su.astype(np.float32), st[..., 1], repeat=True)[..., :3]
            ring[0, 0] = layer0
            color = np.zeros_like(layer0)
            for i in range(temporal):
                color = color + ring[i, 0] * sstep01(1.0 - i / temporal)
            ring[0, 1] = 2 * color / temporal
            return ring[0, 1]
        want = oracle.render_scene(fragment, uniform, *scene.render_resolution,
                                   width, height, 1, scene.aspect_ratio)
        ring[:] = np.roll(ring, 1, axis=0)
        value = oracle.psnr(frames[index], want)
        print(f"MotionBlur frame {index}: {value:.2f} dB")
        assert value >= 40.0, f"frame {index}: PSNR {value:.1f} dB < 40"


@pytest.mark.parametrize("name", ["basic", "shadertoy", "raymarch", "tetration"])
def test_golden_frame(name):
    """tests/test_golden.py:18-61 for the port: the last of three frames at
    96x54 and 10 fps with the scene's defaults (ssaa 1, subsample 2)
    against tests/golden/<name>.png: > 50 dB."""
    from PIL import Image
    golden = np.array(Image.open(REPO / "tests" / "golden" / f"{name}.png"))
    cls = _port_class({"basic": "Basic", "shadertoy": "ShaderToy", "raymarch": "RayMarch",
                       "tetration": "Tetration"}[name])
    frames, _ = _frames(cls(), 3, width=96, height=54)
    assert frames[-1].shape == golden.shape
    mse = np.mean((frames[-1].astype(np.float64) - golden.astype(np.float64)) ** 2)
    value = np.inf if mse == 0 else 10 * np.log10(255.0 ** 2 / mse)
    print(f"{name} against the golden frame: {value:.2f} dB")
    assert value > 50.0, f"{name}: PSNR {value:.1f} dB vs golden"
