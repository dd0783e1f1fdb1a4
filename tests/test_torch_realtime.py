"""The realtime preview of the PyTorch port against the JAX package, on the
CPU: streamed textures (host writes during the frame loop, one promoted
mid-batch, one on the u8 wire) exported by both packages; the realtime
spectrogram and waveform frame by frame (host numpy on both sides, so
exact), and a run resumed from the reference's mid-run state
(engine.load_reference_state); the music visualizer and Mandelbrot driven
frame by frame as the realtime loop drives them (next(dt), flush(1)); the
per-frame bar lookup (ops.sampling.lookup_nearest_1d_select); the realtime
loop itself (main without an output, frame_limit, the micro-batch
controller, SHADERFLOW_RT_BATCH); the hot reload of a .frag file; and the
command line's realtime launch.

The JAX side of the frame comparisons runs in a child interpreter on
XLA:CPU capped at the AVX ISA (no FMA contraction), as
tests/test_torch_scene.py runs it; both sides run with
SHADERFLOW_AUDIO_BACKEND=none (no speaker)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_scene import _fix_reference_texture, _import_example

REPO = Path(__file__).resolve().parent.parent
WIDTH, HEIGHT = 96, 54
REALTIME_FRAMES = 6
REALTIME_DT = 1.0 / 60.0
STREAM_FRAMES = 8


# --------------------------------------------------------------------------- #
# The streamed-texture scene, written the same way for both packages

def late_content() -> np.ndarray:
    """The 'late' texture's static content, written at build."""
    return np.random.default_rng(99).random((6, 8, 4), dtype=np.float32)


def write_streams(noise, late, wire, frame: int) -> None:
    """Frame `frame`'s seeded host writes: `noise` (float32) every frame,
    `late` (a partial write) from frame 3 on, `wire` in uint8 (the u8
    wire) every frame but frame 5, whose float32 write turns its stream to
    float32."""
    rng = np.random.default_rng(1000 + frame)
    noise.write(rng.random((6, 8, 3), dtype=np.float32))
    if frame >= 3:
        late.write(rng.random((2, 3, 4), dtype=np.float32), viewport=(1, 2, 3, 2))
    if frame == 5:
        wire.write(rng.random((6, 8, 3), dtype=np.float32))
    else:
        wire.write(rng.integers(0, 256, (6, 8, 3), dtype=np.uint8))


def stream_scene(package: str):
    """The streamed-texture scene class of `package` (shaderflow_tpu or
    shaderflow_tpu_torch): three 8x6 textures sampled at astuv, one
    channel each."""
    import importlib
    scene_module = importlib.import_module(f"{package}.scene")
    texture_module = importlib.import_module(f"{package}.texture")
    if package == "shaderflow_tpu":
        import jax.numpy as xp
    else:
        xp = torch

    def frag(sf):
        a = sf.texture("noise", sf.astuv)
        b = sf.texture("late", sf.astuv)
        c = sf.texture("wire", sf.astuv)
        return xp.stack([a[..., 0], b[..., 1], c[..., 2]], -1)

    class Streams(scene_module.ShaderScene):
        def build(self):
            Texture = texture_module.ShaderTexture
            self.noise = Texture(scene=self, name="noise", width=8, height=6, components=3,
                                 dtype=np.float32)
            self.late = Texture(scene=self, name="late", width=8, height=6, components=4,
                                dtype=np.float32)
            self.late.write(late_content())
            self.wire = Texture(scene=self, name="wire", width=8, height=6, components=3)
            self.shader.fragment = frag

        def update(self):
            write_streams(self.noise, self.late, self.wire, self._frame_counter)

    return Streams


JAX_SCRIPT = """
import os, sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
os.environ["SHADERFLOW_AUDIO_BACKEND"] = "none"
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())
from test_torch_realtime import stream_scene
from shaderflow_tpu.scene import WindowBackend

results = {}
Streams = stream_scene("shaderflow_tpu")
for batch in (None, 3):
    out = os.path.join(TMP, f"streams_{batch}.rgb")
    Streams(backend=WindowBackend.Headless).main(
        width=WIDTH, height=HEIGHT, fps=10, time=FRAMES_STREAM / 10, batch=batch, output=out)
    results[f"streams/{batch}"] = np.fromfile(out, np.uint8)

for name, directory, module in (("viz", "basic", "demo"), ("mandelbrot", "fractals", "fractals")):
    cls = getattr(_import_example(directory, module), "Visualizer" if name == "viz" else "Mandelbrot")
    scene = cls(backend=WindowBackend.Headless)
    scene._setup_run(width=WIDTH, height=HEIGHT, fps=60, ssaa=2)
    for k in range(FRAMES_RT):
        scene.engine.begin_batch()
        scene.next(dt=DT)
        results[f"{name}/frame/{k}"] = np.asarray(scene.engine.flush(1))[0]
        for key, value in scene.engine._frame_uniforms[0].items():
            results[f"{name}/uniform/{k}/{key}"] = np.asarray(value)
np.savez(OUTPUT, **results)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's side of the frame comparisons, in one AVX child."""
    tmp = tmp_path_factory.mktemp("realtime")
    script = (f"TESTS, TMP, OUTPUT = {str(REPO / 'tests')!r}, {str(tmp)!r}, "
              f"{str(tmp / 'jax.npz')!r}\n"
              f"WIDTH, HEIGHT, FRAMES_STREAM, FRAMES_RT, DT = {WIDTH}, {HEIGHT}, "
              f"{STREAM_FRAMES}, {REALTIME_FRAMES}, {REALTIME_DT!r}\n" + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp), WINDOW_BACKEND="headless")
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=400)
    assert result.returncode == 0, result.stderr[-4000:]
    return dict(np.load(tmp / "jax.npz"))


def _u8_stats(got, want):
    diff = np.abs(np.asarray(got).astype(np.int16) - np.asarray(want).astype(np.int16))
    return int(diff.max()), float((diff != 0).mean())


@pytest.mark.parametrize("batch", [None, 3], ids=["one-batch", "batch-3"])
def test_streamed_textures_match_jax(reference, tmp_path, batch):
    """Host writes during the frame loop, exported in freewheel by both
    packages at 96x54: a float32 texture written every frame, one promoted
    mid-batch by a partial write at frame 3 (the frames before it in its
    batch read its first snapshot), and a u8 texture on the wire whose
    frame-5 float32 write turns its stream to float32. Bit-equal frames,
    in one batch and in batches of three."""
    output = tmp_path / "streams.rgb"
    scene = stream_scene("shaderflow_tpu_torch")()
    scene.main(width=WIDTH, height=HEIGHT, fps=10, time=STREAM_FRAMES / 10, batch=batch,
               output=str(output), device="cpu")
    got = np.fromfile(output, np.uint8)
    want = reference[f"streams/{batch}"]
    assert got.size == want.size == STREAM_FRAMES * HEIGHT * WIDTH * 3
    frames = got.reshape(STREAM_FRAMES, HEIGHT, WIDTH, 3)
    assert len({frame.tobytes() for frame in frames}) == STREAM_FRAMES
    np.testing.assert_array_equal(got, want)
    engine = scene.engine
    assert engine._streamed_names == {"noise", "late", "wire"}
    assert engine._stream_f32 == {"noise", "late", "wire"}
    assert scene.wire.wire_u8 is not None   # its last write kept the u8 twin


def test_u8_wire_stream_is_normalized_on_the_device():
    """A u8 wire stream ships its bytes and is normalized once a batch as
    the reference's compiled program does (x * f32(1/255))."""
    scene = stream_scene("shaderflow_tpu_torch")()
    scene._setup_run(width=32, height=18, fps=10, freewheel=True, device="cpu")
    scene.engine.begin_batch()
    scene.next(dt=0.1)
    streams = scene.engine.stack_streams()
    assert streams["wire"].dtype == np.uint8 and streams["noise"].dtype == np.float32
    scene.engine.flush(1)
    wire = streams["wire"].astype(np.float32) * (np.float32(1) / np.float32(255))
    np.testing.assert_array_equal(scene.engine.state.stream_tex["wire"].numpy(), wire)


# --------------------------------------------------------------------------- #
# The realtime spectrogram and waveform, host numpy on both sides

def audio_scene(package: str):
    """Audio, a scrolling spectrogram (six columns at 30 fps) and the
    waveform of `package`, on the asset."""
    import importlib
    scene_module = importlib.import_module(f"{package}.scene")
    audio = importlib.import_module(f"{package}.audio")
    spectrogram = importlib.import_module(f"{package}.audio.spectrogram")
    waveform = importlib.import_module(f"{package}.audio.waveform")
    music = REPO / "examples" / "assets" / "music.wav"

    class Audio(scene_module.ShaderScene):
        def build(self):
            self.audio = audio.ShaderAudio(scene=self, name="iAudio", file=music)
            self.spectrogram = spectrogram.ShaderSpectrogram(
                scene=self, length=0.2, audio=self.audio, smooth=False)
            self.spectrogram.spectrogram_bins = 64
            self.waveform = waveform.ShaderWaveform(scene=self, audio=self.audio)

    return Audio


def _host_run(scene, frames: int, dt: float, record: list):
    scene._capture_enabled = False
    for _ in range(frames):
        scene.next(dt=dt)
        spectrogram = scene.spectrogram
        record.append(dict(
            columns=spectrogram.next_columns(),
            value=np.array(spectrogram.dynamics.value),
            derivative=np.array(spectrogram.dynamics.derivative),
            previous=np.array(spectrogram.dynamics.previous),
            target=np.array(spectrogram.dynamics.target),
            offset=spectrogram.offset,
            spectrogram=spectrogram.texture.matrix.copy(),
            waveform=scene.waveform.texture.matrix.copy(),
            volume=float(scene.audio.volume.value), std=float(scene.audio.std.value),
            tell=scene.audio.tell))


def test_spectrogram_and_waveform_per_frame_match_jax(monkeypatch):
    """Twelve realtime frames at dt = 1/30: the file read by rdt into the
    rolling buffer, next_columns, the dynamics state, the scrolling offset,
    the written spectrogram and waveform textures and the level uniforms
    equal the JAX package's exactly (both are host numpy)."""
    monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", "none")
    from shaderflow_tpu.scene import WindowBackend as ReferenceBackend
    from shaderflow_tpu_torch.scene import WindowBackend
    _fix_reference_texture(monkeypatch)
    runs = []
    for package, backend in (("shaderflow_tpu", ReferenceBackend),
                             ("shaderflow_tpu_torch", WindowBackend)):
        scene = audio_scene(package)(backend=backend.Headless)
        scene._setup_run(width=32, height=18, fps=30,
                         **({"device": "cpu"} if package.endswith("torch") else {}))
        assert scene.realtime and scene.audio.full_data is None
        record = []
        _host_run(scene, 12, 1.0 / 30.0, record)
        runs.append(record)
    want, got = runs
    for index, (a, b) in enumerate(zip(want, got)):
        assert a.keys() == b.keys()
        for key in a:
            np.testing.assert_array_equal(b[key], a[key], err_msg=f"frame {index} {key}")
    assert got[-1]["tell"] > 0.3 * 44100   # the file was read by rdt
    assert sorted({record["offset"] for record in got}) == list(range(6))
    assert np.abs(got[-1]["spectrogram"]).max() > 0 and np.abs(got[-1]["waveform"]).max() > 0


def test_resume_from_reference_mid_run_state(monkeypatch):
    """engine.load_reference_state carries the reference's streamed
    spectrogram texture and the spectrogram's dynamics at frame 6 into a
    port run whose own state was wiped: frames 6..11 then equal the
    reference's."""
    monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", "none")
    from shaderflow_tpu.scene import WindowBackend as ReferenceBackend
    from shaderflow_tpu_torch.engine import load_reference_state
    from shaderflow_tpu_torch.scene import WindowBackend
    _fix_reference_texture(monkeypatch)
    reference_scene = audio_scene("shaderflow_tpu")(backend=ReferenceBackend.Headless)
    reference_scene._setup_run(width=32, height=18, fps=30)
    want = []
    _host_run(reference_scene, 12, 1.0 / 30.0, want)

    port = audio_scene("shaderflow_tpu_torch")(backend=WindowBackend.Headless)
    port._setup_run(width=32, height=18, fps=30, device="cpu")
    got = []
    _host_run(port, 6, 1.0 / 30.0, got)
    port.spectrogram.dynamics.set(np.zeros_like(port.spectrogram.dynamics.value))
    port.spectrogram.texture.clear()
    state = want[5]
    load_reference_state(
        port, streams={"iSpectrogram": state["spectrogram"]},
        modules={"iSpectrogram": {key: state[key] for key in
                                  ("value", "derivative", "previous", "target", "offset")}})
    _host_run(port, 6, 1.0 / 30.0, got)
    for index in range(6, 12):
        for key in ("value", "spectrogram", "waveform", "offset"):
            np.testing.assert_array_equal(got[index][key], want[index][key],
                                          err_msg=f"frame {index} {key}")


# --------------------------------------------------------------------------- #
# The visualizer and Mandelbrot, frame by frame as the realtime loop runs them

def _port_realtime(cls, record_uniforms: bool = False):
    from shaderflow_tpu_torch.scene import WindowBackend
    scene = cls(backend=WindowBackend.Headless)
    scene._setup_run(width=WIDTH, height=HEIGHT, fps=60, ssaa=2, device="cpu")
    frames, uniforms = [], []
    for _ in range(REALTIME_FRAMES):
        scene.engine.begin_batch()
        scene.next(dt=REALTIME_DT)
        frames.append(scene.engine.flush(1)[0].numpy())
        uniforms.append(dict(scene.engine._frame_uniforms[0]))
    return scene, frames, uniforms


def test_visualizer_realtime_matches_jax(reference, monkeypatch):
    """The music visualizer's realtime path (streamed spectrogram and
    waveform, the per-frame bar lookup, the tail's in-kernel geometry) at
    96x54, 2x SSAA, six frames at dt = 1/60: every captured uniform equal,
    and the frames within the JAX package's own bar for this scene, at
    most one u8 step on < 2 % of values."""
    monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", "none")
    demo = _import_example("torch", "torch_demo")
    scene, frames, uniforms = _port_realtime(demo.Visualizer)
    assert scene.engine._streamed_names == {"iSpectrogram", "iWaveform"}
    assert not scene.engine.invariant_preludes(scene.engine.state)
    for k in range(REALTIME_FRAMES):
        for name, value in uniforms[k].items():
            np.testing.assert_array_equal(np.asarray(value),
                                          reference[f"viz/uniform/{k}/{name}"],
                                          err_msg=f"frame {k} {name}")
        worst, share = _u8_stats(frames[k], reference[f"viz/frame/{k}"])
        print(f"visualizer realtime frame {k}: max {worst} u8 steps on {share:.4%}")
        assert worst <= 1 and share < 0.02
    assert float(uniforms[-1]["iAudioVolume"]) > 0 and frames[-1].std() > 5


def test_mandelbrot_realtime_matches_jax(reference):
    """Mandelbrot through the realtime frame path: bit-equal."""
    fractals = _import_example("torch", "torch_fractals")
    _, frames, _ = _port_realtime(fractals.Mandelbrot)
    for k in range(REALTIME_FRAMES):
        np.testing.assert_array_equal(frames[k], reference[f"mandelbrot/frame/{k}"],
                                      err_msg=f"frame {k}")


@pytest.mark.parametrize("repeat", [False, True], ids=["clamp", "repeat"])
@pytest.mark.parametrize("select", ["where", "channel0", "channel1"])
def test_lookup_nearest_1d_select_matches_jax(select, repeat):
    """One frame's (bins, 1, C) table over an index field, values bf16
    rounded and selected exactly: equal to the JAX package's per-frame
    lookup, with the channel picked by a mask or by index, clamped and
    repeated rows (the field runs outside [0, 1])."""
    import jax.numpy as jnp
    from shaderflow_tpu.ops import sampling as reference_sampling
    from shaderflow_tpu_torch.ops import sampling
    rng = np.random.default_rng(11)
    bins, channels = 115, 2
    table = (rng.random((bins, 1, channels), np.float32) * 900.0).astype(np.float32)
    field = rng.uniform(-0.3, 1.3, (27, 48)).astype(np.float32)
    mask = rng.random((1, 48)) < 0.5
    kwargs = ({"channel_where": mask} if select == "where"
              else {"channel": int(select[-1])})
    want = reference_sampling.lookup_nearest_1d_select(
        reference_sampling.Sampler2D(jnp.asarray(table), linear=False, repeat_x=False,
                                     repeat_y=repeat),
        jnp.asarray(field), out_dtype=jnp.bfloat16,
        **{k: jnp.asarray(v) if k == "channel_where" else v for k, v in kwargs.items()})
    got = sampling.lookup_nearest_1d_select(
        sampling.Sampler2D(torch.from_numpy(table), linear=False, repeat_x=False,
                           repeat_y=repeat),
        torch.from_numpy(field), out_dtype=torch.bfloat16,
        **{k: torch.from_numpy(v) if k == "channel_where" else v for k, v in kwargs.items()})
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == field.shape
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


# --------------------------------------------------------------------------- #
# The realtime loop

def test_main_without_output_runs_the_realtime_loop(monkeypatch):
    """main(output=None, device="cpu") runs the loop headless and ends on
    frame_limit; frameskip=False steps at most one period a frame."""
    monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", "none")
    fractals = _import_example("torch", "torch_fractals")
    from shaderflow_tpu_torch.scene import WindowBackend
    scene = fractals.Mandelbrot(backend=WindowBackend.Headless)
    scene.frame_limit = 4
    result = scene.main(width=32, height=18, fps=20, ssaa=2, frameskip=False, device="cpu")
    assert result is None and scene.realtime and scene.quit
    # frame_limit counts scene time; no frame steps more than a period, and a
    # tick after a late one steps less
    assert scene.frame >= 4 and scene._frame_counter >= 4
    assert 0 < scene.time <= scene._frame_counter / 20 + 1e-9
    assert scene._pending_preview == [] and scene.scheduler.tasks == [scene.vsync]


def test_realtime_visualizer_through_main(monkeypatch):
    """The visualizer's realtime run through main(): the textures are
    streamed and the loop ends on frame_limit."""
    monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", "none")
    demo = _import_example("torch", "torch_demo")
    from shaderflow_tpu_torch.scene import WindowBackend
    scene = demo.Visualizer(backend=WindowBackend.Headless)
    scene.frame_limit = 3
    scene.main(width=32, height=18, fps=10, ssaa=2, frameskip=False, device="cpu")
    assert scene._frame_counter >= 3 and scene.frame >= 3
    assert scene.engine._streamed_names == {"iSpectrogram", "iWaveform"}
    assert scene.audio.tell > 0


def test_micro_batch_controller_matches_jax(monkeypatch):
    """The auto micro-batch controller makes the JAX package's decisions
    on one scripted sequence of loop costs (over budget, a large miss,
    idle), and auto never batches a path without asynchronous display."""
    monkeypatch.delenv("SHADERFLOW_RT_BATCH", raising=False)
    from shaderflow_tpu.scene import ShaderScene as ReferenceScene
    from shaderflow_tpu.scene import WindowBackend as ReferenceBackend
    from shaderflow_tpu_torch.scene import ShaderScene, WindowBackend
    costs = [0.030] * 8 + [0.001] * 40 + [0.067] * 8 + [0.010] * 10 + [0.0005] * 30
    sizes = []
    for cls, backend in ((ReferenceScene, ReferenceBackend), (ShaderScene, WindowBackend)):
        scene = cls(backend=backend.Headless)
        scene.fps = 60.0
        seen = []
        for cost in costs:
            n = scene._rt_batch_size(auto_ok=True)
            seen.append(n)
            scene._rt_batch_feedback(cost * n, n)
        seen.append(scene._rt_batch_size(auto_ok=False))
        sizes.append(seen)
    assert sizes[0] == sizes[1]
    assert max(sizes[1]) == 8 and sizes[1][-1] == 1


def test_forced_micro_batch_is_honoured(monkeypatch):
    """SHADERFLOW_RT_BATCH=3: three frames a flush in the headless loop
    (the last flush cut to frame_limit), the feedback a no-op."""
    monkeypatch.setenv("SHADERFLOW_RT_BATCH", "3")
    from shaderflow_tpu_torch.scene import ShaderScene, WindowBackend
    scene = ShaderScene(backend=WindowBackend.Headless)
    assert scene._rt_batch_size(auto_ok=False) == 3
    scene._rt_batch_feedback(1.0, 3)
    assert scene._rt_batch_size(auto_ok=True) == 3
    scene.frame_limit = 7
    scene.initialize()
    calls = []
    flush = scene.engine.flush
    scene.engine.flush = lambda *a, **k: (calls.append(a[0]), flush(*a, **k))[1]
    scene.main(width=32, height=16, fps=60, frameskip=False, device="cpu")
    assert calls[0] == 3 and sum(calls) == scene._frame_counter >= 7
    assert scene.vsync.frequency == pytest.approx(60.0 / calls[-1])


def test_hot_reload_recompiles_on_the_next_frame(tmp_path, monkeypatch):
    """An edited .frag recompiles on the next realtime frame; a broken
    edit writes the error report and resolves to missing_fragment."""
    monkeypatch.setenv("SHADERFLOW_HOME", str(tmp_path / "home"))
    import shaderflow_tpu_torch
    from shaderflow_tpu_torch.scene import ShaderScene, WindowBackend
    from shaderflow_tpu_torch.shader import missing_fragment
    monkeypatch.setattr(shaderflow_tpu_torch, "directories",
                        shaderflow_tpu_torch._Directories())
    source = tmp_path / "scene.frag"
    source.write_text("void main() { fragColor = vec4(1.0, 0.0, 0.0, 1.0); }\n")

    class Watched(ShaderScene):
        def build(self):
            self.shader.fragment = source

    scene = Watched(backend=WindowBackend.Headless)
    scene._setup_run(width=16, height=8, fps=10, device="cpu")

    def frame():
        scene.engine.begin_batch()
        scene.next(dt=0.1)
        return scene.engine.flush(1)[0].numpy()

    assert tuple(frame()[0, 0]) == (255, 0, 0)
    stamp = source.stat().st_mtime
    source.write_text("void main() { fragColor = vec4(0.0, 0.0, 1.0, 1.0); }\n")
    os.utime(source, (stamp + 5, stamp + 5))
    assert tuple(frame()[0, 0]) == (0, 0, 255)
    source.write_text("void main() { fragColor = vec4(0.0, 1.0, \n")
    os.utime(source, (stamp + 10, stamp + 10))
    frame()
    assert scene.shader.fragment is missing_fragment
    reports = list((tmp_path / "home" / "logs").glob("*-error.md"))
    assert len(reports) == 1 and "Shader build error" in reports[0].read_text()


def test_cli_realtime_launch(tmp_path, monkeypatch):
    """`python -m shaderflow_tpu_torch <file> <Scene> main` without -o
    reaches the realtime loop (with --device cpu here: no card) and ends
    on the scene's frame_limit."""
    monkeypatch.setenv("WINDOW_BACKEND", "headless")
    scene_file = tmp_path / "short_scene.py"
    scene_file.write_text(
        "from shaderflow_tpu_torch.scene import ShaderScene\n"
        "RAN = []\n"
        "class Short(ShaderScene):\n"
        "    frame_limit = 3\n"
        "    def update(self):\n"
        "        RAN.append((self.realtime, self._frame_counter))\n")
    from shaderflow_tpu_torch import cli
    cli.main([str(scene_file), "Short", "main", "-w", "32", "-h", "18", "-f", "10",
              "--no-frameskip", "--device", "cpu"])
    ran = sys.modules["short_scene"].RAN
    assert ran[:3] == [(True, 0), (True, 1), (True, 2)] and all(realtime for realtime, _ in ran)


def test_realtime_on_cuda_without_card_raises():
    """The realtime loop never falls back to the CPU either."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card refusal")
    from shaderflow_tpu_torch.scene import ShaderScene, WindowBackend
    scene = ShaderScene(backend=WindowBackend.Headless)
    scene.frame_limit = 2
    with pytest.raises(RuntimeError, match="cuda"):
        scene.main(width=32, height=18, fps=10)
