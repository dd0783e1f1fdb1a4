"""The live piano of the PyTorch port against the JAX package: ShaderPiano's
per-frame note scan (its roll, channels and both dynamics), the per-frame
path an export takes with `precompute=False` (the three textures streamed,
one snapshot a frame) against the precomputed export and against the JAX
package's own per-frame export, the PianoRoll scene in the realtime loop
frame by frame, and the FluidSynth hooks through a stub `fluidsynth`
module (their calls logged and held equal to the JAX module's), warning
where the module or the binary is missing.

The JAX side of the frame comparisons runs in a child interpreter on
XLA:CPU capped at the AVX ISA (no FMA contraction) with
SHADERFLOW_TAILFUSE_INTERPRET=1 (its fused path: bf16 planes, then the
bf16 stencil, as tests/test_torch_piano.py holds the offline PianoRoll)."""

import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
from test_torch_scene import _fix_reference_texture, _import_example

REPO = Path(__file__).resolve().parent.parent
WIDTH, HEIGHT, FPS, SECONDS = 96, 54, 10, 0.5
EXPORT_FRAMES = round(FPS * SECONDS)
RT_FRAMES, RT_DT = 8, 1.0 / 60.0
SCAN_FRAMES = 30


def scan_times():
    """30 frames over the arpeggio's first 1.5 s, crossing note starts and
    ends (frame 0 steps with dt == 0)."""
    return [(0.2 + 0.05 * f, 0.05 if f else 0.0) for f in range(SCAN_FRAMES)]


def piano_scenes(monkeypatch):
    """Both packages' PianoRoll set up for the realtime loop (no output)."""
    _fix_reference_texture(monkeypatch)
    monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", "none")
    jax_scene = _import_example("basic", "piano_roll").PianoRoll()
    port = _import_example("torch", "torch_piano_roll").PianoRoll()
    return jax_scene, port


def setup_realtime(scene, port: bool, **kwargs):
    scene._setup_run(width=32, height=18, fps=60, ssaa=1,
                     **({"device": "cpu"} if port else {}), **kwargs)


def test_scan_frame_matches_jax(monkeypatch):
    """_scan_frame over 30 frames: the roll (128, 256, 4), the channels,
    the key-press dynamics and the note range equal to the JAX module's,
    bit for bit, frame by frame."""
    monkeypatch.setitem(sys.modules, "fluidsynth", None)
    jax_scene, port = piano_scenes(monkeypatch)
    for scene, is_port in ((jax_scene, False), (port, True)):
        setup_realtime(scene, is_port)
    seen_keys = 0
    for time, dt in scan_times():
        want = jax_scene.piano._scan_frame(time, dt)
        got = port.piano._scan_frame(time, dt)
        for name, a, b in zip(("roll", "channels"), got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), (name, time)
        for name in ("key_press_dynamics", "note_range_dynamics"):
            a = getattr(port.piano, name).value
            b = getattr(jax_scene.piano, name).value
            assert np.array_equal(a, b), (name, time)
        seen_keys += int((port.piano.key_press_dynamics.value > 0).any())
    assert seen_keys > 10 and port.piano._playing_matrix is not None


class SynthLog:
    """A stand-in `fluidsynth` module: Synth() records every call."""

    def __init__(self):
        self.calls = []
        log = self.calls

        class Synth:
            def __init__(self):
                log.append(("Synth",))

            def setting(self, key, value):
                log.append(("setting", key, value))

            def start(self):
                log.append(("start",))

            def sfload(self, path):
                log.append(("sfload", Path(path).name))
                return 1

            def program_select(self, channel, soundfont, bank, preset):
                log.append(("program_select", channel, soundfont, bank, preset))

            def noteon(self, channel, note, velocity):
                log.append(("noteon", channel, note, velocity))

            def noteoff(self, channel, note):
                log.append(("noteoff", channel, note))

        self.module = types.SimpleNamespace(Synth=Synth)


def fluid_run(scene, is_port, monkeypatch):
    """A realtime run with the stub synth and a soundfont: setup
    starts the synth and loads the soundfont, then 40 frames of update()
    on a fixed clock sound the notes; then every note off, then one note
    outside realtime (not sounded)."""
    log = SynthLog()
    monkeypatch.setitem(sys.modules, "fluidsynth", log.module)
    scene.initialize()
    scene.piano.soundfont_file = "piano.sf2"
    setup_realtime(scene, is_port)
    for frame in range(40):
        scene.time, scene.dt = 0.1 + frame * 0.06, 0.06
        scene.piano.update()
    scene.piano.fluid_all_notes_off()
    scene.realtime = False
    scene.piano.fluid_key_down(60, 100, 0)
    return log.calls


def test_fluidsynth_stub_log_matches_jax(monkeypatch):
    """The stub synth's log (start, the soundfont's program_select on 32
    channels, every noteon / noteoff of the scan) equals the JAX module's."""
    jax_scene, port = piano_scenes(monkeypatch)
    want = fluid_run(jax_scene, False, monkeypatch)
    got = fluid_run(port, True, monkeypatch)
    assert got == want
    kinds = [call[0] for call in got]
    assert kinds[:4] == ["Synth", "setting", "start", "sfload"]
    assert kinds.count("program_select") == 32
    assert kinds.count("noteon") >= 10 and kinds.count("noteoff") > 32 * 128
    assert port.piano.fluidsynth is not None
    assert "synth: live" in list(port.piano.ui())


def test_fluidsynth_missing_warns(monkeypatch):
    """Without pyfluidsynth or the binary the hooks warn and the scene
    runs silent: no exception, no synth."""
    from shaderflow_tpu_torch.piano import module as piano_module
    warnings = []
    monkeypatch.setattr(piano_module.logger, "warn", lambda message: warnings.append(message))
    monkeypatch.setitem(sys.modules, "fluidsynth", None)
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", "none")
    scene = _import_example("torch", "torch_piano_roll").PianoRoll()
    setup_realtime(scene, True)
    scene.piano.fluid_install()
    for frame in range(5):
        scene.time, scene.dt = 0.2 * frame, 0.2
        scene.piano.update()
    scene.piano.fluid_all_notes_off()
    assert scene.piano.fluidsynth is None
    assert any("pyfluidsynth" in text for text in warnings)
    assert any("binary" in text for text in warnings)


JAX_SCRIPT = """
import os, sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
os.environ["SHADERFLOW_AUDIO_BACKEND"] = "none"
os.environ["SHADERFLOW_TAILFUSE_INTERPRET"] = "1"
sys.modules["fluidsynth"] = None
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())
from shaderflow_tpu.scene import WindowBackend
piano_roll = _import_example("basic", "piano_roll")
results = {}
scene = piano_roll.PianoRoll(backend=WindowBackend.Headless)
scene.initialize()
scene.piano.precompute = False
scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=1, time=SECONDS, output=f"{TMP}/stream.rgb")
results["stream"] = np.fromfile(f"{TMP}/stream.rgb", np.uint8)
scene = piano_roll.PianoRoll(backend=WindowBackend.Headless)
scene._setup_run(width=WIDTH, height=HEIGHT, fps=60, ssaa=1)
for k in range(FRAMES_RT):
    scene.engine.begin_batch()
    scene.next(dt=DT)
    results[f"rt/frame/{k}"] = np.asarray(scene.engine.flush(1))[0]
    for key, value in scene.engine._frame_uniforms[0].items():
        results[f"rt/uniform/{k}/{key}"] = np.asarray(value)
np.savez(OUTPUT, **results)
"""


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The JAX package's per-frame export (precompute=False) and realtime
    frames, in one AVX child."""
    tmp = tmp_path_factory.mktemp("piano_live")
    script = (f"TESTS, TMP, OUTPUT = {str(REPO / 'tests')!r}, {str(tmp)!r}, "
              f"{str(tmp / 'jax.npz')!r}\n"
              f"WIDTH, HEIGHT, FPS, SECONDS, FRAMES_RT, DT = {WIDTH}, {HEIGHT}, {FPS}, "
              f"{SECONDS}, {RT_FRAMES}, {RT_DT!r}\n" + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp), WINDOW_BACKEND="headless")
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stderr[-4000:]
    return dict(np.load(tmp / "jax.npz"))


def u8_stats(got: np.ndarray, want: np.ndarray) -> tuple:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(diff.max()), float((diff != 0).mean())


def export(tmp_path, precompute: bool, monkeypatch):
    monkeypatch.setitem(sys.modules, "fluidsynth", None)
    scene = _import_example("torch", "torch_piano_roll").PianoRoll()
    scene.initialize()
    scene.piano.precompute = precompute
    output = tmp_path / f"precompute_{precompute}.rgb"
    scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=1, time=SECONDS,
               output=str(output), device="cpu")
    return scene, np.fromfile(output, np.uint8).reshape(-1, HEIGHT, WIDTH, 3)


def test_precompute_false_streams_and_equals_precomputed(tmp_path, monkeypatch):
    """precompute=False changes the path: the three piano textures are
    streamed (no device sequence bound), and the frames are bit-equal to
    the precomputed export's."""
    streamed_scene, streamed = export(tmp_path, False, monkeypatch)
    precomputed_scene, precomputed = export(tmp_path, True, monkeypatch)
    names = {"iPianoKeys", "iPianoRoll", "iPianoChan"}
    assert names <= streamed_scene.engine._streamed_names
    assert not names & set(streamed_scene.engine.bound_sequences(streamed_scene.engine.state))
    assert names <= set(precomputed_scene.engine.bound_sequences(
        precomputed_scene.engine.state))
    assert streamed.shape == (EXPORT_FRAMES, HEIGHT, WIDTH, 3) and streamed.std() > 10
    assert np.array_equal(streamed, precomputed)


def test_precompute_false_matches_jax(tmp_path, monkeypatch, reference):
    """The per-frame export against the JAX package's per-frame export:
    at most one u8 step on < 1 % of values (the piano's bar)."""
    _, streamed = export(tmp_path, False, monkeypatch)
    want = reference["stream"].reshape(-1, HEIGHT, WIDTH, 3)
    max_diff, share = u8_stats(streamed, want)
    print(f"PianoRoll precompute=False vs JAX: max {max_diff} u8 steps on {share:.4%}")
    assert max_diff <= 1 and share < 0.01


def test_realtime_pianoroll_matches_jax(monkeypatch, reference):
    """The PianoRoll driven as the realtime loop drives it (next(dt),
    flush(1)) at 96x54, ssaa 1, on device="cpu": every uniform equal and
    every frame within the piano's bar of the JAX package's; the three
    piano textures streamed."""
    from shaderflow_tpu_torch.scene import WindowBackend
    monkeypatch.setitem(sys.modules, "fluidsynth", None)
    monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", "none")
    scene = _import_example("torch", "torch_piano_roll").PianoRoll(
        backend=WindowBackend.Headless)
    scene._setup_run(width=WIDTH, height=HEIGHT, fps=60, ssaa=1, device="cpu")
    worst = (0, 0.0)
    for k in range(RT_FRAMES):
        scene.engine.begin_batch()
        scene.next(dt=RT_DT)
        frame = scene.engine.flush(1)[0].numpy()
        for key, value in scene.engine._frame_uniforms[0].items():
            np.testing.assert_array_equal(np.asarray(value),
                                          reference[f"rt/uniform/{k}/{key}"], err_msg=key)
        max_diff, share = u8_stats(frame, reference[f"rt/frame/{k}"])
        worst = max(worst, (max_diff, share))
        assert max_diff <= 1 and share < 0.01, (k, max_diff, share)
    print(f"realtime PianoRoll vs JAX: worst max {worst[0]} u8 steps on {worst[1]:.4%}")
    assert {"iPianoKeys", "iPianoRoll", "iPianoChan"} <= scene.engine._streamed_names
    assert frame.std() > 10


def test_micro_batch_frames_keep_their_own_snapshots(monkeypatch):
    """Three frames captured into one flush (a realtime micro-batch) equal
    the same three frames flushed one by one: each frame of a batch reads
    its own snapshot of the three piano textures, not the last write."""
    from shaderflow_tpu_torch.scene import WindowBackend
    monkeypatch.setitem(sys.modules, "fluidsynth", None)
    monkeypatch.setenv("SHADERFLOW_AUDIO_BACKEND", "none")
    piano_roll = _import_example("torch", "torch_piano_roll")
    runs = []
    for batch in (1, 3):
        scene = piano_roll.PianoRoll(backend=WindowBackend.Headless)
        scene._setup_run(width=WIDTH, height=HEIGHT, fps=60, ssaa=1, device="cpu")
        frames = []
        for _ in range(6 // batch):
            scene.engine.begin_batch()
            for _ in range(batch):
                scene.next(dt=0.1)
            frames.extend(scene.engine.flush(batch).numpy())
        runs.append(np.stack(frames))
    assert np.array_equal(runs[0], runs[1])
    assert len({frame.tobytes() for frame in runs[1]}) == 6
