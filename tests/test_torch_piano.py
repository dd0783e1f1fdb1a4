"""The piano-roll slice of the PyTorch port against the JAX package: the MIDI
parser (shaderflow_tpu_torch/piano/midi.py), the ShaderPiano note scan and
its precomputed sequences and note-range replay (piano/module.py), and the
PianoRoll scene (examples/torch/torch_piano_roll.py) exported at 192x108,
ssaa=1 (the equal-resolution regime: K1's quantize=False form, the 3-tap
stencil, the u8 quantize) against the JAX package's fused path."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_scene import _import_example

REPO = Path(__file__).resolve().parent.parent
MIDI = REPO / "examples" / "assets" / "arpeggio.mid"
WIDTH, HEIGHT, FPS, SECONDS = 192, 108, 10, 0.5
FRAMES = round(FPS * SECONDS)


def test_midi_parse_matches_jax(tmp_path):
    """arpeggio.mid parses to the same notes (pitch, start, end, channel,
    velocity) and tempo changes; a file written by either writer reads back
    the same through both parsers."""
    from shaderflow_tpu.piano import midi as jax_midi
    from shaderflow_tpu_torch.piano import midi

    ours, theirs = midi.load_midi(MIDI), jax_midi.load_midi(MIDI)
    assert len(ours.notes) == len(theirs.notes) > 40
    assert [vars(n) for n in ours.notes] == [vars(n) for n in theirs.notes]
    assert ours.tempo_changes == theirs.tempo_changes and ours.duration == theirs.duration
    notes = [midi.MidiNote(pitch=60 + k, start=0.3 * k, end=0.3 * k + 0.2, channel=k % 3,
                           velocity=40 + 9 * k) for k in range(8)]
    midi.write_midi(tmp_path / "ours.mid", notes, bpm=97.0)
    jax_midi.write_midi(tmp_path / "theirs.mid", [jax_midi.MidiNote(**vars(n)) for n in notes],
                        bpm=97.0)
    assert (tmp_path / "ours.mid").read_bytes() == (tmp_path / "theirs.mid").read_bytes()
    assert ([vars(n) for n in midi.load_midi(tmp_path / "theirs.mid").notes]
            == [vars(n) for n in jax_midi.load_midi(tmp_path / "ours.mid").notes])


@pytest.mark.parametrize("fps,seconds", [(10, 0.5), (60, 2.0)])
def test_piano_sequences_match_jax(monkeypatch, fps, seconds):
    """The whole-run note scan of both packages' PianoRoll: the keys,
    channel and roll sequences ((F, 1, 128, 1), (F, 1, 128, 1), (F, 128,
    256, 4), float32 host numpy, roll rows reversed into storage order) and
    the recorded note range, bit for bit — including frame 0's dt == 0
    step; the bound sequences are padded to the same length."""
    from test_torch_scene import _fix_reference_texture
    _fix_reference_texture(monkeypatch)
    jax_scene = _import_example("basic", "piano_roll").PianoRoll()
    port = _import_example("torch", "torch_piano_roll").PianoRoll()
    for scene, device in ((jax_scene, None), (port, "cpu")):
        kwargs = {} if device is None else {"device": device}
        scene._setup_run(width=96, height=54, fps=fps, time=seconds, freewheel=True, **kwargs)
        scene.piano._precompute_sequences()
    frames = round(fps * seconds)
    names = ("keys", "channels", "roll", "ranges")
    for name, ours, theirs in zip(names, port.piano._sequence_arrays,
                                  jax_scene.piano._sequence_arrays):
        assert ours.shape[0] == frames and ours.dtype == theirs.dtype == np.float32
        np.testing.assert_array_equal(ours, theirs, err_msg=name)
    np.testing.assert_array_equal(port.piano._range_values, jax_scene.piano._range_values)
    roll = port.piano._sequence_arrays[2]
    assert roll[..., 3].max() > 0 and (port.piano._sequence_arrays[0] > 0).any()
    for ours, theirs in ((port.piano.keys_texture, jax_scene.piano.keys_texture),
                         (port.piano.roll_texture, jax_scene.piano.roll_texture)):
        assert tuple(ours.sequence.shape) == tuple(np.shape(theirs.sequence))
        assert ours.resolution == theirs.resolution


def test_piano_replay_and_carried_state():
    """update() replays the recorded note range frame by frame; state loaded
    through load_state (the engine's load_reference_state) replaces the
    computed arrays, and unknown names are refused."""
    from shaderflow_tpu_torch.engine import load_reference_state
    scene = _import_example("torch", "torch_piano_roll").PianoRoll()
    scene._setup_run(width=64, height=36, fps=10, time=0.5, freewheel=True, device="cpu")
    scene.piano.prewarm()
    ranges = scene.piano._range_values.copy()
    scene.engine.begin_batch()
    for frame in range(3):
        scene.next(dt=scene.frametime)
        np.testing.assert_array_equal(scene.piano.note_range_dynamics.value, ranges[frame])
    carried = ranges + 1.5
    load_reference_state(scene, modules={"iPiano": {"ranges": carried}})
    scene.piano.prewarm()
    np.testing.assert_array_equal(scene.piano._range_values, carried)
    with pytest.raises(KeyError, match="tempo"):
        scene.piano.load_state({"tempo": np.zeros(2)})


JAX_SCRIPT = """
import os
import sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())
piano_roll = _import_example("basic", "piano_roll")
for mode in ("fused", "plain"):
    os.environ["SHADERFLOW_TAILFUSE_INTERPRET"] = "1" if mode == "fused" else "0"
    scene = piano_roll.PianoRoll()
    scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=1, time=SECONDS,
               output=f"{TMP}/jax_{mode}.rgb")
engine = scene.engine
np.savez(f"{TMP}/state.npz", ranges=np.asarray(scene.piano._range_values),
         **{"sequence/" + name: np.asarray(value) for name, value in engine._sequences.items()})
np.savez(f"{TMP}/uniforms.npz", **{f"{index}/{name}": value
                                  for index, frame in enumerate(engine._frame_uniforms)
                                  for name, value in frame.items()})
"""


def _read_rgb(path: Path) -> np.ndarray:
    return np.fromfile(path, np.uint8).reshape(-1, HEIGHT, WIDTH, 3)


def _u8_stats(got: np.ndarray, want: np.ndarray) -> tuple:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    mse = float(np.mean(diff.astype(np.float64) ** 2))
    psnr = float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
    return int(diff.max()), float((diff != 0).mean()), psnr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX PianoRoll at 192x108, ssaa=1, 10 fps, 0.5 s in a child on
    XLA:CPU capped at the AVX ISA (no FMA), twice: through its fused path
    (SHADERFLOW_TAILFUSE_INTERPRET=1: the Pallas kernel in interpret mode
    writes bf16 planes, then the bf16 stencil — the path the reference
    takes on its accelerator) and through its plain path (the f32 tail and
    f32 stencil it takes on a CPU). Then two CPU exports of the port: one
    independent, one with the JAX sequences and note range carried across."""
    tmp = tmp_path_factory.mktemp("piano")
    script = (f"TESTS, TMP = {str(REPO / 'tests')!r}, {str(tmp)!r}\n"
              f"WIDTH, HEIGHT, FPS, SECONDS = {WIDTH}, {HEIGHT}, {FPS}, {SECONDS}\n"
              + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stderr[-4000:]
    piano = _import_example("torch", "torch_piano_roll")
    from shaderflow_tpu_torch.engine import load_reference_state
    port = piano.PianoRoll()
    port.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=1, time=SECONDS,
              output=str(tmp / "torch.rgb"), device="cpu")
    state = dict(np.load(tmp / "state.npz"))
    sequences = {name[len("sequence/"):]: torch.from_numpy(value)
                 for name, value in state.items() if name.startswith("sequence/")}
    carried = piano.PianoRoll()
    load_reference_state(carried, sequences=sequences,
                         modules={"iPiano": {"ranges": state["ranges"]}})
    carried.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=1, time=SECONDS,
                 output=str(tmp / "carried.rgb"), device="cpu")
    uniforms = {}
    for key, value in np.load(tmp / "uniforms.npz").items():
        index, name = key.split("/", 1)
        uniforms.setdefault(int(index), {})[name] = value
    return dict(port=port, sequences=sequences, uniforms=[uniforms[i] for i in sorted(uniforms)],
                fused=_read_rgb(tmp / "jax_fused.rgb"), plain=_read_rgb(tmp / "jax_plain.rgb"),
                torch=_read_rgb(tmp / "torch.rgb"), carried=_read_rgb(tmp / "carried.rgb"))


def test_piano_roll_uniforms_and_sequences_match_jax(runs):
    """Every captured uniform of every frame (the replayed note range
    included) and the bound device sequences (iPianoKeys, iPianoChan,
    iPianoRoll, and the iSpectrogram glow within the spectral tolerance of
    1e-5 of its largest value: the FFTs differ)."""
    port = runs["port"]
    frames = port.engine._frame_uniforms
    assert len(frames) == len(runs["uniforms"]) == FRAMES
    for ref, got in zip(runs["uniforms"], frames):
        assert sorted(ref) == sorted(got)
        for name in ref:
            np.testing.assert_array_equal(np.asarray(got[name]), ref[name], err_msg=name)
    bound = port.engine.bound_sequences()
    assert sorted(bound) == sorted(runs["sequences"]) == [
        "iPianoChan", "iPianoKeys", "iPianoRoll", "iSpectrogram"]
    for name, want in runs["sequences"].items():
        got = bound[name]
        assert tuple(got.shape) == tuple(want.shape), name
        if name == "iSpectrogram":
            error = (got - want).abs().max() / want.abs().max()
            assert error <= 1e-5
        else:
            assert torch.equal(got, want), name


def test_piano_roll_frames_match_jax(runs):
    """The frames against the JAX package's fused path: independent runs,
    and with the JAX sequences and note range carried across
    (engine.load_reference_state), each at most one u8 step on < 1 % of
    values (measured: equal bit for bit — the port's plain stencil does the
    reference's compiled bf16 arithmetic). Against the JAX plain path (f32
    tail and stencil) the frames differ by the bf16 planes' rounding,
    within the JAX package's own bar between its two paths: 2 u8 steps
    (tests/test_tailfuse.py:190-238)."""
    assert runs["torch"].shape == runs["fused"].shape == (FRAMES, HEIGHT, WIDTH, 3)
    assert runs["torch"].std() > 10
    for kind in ("torch", "carried"):
        max_diff, share, psnr = _u8_stats(runs[kind], runs["fused"])
        print(f"PianoRoll {kind} vs JAX fused: max {max_diff} u8 steps on {share:.4%}, "
              f"PSNR {psnr:.2f} dB")
        assert max_diff <= 1 and share < 0.01, kind
    max_diff, share, psnr = _u8_stats(runs["torch"], runs["plain"])
    print(f"PianoRoll torch vs JAX plain (f32 stencil): max {max_diff} u8 steps on "
          f"{share:.4%}, PSNR {psnr:.2f} dB")
    assert max_diff <= 2
