"""Non-WAV audio in the PyTorch port: AudioReader's ffmpeg decode pipe
(shaderflow_tpu_torch/io/ffmpeg.py) against the JAX package's on the same
stub decoder. The tests need no ffmpeg binary: a stub `ffmpeg` and
`ffprobe` pair on PATH (make_stub_audio) replays seeded float32 PCM as
ffmpeg's f32le pipe would, and answers the probes; the port's code path is
its real pipe. Bytes and chunks are held equal; frames to ROADMAP's bars."""

import json
import os
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
from test_torch_scene import _import_example

REPO = Path(__file__).resolve().parent.parent
RATE, CHANNELS, SECONDS = 44100, 2, 1.3

STUB_FFMPEG = r'''#!{python}
import json, sys
from pathlib import Path
here = Path(__file__).parent
args = sys.argv[1:]
with open(here / "calls.jsonl", "a") as log:
    log.write(json.dumps(args) + "\n")
target = args[-1]
if "f32le" not in args:
    # An encode (rawvideo on stdin), a concat or a stream copy: drain the
    # input, answer with a marker and the byte count
    piped = "-i" in args and args[args.index("-i") + 1] == "-"
    data = sys.stdin.buffer.read() if piped else b""
    payload = b"STUB" + len(data).to_bytes(8, "little")
    if target == "-":
        sys.stdout.buffer.write(payload)
    elif "://" not in target:
        Path(target).write_bytes(payload)
    sys.exit(0)
# A decode to f32le PCM on stdout: replay the premade samples
pcm = memoryview((here / "pcm.f32").read_bytes())
out = sys.stdout.buffer
try:
    for start in range(0, len(pcm), 65536):
        out.write(pcm[start:start + 65536])
    out.flush()
except BrokenPipeError:
    pass
'''

STUB_FFPROBE = r'''#!{python}
import json, sys
from pathlib import Path
meta = json.loads((Path(__file__).parent / "meta.json").read_text())
entries = sys.argv[sys.argv.index("-show_entries") + 1]
answers = {{"stream=sample_rate": str(meta["rate"]), "stream=channels": str(meta["channels"]),
           "format=duration": str(meta["frames"] / meta["rate"])}}
if "width" in meta:
    answers["stream=width,height"] = f"{{meta['width']}},{{meta['height']}}"
if entries in answers:
    print(answers[entries])
'''


def make_stub_audio(directory: Path, samples: np.ndarray, rate: int, **video) -> Path:
    """A stub `ffmpeg` and `ffprobe` in `directory`: a decode replays
    `samples` (frames, channels) as f32le PCM; the probes answer its rate,
    channels and duration (and `width`, `height` when given); an encode,
    concat or stream copy drains its input and writes b"STUB" + the byte
    count to its output (stdout for "-", a file path, nothing for a URL).
    Every call's arguments go to calls.jsonl."""
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "pcm.f32").write_bytes(np.ascontiguousarray(samples, "<f4").tobytes())
    (directory / "meta.json").write_text(json.dumps(
        dict(rate=rate, channels=samples.shape[1], frames=samples.shape[0], **video)))
    for name, source in (("ffmpeg", STUB_FFMPEG), ("ffprobe", STUB_FFPROBE)):
        path = directory / name
        path.write_text(source.format(python=sys.executable))
        path.chmod(0o755)
    return directory


def stub_calls(directory: Path) -> list:
    log = directory / "calls.jsonl"
    return [json.loads(line) for line in log.read_text().splitlines()] if log.exists() else []


def clear_ffmpeg_caches() -> None:
    """FFmpeg's lru caches of both packages (binary lookups and probes)."""
    from shaderflow_tpu.io.ffmpeg import FFmpeg as Reference
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    for ffmpeg in (FFmpeg, Reference):
        for name in ("binary", "ffprobe", "get_audio_samplerate", "get_audio_channels",
                     "get_video_resolution"):
            getattr(ffmpeg, name).cache_clear()


def seeded_pcm(seconds: float = SECONDS, seed: int = 11) -> np.ndarray:
    rng = np.random.default_rng(seed)
    frames = int(seconds * RATE)
    t = np.arange(frames) / RATE
    tone = 0.3 * np.sin(2 * np.pi * 220.0 * t)[:, None]
    return (tone + 0.05 * rng.standard_normal((frames, CHANNELS))).astype(np.float32)


@pytest.fixture
def stub(tmp_path, monkeypatch):
    """The stub decoder first on PATH, replaying seeded_pcm(); the caches
    cleared on the way in and out."""
    samples = seeded_pcm()
    directory = make_stub_audio(tmp_path / "bin", samples, RATE)
    monkeypatch.setenv("PATH", f"{directory}{os.pathsep}{os.environ['PATH']}")
    clear_ffmpeg_caches()
    source = tmp_path / "song.mp3"
    source.write_bytes(b"not audio: the stub decoder replays its own samples")
    yield directory, source, samples
    monkeypatch.undo()
    clear_ffmpeg_caches()


def _chunks(reader_class, path, chunk):
    """Every chunk of reader_class(path).stream; `chunk` a float, or a list
    of values set before each read (the realtime loop sets the frame's dt)."""
    reader = reader_class(path=path, chunk=chunk if isinstance(chunk, float) else chunk[0])
    out = []
    for index, data in enumerate(reader.stream):
        out.append(np.array(data))
        if not isinstance(chunk, float):
            reader.chunk = chunk[(index + 1) % len(chunk)]
    return out, reader.read


@pytest.mark.parametrize("chunk", [0.1, 1 / 60, 0.37, [1 / 60, 1 / 24, 0.05, 0.2]],
                         ids=["0.1", "1/60", "0.37", "changing"])
def test_chunks_match_jax(stub, chunk):
    """The port's chunks from the pipe equal the JAX reader's, chunk by
    chunk (the lengths follow the byte count, trailing bytes included), and
    join to the stub's samples."""
    from shaderflow_tpu.io.ffmpeg import AudioReader as Reference
    from shaderflow_tpu_torch.io.ffmpeg import AudioReader, FFmpeg
    directory, source, samples = stub
    assert FFmpeg.binary() == str(directory / "ffmpeg")
    got, got_read = _chunks(AudioReader, source, chunk)
    want, want_read = _chunks(Reference, source, chunk)
    assert len(got) == len(want) > 3
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert got_read == want_read == samples.nbytes
    np.testing.assert_array_equal(np.concatenate(got), samples)


def test_get_audio_numpy_and_probes_match_jax(stub):
    """A non-WAV file's rate, channels and duration come from ffprobe, and
    the whole decode equals the JAX package's."""
    from shaderflow_tpu.io.ffmpeg import FFmpeg as Reference
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    _, source, samples = stub
    for ffmpeg in (FFmpeg, Reference):
        assert ffmpeg.get_audio_samplerate(source) == RATE
        assert ffmpeg.get_audio_channels(source) == CHANNELS
        assert ffmpeg.get_audio_duration(source) == samples.shape[0] / RATE
    got, want = FFmpeg.get_audio_numpy(source), Reference.get_audio_numpy(source)
    assert got.shape == want.shape == samples.shape
    np.testing.assert_array_equal(got, want)


def test_decoder_is_reaped_after_break(stub):
    """A consumer that stops early (break) ends the decoder: the child is
    killed and waited for when the generator closes."""
    from shaderflow_tpu_torch.io.ffmpeg import AudioReader
    _, source, _ = stub
    reader = AudioReader(path=source, chunk=0.05)
    processes = []
    for index, _ in enumerate(reader.stream):
        processes.append(reader._proc)
        if index == 2:
            break
    assert processes[0] is not None and len(set(map(id, processes))) == 1
    assert processes[0].returncode is not None
    assert reader._proc is None


def test_wav_takes_the_pipe_when_ffmpeg_exists(stub, tmp_path, monkeypatch):
    """As in the reference, a WAV file decodes through ffmpeg when the
    binary exists (its samples here are the stub's, not the file's), and
    through the stdlib only without it."""
    from shaderflow_tpu.io.ffmpeg import FFmpeg as Reference
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    directory, _, samples = stub
    path = tmp_path / "other.wav"
    own = (np.random.default_rng(5).uniform(-0.5, 0.5, (4410, CHANNELS)) * 32767).astype("<i2")
    with wave.open(str(path), "wb") as handle:
        handle.setnchannels(CHANNELS)
        handle.setsampwidth(2)
        handle.setframerate(RATE)
        handle.writeframes(own.tobytes())
    piped = FFmpeg.get_audio_numpy(path)
    np.testing.assert_array_equal(piped, Reference.get_audio_numpy(path))
    np.testing.assert_array_equal(piped, samples)
    decodes = [args for args in stub_calls(directory) if str(path) in args]
    assert decodes and decodes[-1][-6:] == ["-c:a", "pcm_f32le", "-f", "f32le", "-vn", "-"]
    monkeypatch.setenv("PATH", os.environ["PATH"].split(os.pathsep, 1)[1])
    clear_ffmpeg_caches()
    assert FFmpeg.binary() != str(directory / "ffmpeg")
    read = FFmpeg.get_audio_numpy(path)
    np.testing.assert_array_equal(read, Reference.get_audio_numpy(path))
    np.testing.assert_array_equal(read, own.astype(np.float32) / 32768.0)


def test_non_wav_without_ffmpeg_raises_as_jax(tmp_path, monkeypatch):
    """Without a decoder binary a non-WAV file raises wave.Error in both
    packages (the reference's stdlib fallback reads PCM WAV only)."""
    from shaderflow_tpu.io.ffmpeg import AudioReader as Reference
    from shaderflow_tpu.io.ffmpeg import FFmpeg as ReferenceFFmpeg
    from shaderflow_tpu_torch.io.ffmpeg import AudioReader, FFmpeg
    for ffmpeg in (FFmpeg, ReferenceFFmpeg):
        monkeypatch.setattr(ffmpeg, "binary", staticmethod(lambda: None))
        monkeypatch.setattr(ffmpeg, "ffprobe", staticmethod(lambda: None))
    source = tmp_path / "song.flac"
    source.write_bytes(b"fLaC but not really")
    for reader in (AudioReader, Reference):
        with pytest.raises(wave.Error):
            next(iter(reader(path=source).stream))


VISUALIZER = dict(width=128, height=72, fps=10, ssaa=2, time=0.5)

JAX_SCRIPT = """
import sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())

def host(value):
    value = np.asarray(value)
    if value.dtype.name == "bfloat16":   # keep the bits; numpy files lack the type
        return value.view(np.uint16), True
    return value, False

scene = _import_example("basic", "demo").Visualizer()
scene.audio_file = AUDIO
scene.main(output=OUTPUT, **OPTIONS)
engine = scene.engine
arrays = {}
for group, values in (("sequence", engine._sequences), ("texture", engine._static_tex)):
    for name, value in values.items():
        array, bf16 = host(value)
        arrays[f"{group}/{'bf16' if bf16 else 'f32'}/{name.replace(chr(0), '<NUL>')}"] = array
np.savez(STATE, **arrays)
np.savez(UNIFORMS, **{f"{index}/{name}": value
                      for index, frame in enumerate(engine._frame_uniforms)
                      for name, value in frame.items()})
"""


def test_visualizer_from_mp3_matches_jax(tmp_path, monkeypatch):
    """The visualizer exported from music.mp3 (the stub decoder replays the
    asset's samples) at 128x72, 2x SSAA: the port's frames equal its own
    export of music.wav bit for bit; its captured uniforms equal the JAX
    package's export of the same mp3 on the same stub; and with the JAX
    state carried across, its frames are within one u8 step on < 2 % of
    values (tests/test_torch_visualizer.py's bar)."""
    from test_torch_visualizer import _load_state, _u8_stats
    demo = _import_example("torch", "torch_demo")
    from shaderflow_tpu_torch.engine import load_reference_state
    wav_frames = tmp_path / "wav.rgb"
    demo.Visualizer().main(output=str(wav_frames), device="cpu", **VISUALIZER)

    import wave as wavelib
    with wavelib.open(str(demo.MUSIC), "rb") as handle:
        pcm = np.frombuffer(handle.readframes(handle.getnframes()), "<i2")
        pcm = (pcm.astype(np.float32) / 32768.0).reshape(-1, handle.getnchannels())
    directory = make_stub_audio(tmp_path / "bin", pcm, RATE)
    monkeypatch.setenv("PATH", f"{directory}{os.pathsep}{os.environ['PATH']}")
    clear_ffmpeg_caches()
    mp3 = tmp_path / "music.mp3"
    mp3.write_bytes(b"ID3 stub: the decoder replays music.wav's samples")
    try:
        script = (f"TESTS, OUTPUT = {str(REPO / 'tests')!r}, {str(tmp_path / 'jax.rgb')!r}\n"
                  f"STATE, UNIFORMS = {str(tmp_path / 'state.npz')!r}, "
                  f"{str(tmp_path / 'uniforms.npz')!r}\n"
                  f"AUDIO, OPTIONS = {str(mp3)!r}, {VISUALIZER!r}\n" + JAX_SCRIPT)
        env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
                   SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp_path))
        result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                                capture_output=True, text=True, timeout=300)
        assert result.returncode == 0, result.stderr[-4000:]
        port = demo.Visualizer()
        port.audio_file = mp3
        port.main(output=str(tmp_path / "mp3.rgb"), device="cpu", **VISUALIZER)
        carried = demo.Visualizer()
        carried.audio_file = mp3
        load_reference_state(carried, *_load_state(tmp_path / "state.npz"))
        carried.main(output=str(tmp_path / "carried.rgb"), device="cpu", **VISUALIZER)
    finally:
        monkeypatch.undo()
        clear_ffmpeg_caches()
    assert any(str(mp3) in args for args in stub_calls(directory))

    def read(name):
        return np.fromfile(tmp_path / name, np.uint8).reshape(-1, 72, 128, 3)

    assert read("mp3.rgb").shape == (5, 72, 128, 3) and read("mp3.rgb").std() > 10
    np.testing.assert_array_equal(read("mp3.rgb"), read("wav.rgb"))
    reference = {}
    for key, value in np.load(tmp_path / "uniforms.npz").items():
        index, name = key.split("/", 1)
        reference.setdefault(int(index), {})[name] = value
    captured = port.engine._frame_uniforms
    assert len(captured) == len(reference) == 5
    for index, frame in enumerate(captured):
        for name, want in reference[index].items():
            np.testing.assert_array_equal(np.asarray(frame[name]), want, err_msg=name)
    max_diff, share, psnr = _u8_stats(read("carried.rgb"), read("jax.rgb"))
    print(f"mp3, carried state: max {max_diff} u8 steps on {share:.4%}, PSNR {psnr:.2f} dB")
    assert max_diff <= 1 and share < 0.02, (max_diff, share)
