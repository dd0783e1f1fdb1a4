"""The JAX package's run-time switches in the PyTorch port, each against the
JAX package on the CPU, and config 5's A/V mux:

  SHADERFLOW_PIPELINE_DEPTH   batches in flight in the export loop; the
                              default from the JAX package's budget
  SHADERFLOW_BATCH_TRACE      one BATCH_TRACE line a flush on stderr
  SHADERFLOW_NO_TAILFUSE      K1 off: the reference tail and final pass (the
                              PSNR gate's REF path) on CPU tensors; on the
                              card a run refuses it
  SKIP_TPU                    black host frames, no device work
  SHADERFLOW_REF_SLOT0        a temporal main program's final pass reads
                              slot 0

and the tail dialect's `vec2` and `channels`. The JAX package exports in
child interpreters on XLA:CPU capped at the AVX ISA (no FMA contraction,
as tests/test_torch_scene.py runs it), each with its switches in its
environment (it reads SKIP_TPU at import); the port exports in-process with
the switch set by monkeypatch.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_switches.py -q
"""

import contextlib
import io
import json
import os
import re
import subprocess
import sys
import wave
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_scene import _import_example

REPO = Path(__file__).resolve().parent.parent
WIDTH, HEIGHT, FPS = 96, 54, 10
# A BATCH_TRACE line (the progress bar may precede it on its line)
TRACE = re.compile(r"BATCH_TRACE frames=(\d+)\+(\d+) capture=\d+\.\dms "
                   r"dispatch=\d+\.\dms drain=\d+\.\dms$", re.M)
# Scene name -> (JAX example, port example, export options)
SCENES = {
    "Mandelbrot": (("fractals", "fractals"), "torch_fractals",
                   dict(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=2, time=0.3)),
    "Visualizer": (("basic", "demo"), "torch_demo",
                   dict(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=2, time=0.3)),
    # ssaa 1: the equal-resolution regime, whose route the switch changes
    "PianoRoll": (("basic", "piano_roll"), "torch_piano_roll",
                  dict(width=192, height=108, fps=FPS, ssaa=1, time=0.3)),
    "MotionBlur": (("basic", "demo"), "torch_demo",
                   dict(width=WIDTH, height=HEIGHT, fps=FPS, time=1.3, batch=4)),
}
MUX = dict(width=64, height=36, fps=FPS, ssaa=1, time=0.3)

JAX_SCRIPT = """
import os
import sys
import pytest
sys.path.insert(0, TESTS)
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())
from shaderflow_tpu.io.ffmpeg import FFmpeg
for env, (directory, module), name, options in JOBS:
    saved = dict(os.environ)
    os.environ.update(env)
    for cache in ("binary", "ffprobe", "get_audio_samplerate", "get_audio_channels"):
        getattr(FFmpeg, cache).cache_clear()
    getattr(_import_example(directory, module), name)().main(**options)
    os.environ.clear()
    os.environ.update(saved)
"""

STUB_FFMPEG = r'''#!{python}
import json, shutil, sys
from pathlib import Path
here = Path(__file__).parent
args = sys.argv[1:]
with open(here / "calls.jsonl", "a") as log:
    log.write(json.dumps(args) + "\n")
if "f32le" in args:
    # A decode: replay the premade samples as f32le PCM
    try:
        sys.stdout.buffer.write((here / "pcm.f32").read_bytes())
        sys.stdout.buffer.flush()
    except BrokenPipeError:
        pass
else:
    # An encode: its stdin copied to its output path verbatim
    with open(args[-1], "wb") as out:
        shutil.copyfileobj(sys.stdin.buffer, out, 1 << 20)
'''


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


SWITCHES = ("SHADERFLOW_PIPELINE_DEPTH", "SHADERFLOW_BATCH_TRACE", "SHADERFLOW_NO_TAILFUSE",
            "SKIP_TPU", "SHADERFLOW_REF_SLOT0", "SHADERFLOW_TAILFUSE_INTERPRET")


@pytest.fixture(autouse=True)
def no_switch(monkeypatch):
    """Every test starts with no switch set."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


def make_stub(directory: Path) -> Path:
    """A stub `ffmpeg` and `ffprobe` in `directory`: a decode replays
    music.wav's samples, an encode copies its stdin to its output path;
    every call's arguments go to calls.jsonl."""
    from test_torch_audio_decode import STUB_FFPROBE
    music = _import_example("torch", "torch_piano_roll").MUSIC
    with wave.open(str(music), "rb") as handle:
        rate, channels = handle.getframerate(), handle.getnchannels()
        pcm = np.frombuffer(handle.readframes(handle.getnframes()), "<i2")
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "pcm.f32").write_bytes((pcm.astype("<f4") / 32768.0).tobytes())
    (directory / "meta.json").write_text(json.dumps(
        dict(rate=rate, channels=channels, frames=pcm.size // channels)))
    for name, source in (("ffmpeg", STUB_FFMPEG), ("ffprobe", STUB_FFPROBE)):
        (directory / name).write_text(source.format(python=sys.executable))
        (directory / name).chmod(0o755)
    return directory


def encodes(directory: Path) -> list:
    """The argv of every encode the stub in `directory` ran."""
    calls = [json.loads(line) for line in (directory / "calls.jsonl").read_text().splitlines()]
    return [args for args in calls if "f32le" not in args]


def _read(path: Path, options: dict) -> np.ndarray:
    return np.fromfile(path, np.uint8).reshape(-1, options["height"], options["width"], 3)


def _u8_stats(got: np.ndarray, want: np.ndarray) -> tuple:
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    return int(diff.max()), float((diff != 0).mean())


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's exports, in three children at once: the three
    scenes under SHADERFLOW_NO_TAILFUSE=1; MotionBlur under
    SHADERFLOW_REF_SLOT0=1 and SHADERFLOW_BATCH_TRACE=1 (batch 4), then
    PianoRoll to an .mp4 through the stub encoder; the visualizer under
    SKIP_TPU=1. Returns the directory and the traced child's stderr."""
    tmp = tmp_path_factory.mktemp("switches")
    stub = make_stub(tmp / "jax_bin")
    path = f"{stub}{os.pathsep}{os.environ['PATH']}"
    (tmp / "mux").mkdir()

    def job(env, name, output, **options):
        return (env, SCENES[name][0], name, {**SCENES[name][2], **options, "output": output})

    children = {
        "no_tailfuse": [job({"SHADERFLOW_NO_TAILFUSE": "1"}, name, str(tmp / f"jax_{name}.rgb"))
                        for name in ("Mandelbrot", "Visualizer", "PianoRoll")],
        "slot0_mux": [job({"SHADERFLOW_REF_SLOT0": "1", "SHADERFLOW_BATCH_TRACE": "1"},
                          "MotionBlur", str(tmp / "jax_MotionBlur.rgb")),
                      ({"PATH": path}, SCENES["PianoRoll"][0], "PianoRoll",
                       {**MUX, "output": str(tmp / "mux" / "out.mp4")})],
        "skip": [job({}, "Visualizer", str(tmp / "jax_skip.rgb"))],
    }
    processes = {}
    for label, jobs in children.items():
        script = f"TESTS, JOBS = {str(REPO / 'tests')!r}, {jobs!r}\n" + JAX_SCRIPT
        env = {key: value for key, value in os.environ.items() if key not in SWITCHES}
        env.update(JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
                   SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp), OMP_NUM_THREADS="1")
        if label == "skip":
            env["SKIP_TPU"] = "1"
        processes[label] = subprocess.Popen(
            [sys.executable, "-c", script], cwd=REPO, env=env, text=True,
            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    errors = {label: process.communicate(timeout=600)[1]
              for label, process in processes.items()}
    for label, process in processes.items():
        assert process.returncode == 0, (label, errors[label][-4000:])
    (tmp / "mux" / "out.mp4").rename(tmp / "jax_mux.mp4")
    return tmp, errors["slot0_mux"]


def _export(name: str, output, **options):
    """The port's scene `name` exported on the CPU; returns the scene."""
    scene = getattr(_import_example("torch", SCENES[name][1]), name)()
    scene.main(output=str(output), device="cpu", **{**SCENES[name][2], **options})
    return scene


# --------------------------------------------------------------------------- #
# SHADERFLOW_PIPELINE_DEPTH and SHADERFLOW_BATCH_TRACE


def test_pipeline_depth_preserves_order_and_content(tmp_path, monkeypatch):
    """tests/test_export_scale.py::test_pipeline_depth_preserves_order_and_content
    on the port: Basic at 64x32, 10 fps, 1.1 s, batch 4 (a partial last
    batch) at depths 1 and 3 delivers the same 11 frames, in order."""
    demo = _import_example("torch", "torch_demo")
    outputs = {}
    for depth in ("1", "3"):
        monkeypatch.setenv("SHADERFLOW_PIPELINE_DEPTH", depth)
        out = tmp_path / f"depth{depth}.rgb"
        demo.Basic().main(width=64, height=32, fps=10, time=1.1, batch=4, output=str(out),
                          device="cpu")
        outputs[depth] = np.fromfile(out, np.uint8)
    assert outputs["1"].size == 11 * 32 * 64 * 3
    np.testing.assert_array_equal(outputs["1"], outputs["3"])


def _jax_default_depth(size: int, width: int, height: int) -> int:
    """The JAX export loop's budget, its two lines run as written
    (shaderflow_tpu/scene.py, `batch_bytes = ...`, `default_depth = ...`)."""
    lines = [line.strip() for line in (REPO / "shaderflow_tpu" / "scene.py").read_text()
             .splitlines() if line.strip().startswith(("batch_bytes =", "default_depth ="))]
    assert len(lines) == 2
    scope = {"size": size, "self": type("Scene", (), {"_width": width, "_height": height})}
    exec("\n".join(lines), {}, scope)
    return scope["default_depth"]


@pytest.mark.parametrize("width,height,size,depth", [
    (1920, 1080, 128, 2), (3840, 2160, 32, 2), (3840, 2160, 64, 1)])
def test_default_depth_is_the_jax_budget(monkeypatch, width, height, size, depth):
    """The default depth is the JAX package's: 2 while three batches fit in
    2.5 GB, else 1; SHADERFLOW_PIPELINE_DEPTH overrides it, at least 1. The
    port's default batch at 1080p and 4K is the JAX package's too."""
    from shaderflow_tpu_torch.scene import ShaderScene
    scene = ShaderScene.__new__(ShaderScene)
    scene._width, scene._height = width, height
    assert scene.pipeline_depth(size) == _jax_default_depth(size, width, height) == depth
    assert scene.default_batch_size() == {1080: 128, 2160: 32}[height]
    monkeypatch.setenv("SHADERFLOW_PIPELINE_DEPTH", "3")
    assert scene.pipeline_depth(size) == 3
    monkeypatch.setenv("SHADERFLOW_PIPELINE_DEPTH", "0")
    assert scene.pipeline_depth(size) == 1


def trace_batches(stderr: str) -> list:
    """The (first frame, count) of every BATCH_TRACE line in `stderr`, each
    line in the JAX package's format."""
    batches = [(int(m.group(1)), int(m.group(2))) for m in TRACE.finditer(stderr)]
    assert len(batches) == stderr.count("BATCH_TRACE"), stderr
    return batches


def _traced(name: str, output: Path, **options) -> list:
    """The port's export of `name` with SHADERFLOW_BATCH_TRACE=1 -> the
    (first frame, count) of its BATCH_TRACE lines."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        _export(name, output, **options)
    return trace_batches(err.getvalue())


def test_batch_trace_lines(tmp_path, monkeypatch):
    """SHADERFLOW_BATCH_TRACE=1: one line a flush, in the JAX package's
    format, and the frames unchanged."""
    demo = _import_example("torch", "torch_demo")
    options = dict(width=64, height=32, fps=10, time=1.1, batch=4, device="cpu")
    demo.Basic().main(output=str(tmp_path / "plain.rgb"), **options)
    monkeypatch.setenv("SHADERFLOW_BATCH_TRACE", "1")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        demo.Basic().main(output=str(tmp_path / "traced.rgb"), **options)
    assert trace_batches(err.getvalue()) == [(0, 4), (4, 4), (8, 3)]
    assert (tmp_path / "traced.rgb").read_bytes() == (tmp_path / "plain.rgb").read_bytes()


# --------------------------------------------------------------------------- #
# SHADERFLOW_NO_TAILFUSE


def test_no_tailfuse_turns_fusion_off(monkeypatch):
    """backend_supports_fusion is False for every device under the switch,
    as the JAX package's is; the reference route is taken for CPU tensors
    and refused for the card's."""
    from shaderflow_tpu.ops import tailfuse as reference
    from shaderflow_tpu_torch import switches
    from shaderflow_tpu_torch.ops import tailfuse
    assert tailfuse.backend_supports_fusion("cuda")
    assert not switches.reference_tail("cuda") and not switches.reference_tail("cpu")
    monkeypatch.setenv("SHADERFLOW_NO_TAILFUSE", "1")
    assert not tailfuse.backend_supports_fusion("cuda")
    assert not tailfuse.backend_supports_fusion(torch.device("cuda", 0))
    assert not tailfuse.backend_supports_fusion("cpu")
    assert switches.no_tailfuse() and not reference.backend_supports_fusion()
    assert switches.reference_tail("cpu") and switches.reference_tail(torch.device("cpu"))
    for device in ("cuda", torch.device("cuda", 1)):
        with pytest.raises(RuntimeError, match="SHADERFLOW_NO_TAILFUSE"):
            switches.reference_tail(device)
        with pytest.raises(RuntimeError, match="SHADERFLOW_NO_TAILFUSE"):
            switches.announce(device)


@pytest.mark.parametrize("env,message", [
    ({"SHADERFLOW_NO_TAILFUSE": "1"}, "reference tail"),
    ({"SKIP_TPU": "1"}, "no device work"),
    ({"SHADERFLOW_PIPELINE_DEPTH": "3", "SHADERFLOW_BATCH_TRACE": "1",
      "SHADERFLOW_REF_SLOT0": "1"}, None)])
def test_switches_that_change_what_runs_warn(monkeypatch, caplog, tmp_path, env, message):
    """An export or a realtime run under SHADERFLOW_NO_TAILFUSE=1 (on the
    CPU) or SKIP_TPU=1 logs a warning naming the switch at its start; the
    other switches warn of nothing."""
    import logging
    demo = _import_example("torch", "torch_demo")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    caplog.set_level(logging.WARNING, logger="shaderflow_tpu_torch")
    demo.Basic().main(width=32, height=16, fps=10, time=0.2, output=str(tmp_path / "a.rgb"),
                      device="cpu")
    scene = demo.Basic()
    scene.frame_limit = 2
    scene.main(width=32, height=16, fps=10, device="cpu")
    warned = [r.getMessage() for r in caplog.records if r.levelno >= logging.WARNING]
    if message is None:
        assert not any("SHADERFLOW" in text or "SKIP_TPU" in text for text in warned)
    else:
        assert sum(message in text and next(iter(env)) in text for text in warned) == 2


@pytest.mark.parametrize("name", ["SKIP_TPU", "SHADERFLOW_NO_TAILFUSE",
                                  "SHADERFLOW_PIPELINE_DEPTH"])
def test_measuring_entries_refuse_the_switches(monkeypatch, capsys, name):
    """The scripts that measure the default path exit before any work when
    a switch is set: switches.refuse (profile_export) and bench_host."""
    from shaderflow_tpu_torch import switches
    switches.refuse("entry")
    monkeypatch.setenv(name, "1")
    with pytest.raises(SystemExit, match=name):
        switches.refuse("entry")
    bench_host = _import_example("torch", "bench_host")
    monkeypatch.setattr(sys, "argv", ["bench_host.py"])
    assert bench_host.main() == 2
    assert name in capsys.readouterr().err
    profile_export = _import_example("torch", "profile_export")
    monkeypatch.setattr(sys, "argv", ["profile_export.py"])
    with pytest.raises(SystemExit, match=name):
        profile_export.main()


def _counting(monkeypatch) -> dict:
    """Counting wrappers around K1's and K2's launchers."""
    from shaderflow_tpu_torch.ops import sampling, tailfuse
    calls = {"k1": 0, "k2": 0}
    for key, module, name in (("k1", tailfuse, "fused_tail_final"),
                              ("k2", sampling, "expand_tables")):
        original = getattr(module, name)

        def wrapper(*args, _key=key, _original=original, **kwargs):
            calls[_key] += 1
            return _original(*args, **kwargs)

        monkeypatch.setattr(module, name, wrapper)
    return calls


@pytest.mark.parametrize("name", ["Mandelbrot", "Visualizer", "PianoRoll"])
def test_no_tailfuse_matches_jax(jax_runs, tmp_path, monkeypatch, name):
    """Under SHADERFLOW_NO_TAILFUSE=1 the port's frames are within 1 u8
    step of the JAX package's under the same switch (< 1 % of values; the
    visualizer < 2 %, its own bar), and K1's launcher is not reached;
    without it, it is. K2's wrapper runs as by default: on CPU tensors it
    is the exact gather of bf16-rounded values that the JAX package's
    switch selects."""
    tmp, _ = jax_runs
    calls = _counting(monkeypatch)
    _export(name, tmp_path / "fused.rgb")
    fused_calls = dict(calls)
    assert fused_calls["k1"] > 0
    assert (fused_calls["k2"] > 0) == (name == "Visualizer")
    calls.update(k1=0, k2=0)
    monkeypatch.setenv("SHADERFLOW_NO_TAILFUSE", "1")
    _export(name, tmp_path / "reference.rgb")
    assert calls == {"k1": 0, "k2": fused_calls["k2"]}
    options = SCENES[name][2]
    got = _read(tmp_path / "reference.rgb", options)
    want = _read(tmp / f"jax_{name}.rgb", options)
    assert got.std() > 10
    max_diff, share = _u8_stats(got, want)
    print(f"{name} NO_TAILFUSE vs JAX: max {max_diff} u8 steps on {share:.4%}")
    assert max_diff <= 1 and share < (0.02 if name == "Visualizer" else 0.01)


# --------------------------------------------------------------------------- #
# SKIP_TPU


def test_skip_tpu_matches_jax(jax_runs, tmp_path, monkeypatch):
    """Under SKIP_TPU=1 an export writes black frames, as many as without
    it, byte-equal to the JAX package's under the switch, and no batch
    prelude runs (the visualizer's bar field: K2's dispatch)."""
    from shaderflow_tpu_torch.engine import RenderEngine
    from shaderflow_tpu_torch.ops import sampling
    tmp, _ = jax_runs
    calls = {"preludes": 0, "expand": 0}
    run_preludes = RenderEngine._run_preludes
    expand = sampling.lookup_nearest_1d_select_batched

    def counted_preludes(self, *args, **kwargs):
        values = run_preludes(self, *args, **kwargs)
        calls["preludes"] += bool(values[0] or values[1])
        return values

    def counted_expand(*args, **kwargs):
        calls["expand"] += 1
        return expand(*args, **kwargs)

    monkeypatch.setattr(RenderEngine, "_run_preludes", counted_preludes)
    monkeypatch.setattr(sampling, "lookup_nearest_1d_select_batched", counted_expand)
    monkeypatch.setenv("SKIP_TPU", "1")
    _export("Visualizer", tmp_path / "skip.rgb")
    got = (tmp_path / "skip.rgb").read_bytes()
    options = SCENES["Visualizer"][2]
    frames = round(options["fps"] * options["time"])
    assert len(got) == frames * HEIGHT * WIDTH * 3 and not any(got)
    assert got == (tmp / "jax_skip.rgb").read_bytes()
    assert calls == {"preludes": 0, "expand": 0}
    monkeypatch.delenv("SKIP_TPU")
    _export("Visualizer", tmp_path / "rendered.rgb")
    assert calls["preludes"] > 0 and calls["expand"] > 0


def test_skip_tpu_flush_on_every_path(monkeypatch):
    """Every caller of flush takes the host batch: a realtime tick, a
    screenshot, and a row-sharded engine's flush (before its mesh
    dispatch); each is a zero (count, H, W, 3) u8 tensor on the host."""
    demo = _import_example("torch", "torch_demo")
    monkeypatch.setenv("SKIP_TPU", "1")
    scene = demo.MotionBlur()
    scene._setup_run(width=64, height=36, fps=10, device="cpu")
    engine = scene.engine
    engine.begin_batch()
    for _ in range(3):
        scene.next(dt=0.1)
    frames = engine.flush(3)
    assert frames.device.type == "cpu" and frames.dtype == torch.uint8
    assert tuple(frames.shape) == (3, 36, 64, 3) and not frames.any()
    screenshot = scene.screenshot()
    assert screenshot.shape == (36, 64, 3) and not screenshot.any()
    from shaderflow_tpu_torch.parallel.mesh import frame_mesh
    engine.mesh = frame_mesh(2, ["cpu"] * 2)
    engine.begin_batch()
    scene.next(dt=0.1)
    frames = engine.flush(1)
    assert isinstance(frames, torch.Tensor) and not frames.any() and not engine._shards


# --------------------------------------------------------------------------- #
# SHADERFLOW_REF_SLOT0 (and the JAX package's trace lines)


@pytest.fixture(scope="module")
def slot0_runs(tmp_path_factory):
    """The port's MotionBlur (batch 4) under SHADERFLOW_REF_SLOT0=1 with
    SHADERFLOW_BATCH_TRACE=1, row-sharded over two CPU shards under the
    switch, and by default."""
    tmp = tmp_path_factory.mktemp("slot0")
    with pytest.MonkeyPatch.context() as patch:
        patch.setenv("SHADERFLOW_REF_SLOT0", "1")
        patch.setenv("SHADERFLOW_BATCH_TRACE", "1")
        batches = _traced("MotionBlur", tmp / "slot0.rgb")
        patch.delenv("SHADERFLOW_BATCH_TRACE")
        scene = getattr(_import_example("torch", "torch_demo"), "MotionBlur")()
        scene.mesh_devices = ["cpu"] * 2
        scene.main(output=str(tmp / "rows.rgb"), device="cpu", devices=2,
                   **SCENES["MotionBlur"][2])
        assert scene.engine._shards and scene.engine.state.carry
    _export("MotionBlur", tmp / "default.rgb")
    return tmp, batches


def test_ref_slot0_matches_jax(jax_runs, slot0_runs):
    """MotionBlur (a temporal main program) under SHADERFLOW_REF_SLOT0=1
    within 1 u8 step of the JAX package's under the switch (< 1 % of
    values), and not the port's default frames; the row-sharded export
    under the switch equals the single device's."""
    jax_tmp, _ = jax_runs
    tmp, _ = slot0_runs
    options = SCENES["MotionBlur"][2]
    got, want = _read(tmp / "slot0.rgb", options), _read(jax_tmp / "jax_MotionBlur.rgb", options)
    max_diff, share = _u8_stats(got, want)
    print(f"MotionBlur REF_SLOT0 vs JAX: max {max_diff} u8 steps on {share:.4%}")
    assert max_diff <= 1 and share < 0.01
    assert got.shape[0] == 13 and got.std() > 10
    default = _read(tmp / "default.rgb", options)
    assert _u8_stats(got, default)[1] > 0.5
    assert (tmp / "rows.rgb").read_bytes() == (tmp / "slot0.rgb").read_bytes()


def test_batch_trace_matches_jax(jax_runs, slot0_runs):
    """The same export traced by both packages (MotionBlur, batch 4, 13
    frames): the same lines, frame for frame, in the same format."""
    _, jax_err = jax_runs
    _, batches = slot0_runs
    assert batches == trace_batches(jax_err) == [(0, 4), (4, 4), (8, 4), (12, 1)]


# --------------------------------------------------------------------------- #
# The tail dialect: vec2 and channels


def _dialect_tail(where):
    def tail(tp):
        u, v = tp.vec2("uv")
        r, g, b = tp.vec3("color")
        n = tp.channels("uv") + tp.channels("color") + tp.channels("gain")
        return (where(u > v, r, g) * (n / 6.0), v * tp.plane("gain"), b * 0.5 + u * 0.25)
    return tail


def test_tail_dialect_vec2_and_channels_match_jax():
    """A tail that reads ctx.vec2 and ctx.channels: the port's frame (K1's
    plain version) within 1 u8 step of the JAX package's fused kernel in
    interpret mode, and K1's tracer and generator take the tail."""
    import jax.numpy as jnp
    from shaderflow_tpu.ops import tailfuse as jax_tailfuse
    from shaderflow_tpu_torch.ops import tailfuse, tailgen
    rng = np.random.default_rng(16)
    out_h, out_w, s, aspect = 20, 32, 2, 1.6
    render_h, render_w = out_h * s, out_w * s
    raw = dict(uv=rng.random((render_h, render_w, 2), np.float32),
               color=rng.random((render_h, render_w, 3), np.float32),
               gain=rng.random((render_h, render_w), np.float32))
    spec = tailfuse.make_spec(_dialect_tail(torch.where), render_h, render_w,
                              **{k: torch.from_numpy(v) for k, v in raw.items()})
    jax_spec = jax_tailfuse.make_spec(_dialect_tail(jnp.where), render_h, render_w,
                                      **{k: jnp.asarray(v) for k, v in raw.items()})
    got = tailfuse.run_tail_final(spec, render_h, render_w, out_h, out_w, s, aspect)
    want = np.asarray(jax_tailfuse.fused_tail_final(jax_spec, render_h, render_w, out_h,
                                                    out_w, s, aspect, interpret=True))
    max_diff, share = _u8_stats(got.numpy(), want)
    assert max_diff <= 1 and share < 0.01 and want.std() > 10
    graph, outputs = tailgen.trace(spec, render_h, render_w, aspect)
    source, keys = tailgen.generate(graph, outputs, s)
    compile(source, "<generated K1>", "exec")
    assert set(keys) == {("plane", "uv", 0), ("plane", "uv", 1), ("plane", "color", 0),
                         ("plane", "color", 1), ("plane", "color", 2), ("plane", "gain", 0)}


# --------------------------------------------------------------------------- #
# Config 5: PianoRoll to .mp4 with its audio muxed


def test_piano_roll_mux_matches_jax(jax_runs, tmp_path, monkeypatch):
    """PianoRoll to an .mp4 through a stub ffmpeg: the encoder's command
    equals the JAX builder's for the same scene and output, carries the
    audio input and -shortest, and the frames it receives are the .rgb
    export's bytes."""
    from test_torch_audio_decode import clear_ffmpeg_caches
    jax_tmp, _ = jax_runs
    piano = _import_example("torch", "torch_piano_roll")
    piano.PianoRoll().main(output=str(tmp_path / "frames.rgb"), device="cpu", **MUX)
    stub = make_stub(tmp_path / "bin")
    monkeypatch.setenv("PATH", f"{stub}{os.pathsep}{os.environ['PATH']}")
    clear_ffmpeg_caches()
    output = jax_tmp / "mux" / "out.mp4"
    try:
        result = piano.PianoRoll().main(output=str(output), device="cpu", **MUX)
    finally:
        monkeypatch.undo()
        clear_ffmpeg_caches()
    assert Path(result) == output
    got, want = encodes(stub), encodes(jax_tmp / "jax_bin")
    assert len(got) == 1 and got == want
    command = got[0]
    assert "-shortest" in command and command[-1] == str(output)
    assert command[command.index("-i", command.index("-i") + 1) + 1] == str(piano.MUSIC)
    frames = (tmp_path / "frames.rgb").read_bytes()
    assert len(frames) == 3 * 36 * 64 * 3
    assert output.read_bytes() == frames
    assert (jax_tmp / "jax_mux.mp4").stat().st_size == len(frames)
