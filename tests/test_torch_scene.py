"""The PyTorch port's offline export path against the JAX package: the
Mandelbrot scene end to end (frames and captured uniforms), the sidecar
WAV beside a video written without ffmpeg, the import boundary (the port
imports neither JAX nor the JAX package), and the explicit device."""

import importlib
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
WIDTH, HEIGHT, FPS, SECONDS = 96, 54, 10, 0.3


def _fix_reference_texture(monkeypatch):
    """Complete shaderflow_tpu.texture.ShaderTexture.__init__ for this test
    only: in the reference the tail of the constructor (sequence fields and
    ShaderModule registration) sits inside the `matrix` setter, so no
    texture registers with its scene. The JAX package is not edited."""
    from shaderflow_tpu.module import ShaderModule
    from shaderflow_tpu.texture import ShaderTexture

    original = ShaderTexture.__init__
    own = {name for name, parameter in inspect.signature(original).parameters.items()
           if parameter.kind is inspect.Parameter.KEYWORD_ONLY}

    def init(self, scene=None, name=None, **kwargs):
        original(self, scene, name, **{k: kwargs.pop(k) for k in list(kwargs) if k in own})
        self.sequence = None
        self.sequence_window = None
        ShaderModule.__init__(self, scene=scene, name=name, **kwargs)

    def set_matrix(self, value):
        self._matrix = value
        self._matrix_stale = False

    monkeypatch.setattr(ShaderTexture, "__init__", init)
    monkeypatch.setattr(ShaderTexture, "matrix",
                        property(ShaderTexture.matrix.fget, set_matrix))


def _import_example(directory: str, module: str):
    """examples/<directory>/<module>.py of this checkout. A module of that
    name (or the examples' `assets` helper) imported from elsewhere earlier
    in the same process is dropped first: tests/test_cli.py imports every
    example from a copied install tree, and test files share workers."""
    path = REPO / "examples" / directory / f"{module}.py"
    for name, expected in ((module, path), ("assets", REPO / "examples" / "assets.py")):
        cached = sys.modules.get(name)
        if cached is not None and Path(getattr(cached, "__file__", None) or "") != expected:
            del sys.modules[name]
    sys.path.insert(0, str(path.parent))
    try:
        return importlib.import_module(module)
    finally:
        sys.path.pop(0)


def _read_rgb(path: Path) -> np.ndarray:
    return np.fromfile(path, np.uint8).reshape(-1, HEIGHT, WIDTH, 3)


JAX_SCRIPT = """
import sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())
scene = _import_example("fractals", "fractals").Mandelbrot()
scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=2, time=SECONDS, output=OUTPUT)
frames = scene.engine._frame_uniforms
np.savez(UNIFORMS, **{f"{index}/{name}": value for index, frame in enumerate(frames)
                      for name, value in frame.items()})
"""


@pytest.fixture(scope="module")
def exports(tmp_path_factory):
    """Both packages export Mandelbrot at 96x54, 2x SSAA, 10 fps, 0.3 s. The
    JAX package runs in a child interpreter on XLA:CPU capped at the AVX ISA
    (no FMA contraction; see tests/test_torch_fractal.py — with contraction
    the escape counts of chaotic boundary pixels move, and with them up to
    4 u8 steps of the palette on 0.1 % of this view's values)."""
    tmp = tmp_path_factory.mktemp("mandelbrot")
    script = (f"TESTS, OUTPUT, UNIFORMS = {str(REPO / 'tests')!r}, "
              f"{str(tmp / 'jax.rgb')!r}, {str(tmp / 'uniforms.npz')!r}\n"
              f"WIDTH, HEIGHT, FPS, SECONDS = {WIDTH}, {HEIGHT}, {FPS}, {SECONDS}\n"
              + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    reference_uniforms = {}
    for key, value in np.load(tmp / "uniforms.npz").items():
        index, name = key.split("/", 1)
        reference_uniforms.setdefault(int(index), {})[name] = value
    port = _import_example("torch", "torch_fractals").Mandelbrot()
    port.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=2, time=SECONDS,
              output=str(tmp / "torch.rgb"), device="cpu")
    return ([reference_uniforms[i] for i in sorted(reference_uniforms)], port,
            _read_rgb(tmp / "jax.rgb"), _read_rgb(tmp / "torch.rgb"))


def test_mandelbrot_frames_match_jax(exports):
    _, _, reference, port = exports
    assert reference.shape == port.shape == (3, HEIGHT, WIDTH, 3)
    assert port.std() > 10  # a structured image, not a constant frame
    diff = np.abs(reference.astype(np.int16) - port.astype(np.int16))
    # Same math, different compilers: at most one u8 step, on < 1 % of values
    assert diff.max() <= 1
    assert (diff != 0).mean() < 0.01


def test_captured_uniforms_match_jax(exports):
    """The host state that crosses into the device program: every uniform
    of the last captured batch, by name (the system has no weights)."""
    ref_frames, port, _, _ = exports
    port_frames = port.engine._frame_uniforms
    assert len(ref_frames) == len(port_frames) == 3
    for ref, got in zip(ref_frames, port_frames):
        assert sorted(ref) == sorted(got)
        for name in ref:
            np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(ref[name]),
                                          err_msg=name)


def test_start_replays_host_state(tmp_path):
    """main(start=) resumes at a content time: host state is replayed
    without rendering, then only [start, duration) is exported."""
    port = _import_example("torch", "torch_fractals").Mandelbrot()
    port.main(width=32, height=18, fps=10, ssaa=2, time=0.5, start=0.2,
              output=str(tmp_path / "tail.rgb"), device="cpu")
    frames = port.engine._frame_uniforms
    assert np.fromfile(tmp_path / "tail.rgb", np.uint8).size == 3 * 18 * 32 * 3
    assert [int(f["iFrameIndex"]) for f in frames] == [2, 3, 4]
    np.testing.assert_allclose([float(f["iTime"]) for f in frames], [0.2, 0.3, 0.4],
                               rtol=1e-6)


def test_port_imports_no_jax(tmp_path):
    """The port's import chain (the tools too) and tiny CPU exports of the
    ported scenes (Mandelbrot, the music visualizer, PianoRoll at ssaa=1,
    Julia, the visualizer in the bf16 tail mode at blur level 1, and one
    scene of each later group: Basic, MusicBars, RayMarch, Tetration, Life)
    run with jax and the JAX package blocked, and leave no module of either
    loaded."""
    script = f"""
import sys
sys.modules["jax"] = None
sys.modules["shaderflow_tpu"] = None
sys.path.insert(0, {str(REPO)!r})
sys.path.insert(0, {str(REPO / "examples" / "torch")!r})
import numpy as np
import shaderflow_tpu_torch.scene, shaderflow_tpu_torch.ops.tailgen, shaderflow_tpu_torch.build
import torch_demo, torch_fractals, torch_piano_roll
torch_fractals.Mandelbrot().main(width=32, height=18, fps=10, time=0.2, ssaa=2,
                                 output={str(tmp_path / "out.rgb")!r}, device="cpu")
torch_demo.Visualizer().main(width=32, height=18, fps=10, time=0.3, ssaa=2,
                             output={str(tmp_path / "viz.rgb")!r}, device="cpu")
torch_piano_roll.PianoRoll().main(width=32, height=18, fps=10, time=0.4, ssaa=1,
                                  output={str(tmp_path / "piano.rgb")!r}, device="cpu")
torch_fractals.Julia().main(width=32, height=18, fps=10, time=0.1, ssaa=2,
                            output={str(tmp_path / "julia.rgb")!r}, device="cpu")
for scene, name in ((torch_demo.Basic, "basic"), (torch_demo.MusicBars, "bars"),
                    (torch_demo.RayMarch, "raymarch"), (torch_fractals.Tetration, "tetration"),
                    (torch_demo.Life, "life")):
    scene().main(width=32, height=18, fps=10, time=0.2, output={str(tmp_path)!r} + f"/{{name}}.rgb",
                 device="cpu")
import shaderflow_tpu_torch.ops.complexmath, shaderflow_tpu_torch.ops.sampling
import os
import shaderflow_tpu_torch.tools.bench_dtype, shaderflow_tpu_torch.tools.probe_bf16_ops
os.environ.update(SHADERFLOW_TAIL_BF16="1", SHADERFLOW_VIZ_BLUR_LEVEL="1")
torch_demo.Visualizer().main(width=32, height=18, fps=10, time=0.3, ssaa=2,
                             output={str(tmp_path / "viz_bf16.rgb")!r}, device="cpu")
loaded = [name for name, module in sys.modules.items() if module is not None
          and (name in ("jax", "shaderflow_tpu") or name.startswith(("jax.", "shaderflow_tpu.")))]
assert not loaded, loaded
print("frames", *(np.fromfile({str(tmp_path)!r} + "/" + name, np.uint8).size // (32 * 18 * 3)
                  for name in ("out.rgb", "viz.rgb", "piano.rgb", "julia.rgb", "viz_bf16.rgb",
                               "basic.rgb", "bars.rgb", "raymarch.rgb", "tetration.rgb",
                               "life.rgb")))
"""
    env = dict(os.environ, HOME=str(tmp_path))
    result = subprocess.run([sys.executable, "-c", script], capture_output=True,
                            text=True, env=env, timeout=120)
    assert result.returncode == 0, result.stderr
    assert "frames 2 3 4 1 3 2 2 2 2 2" in result.stdout


def test_port_sources_never_import_the_jax_package():
    """No source of the port, of its scenes or of chip_smoke.py imports
    jax or the JAX package, even a module of it that is free of JAX."""
    pattern = re.compile(r"^\s*(from\s+(shaderflow_tpu|jax)(\.|\s)|import\s+(shaderflow_tpu|jax)\b)",
                         re.MULTILINE)
    sources = [*(REPO / "shaderflow_tpu_torch").rglob("*.py"),
               *(REPO / "examples" / "torch").glob("*.py"), REPO / "chip_smoke.py"]
    assert len(sources) > 20
    offenders = {str(path.relative_to(REPO)): match.group(0).strip()
                 for path in sources for match in [pattern.search(path.read_text())] if match}
    assert not offenders, offenders


def test_sidecar_wav_matches_reference(tmp_path, monkeypatch):
    """With no ffmpeg binary an .mp4 export encodes through CV2Sink and
    writes the scene's audio beside it as <output>.wav: the port's
    visualizer at 64x36 for 0.5 s, against the JAX package's writer
    (shaderflow_tpu/exporting.py:228-255) on its own Visualizer with the
    same asset and runtime: the same format and the same 16-bit samples."""
    import wave

    from shaderflow_tpu.exporting import ExportingHelper
    from shaderflow_tpu.io.ffmpeg import FFmpeg as ReferenceFFmpeg
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    for ffmpeg in (FFmpeg, ReferenceFFmpeg):
        monkeypatch.setattr(ffmpeg, "binary", staticmethod(lambda: None))
    port = _import_example("torch", "torch_demo").Visualizer()
    output = tmp_path / "viz.mp4"
    port.main(width=64, height=36, fps=10, time=0.5, ssaa=1, output=str(output), device="cpu")
    assert output.stat().st_size > 0
    assert port.runtime == 0.5

    _fix_reference_texture(monkeypatch)
    reference = _import_example("basic", "demo").Visualizer()
    reference.initialize()
    reference.set_duration(0.5)
    helper = ExportingHelper(reference)
    helper._write_sidecar_audio(tmp_path / "jax.mp4")
    assert helper._sidecar_audio == tmp_path / "jax.mp4.wav"

    def read(path):
        with wave.open(str(path), "rb") as handle:
            params = (handle.getnchannels(), handle.getsampwidth(), handle.getframerate())
            return params, np.frombuffer(handle.readframes(handle.getnframes()), "<i2")

    (params, got), (want_params, want) = read(tmp_path / "viz.mp4.wav"), read(
        tmp_path / "jax.mp4.wav")
    assert params == want_params == (2, 2, 44100)
    assert got.size == want.size == 2 * int(0.5 * 44100) and np.abs(got).max() > 1000
    np.testing.assert_array_equal(got, want)


def test_cuda_without_card_raises():
    """device="cuda" never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the no-card refusal")
    port = _import_example("torch", "torch_fractals").Mandelbrot()
    with pytest.raises(RuntimeError, match="cuda"):
        port.main(width=32, height=18, fps=10, time=0.1, ssaa=2, output="null")
