"""The music visualizer slice of the PyTorch port (examples/torch/torch_demo.py
on shaderflow_tpu_torch) against the JAX package's Visualizer
(examples/basic/demo.py), both exported at 128x72, 2x SSAA, 10 fps, 0.5 s to
.rgb on the CPU: the captured uniforms, the precomputed audio sequences and
static prelude fields, the frames with the reference's state carried across
(engine.load_reference_state), and the frames of two independent runs."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_scene import _import_example

REPO = Path(__file__).resolve().parent.parent
WIDTH, HEIGHT, FPS, SECONDS = 128, 72, 10, 0.5
FRAMES = round(FPS * SECONDS)

JAX_SCRIPT = """
import sys
import numpy as np
import pytest
sys.path.insert(0, TESTS)
from test_torch_scene import _fix_reference_texture, _import_example
_fix_reference_texture(pytest.MonkeyPatch())
scene = _import_example("basic", "demo").Visualizer()
scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=2, time=SECONDS, output=OUTPUT)
engine = scene.engine

def host(value):
    value = np.asarray(value)
    if value.dtype.name == "bfloat16":   # keep the bits; numpy files lack the type
        return value.view(np.uint16), True
    return value, False

arrays = {}
for group, values in (("sequence", engine._sequences), ("texture", engine._static_tex)):
    for name, value in values.items():
        array, bf16 = host(value)
        # npz member names end at a NUL: spell the prelude key's prefix out
        name = name.replace("\\0", "<NUL>")
        arrays[f"{group}/{'bf16' if bf16 else 'f32'}/{name}"] = array
np.savez(STATE, **arrays)
np.savez(UNIFORMS, **{f"{index}/{name}": value
                      for index, frame in enumerate(engine._frame_uniforms)
                      for name, value in frame.items()})
"""


def _read_rgb(path: Path) -> np.ndarray:
    return np.fromfile(path, np.uint8).reshape(-1, HEIGHT, WIDTH, 3)


def _load_state(path: Path) -> tuple[dict, dict]:
    """The reference engine's sequences and static textures; bf16 arrays
    come back as bfloat16 tensors."""
    sequences, textures = {}, {}
    for key, value in np.load(path).items():
        group, kind, name = key.split("/", 2)
        name = name.replace("<NUL>", "\0")
        tensor = torch.from_numpy(np.array(value))
        if kind == "bf16":
            tensor = tensor.view(torch.bfloat16)
        (sequences if group == "sequence" else textures)[name] = tensor
    return sequences, textures


def _u8_stats(got: np.ndarray, want: np.ndarray) -> tuple[int, float, float]:
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    mse = float(np.mean(diff.astype(np.float64) ** 2))
    psnr = float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
    return int(diff.max()), float((diff != 0).mean()), psnr


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX export in a child interpreter on XLA:CPU capped at the AVX
    ISA (no FMA contraction, as tests/test_torch_scene.py runs it), then
    two CPU exports of the port: one independent, one with the JAX state
    carried across."""
    tmp = tmp_path_factory.mktemp("visualizer")
    script = (f"TESTS, OUTPUT = {str(REPO / 'tests')!r}, {str(tmp / 'jax.rgb')!r}\n"
              f"STATE, UNIFORMS = {str(tmp / 'state.npz')!r}, {str(tmp / 'uniforms.npz')!r}\n"
              f"WIDTH, HEIGHT, FPS, SECONDS = {WIDTH}, {HEIGHT}, {FPS}, {SECONDS}\n"
              + JAX_SCRIPT)
    env = dict(os.environ, JAX_PLATFORMS="cpu", XLA_FLAGS="--xla_cpu_max_isa=AVX",
               SHADERFLOW_NO_COMPILE_CACHE="1", HOME=str(tmp))
    result = subprocess.run([sys.executable, "-c", script], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    uniforms = {}
    for key, value in np.load(tmp / "uniforms.npz").items():
        index, name = key.split("/", 1)
        uniforms.setdefault(int(index), {})[name] = value

    demo = _import_example("torch", "torch_demo")
    from shaderflow_tpu_torch.engine import load_reference_state
    port = demo.Visualizer()
    port.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=2, time=SECONDS,
              output=str(tmp / "torch.rgb"), device="cpu")
    carried = demo.Visualizer()
    sequences, textures = _load_state(tmp / "state.npz")
    load_reference_state(carried, sequences, textures)
    carried.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=2, time=SECONDS,
                 output=str(tmp / "carried.rgb"), device="cpu")
    return dict(uniforms=[uniforms[i] for i in sorted(uniforms)], port=port,
                sequences=sequences, textures=textures,
                jax=_read_rgb(tmp / "jax.rgb"), torch=_read_rgb(tmp / "torch.rgb"),
                carried=_read_rgb(tmp / "carried.rgb"))


def test_captured_uniforms_match_jax(runs):
    """(a) Every uniform of every captured frame, by name, equal: the host
    state (audio levels and their dynamics, spectrogram and waveform
    uniforms, camera, time) that crosses into the render."""
    port_frames = runs["port"].engine._frame_uniforms
    assert len(runs["uniforms"]) == len(port_frames) == FRAMES
    for ref, got in zip(runs["uniforms"], port_frames):
        assert sorted(ref) == sorted(got)
        for name in ref:
            np.testing.assert_array_equal(np.asarray(got[name]), np.asarray(ref[name]),
                                          err_msg=name)
    assert float(port_frames[-1]["iAudioVolume"]) > 0.0


def test_audio_sequences_and_static_fields_match_jax(runs):
    """(b) The device sequences the frames index (iSpectrogram (256, 115,
    1, 2), iWaveform (256, 1, 180, 2), padded to 256 frames) within the
    spectral tolerance (1e-5 of the largest value: the FFTs differ); the
    four batch-invariant prelude fields within 1e-6 relative (blink, bf16,
    within one bf16 ulp)."""
    engine = runs["port"].engine
    sequences = engine.bound_sequences()
    assert sorted(sequences) == sorted(runs["sequences"]) == ["iSpectrogram", "iWaveform"]
    for name, want in runs["sequences"].items():
        got = sequences[name]
        assert tuple(got.shape) == tuple(want.shape)
        want = want.numpy()
        error = np.abs(got.numpy() - want).max() / np.abs(want).max()
        print(f"{name}: max error {error:.3g} of the largest value")
        assert error <= 1e-5, name
    fields = engine.invariant_preludes()
    prefix = "\0prelude:"
    expected = {name[len(prefix):]: value for name, value in runs["textures"].items()
                if name.startswith(prefix)}
    assert sorted(fields) == sorted(expected) == ["iVizBlink", "iVizFscale", "iVizLvig",
                                                   "iVizRad"]
    for name, want in expected.items():
        got = fields[name]
        assert got.dtype == want.dtype and tuple(got.shape) == tuple(want.shape) == (1, 144, 256)
        if want.dtype == torch.bfloat16:
            ulps = (got.view(torch.int16).to(torch.int32) - want.view(torch.int16).to(torch.int32))
            assert int(ulps.abs().max()) <= 1, name
        else:
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-6,
                                       err_msg=name)
    background = runs["textures"]["background"].numpy()
    np.testing.assert_array_equal(engine._static_tex["background"].numpy(), background)


def test_frames_with_reference_state_match_jax(runs):
    """(c) The render path alone: with the JAX sequences, background and
    static fields carried across, frames within one u8 step on < 2 % of
    values, the JAX package's own bar for this scene
    (tests/test_tailfuse.py:128-130)."""
    assert runs["carried"].shape == runs["jax"].shape == (FRAMES, HEIGHT, WIDTH, 3)
    max_diff, share, psnr = _u8_stats(runs["carried"], runs["jax"])
    print(f"carried state: max {max_diff} u8 steps on {share:.4%}, PSNR {psnr:.2f} dB")
    assert max_diff <= 1 and share < 0.02, (max_diff, share)


def oracle_psnr(monkeypatch, tmp_path, env: dict) -> list[float]:
    """The port's visualizer at 320x180 (ssaa=1, subsample=1, 3 frames at
    10 fps) under `env`, each frame's PSNR against the pointwise GLSL
    transcription (tools/gl_oracle.py:254), the JAX gate's configuration
    (tests/test_psnr_reference.py:153-206), which needs a frame with live
    audio."""
    sys.path.insert(0, str(REPO / "tools"))
    try:
        import gl_oracle
    finally:
        sys.path.remove(str(REPO / "tools"))
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    demo = _import_example("torch", "torch_demo")
    width, height = 320, 180
    scene = demo.Visualizer()
    output = tmp_path / "visualizer.rgb"
    scene.main(width=width, height=height, fps=10, time=0.3, ssaa=1, subsample=1,
               output=str(output), device="cpu")
    frames = np.fromfile(output, np.uint8).reshape(-1, height, width, 3)
    engine = scene.engine
    uniforms = [{**engine._statics, **snapshot} for snapshot in engine._frame_uniforms]
    assert len(uniforms) == len(frames) == 3
    assert any(float(np.asarray(u["iAudioVolume"])) > 0.1 for u in uniforms)
    background = engine._static_tex["background"].numpy()[0, 0][::-1]
    sequences = engine.bound_sequences()
    spectrogram = sequences["iSpectrogram"].numpy()
    waveform = sequences["iWaveform"].numpy()
    values = []
    for uniform in uniforms:
        uniform = {name: np.asarray(value) for name, value in uniform.items()}
        k = int(uniform["iFrameIndex"])
        textures = dict(background=background,
                        spectrogram=spectrogram[min(k, len(spectrogram) - 1)][:, 0, :][::-1],
                        waveform=waveform[min(k, len(waveform) - 1)][0])
        oracle = gl_oracle.render_scene(
            lambda u, w, h, a: gl_oracle.visualizer_fragment(u, w, h, a, textures),
            uniform, *scene.render_resolution, width, height, 1, scene.aspect_ratio)
        values.append(gl_oracle.psnr(frames[len(values)], oracle))
    return values


@pytest.mark.parametrize("level,bar", [(4, 40.0), (1, 50.0)])
def test_f32_visualizer_psnr_against_oracle(monkeypatch, tmp_path, level, bar):
    """The f32 visualizer (the default tail) at blur levels 4 and 1 against
    the GL oracle, at the JAX gate's bars (test_visualizer_psnr[4-40.0-False]
    and [1-50.0-False]): level 4 is the radial blur's pyramid
    approximation, level 1 the GLSL-exact 80-tap loop up to the splat's
    reconstruction. `-s` prints each frame's dB."""
    values = oracle_psnr(monkeypatch, tmp_path, {"SHADERFLOW_VIZ_BLUR_LEVEL": str(level)})
    for index, value in enumerate(values):
        print(f"visualizer f32 level {level} frame {index}: {value:.2f} dB against the oracle")
        assert value >= bar, f"frame {index}: PSNR {value:.1f} dB < {bar}"


def test_independent_frames_match_jax(runs):
    """(d) Fully independent runs (the port's own audio precompute, bar
    field and static fields): PSNR >= 40 dB against the JAX frames, the
    repository's bar (PSNR_GATE.md). Hard bar edges could flip where a
    bf16-rounded bin differs; the measured figures are in the message."""
    assert runs["torch"].shape == runs["jax"].shape == (FRAMES, HEIGHT, WIDTH, 3)
    assert runs["torch"].std() > 10
    max_diff, share, psnr = _u8_stats(runs["torch"], runs["jax"])
    print(f"independent: max {max_diff} u8 steps on {share:.4%}, PSNR {psnr:.2f} dB")
    assert psnr >= 40.0, f"PSNR {psnr:.2f} dB, max {max_diff} u8 steps on {share:.4%}"
