"""The PyTorch port's command line (shaderflow_tpu_torch/cli.py,
__main__.py): exports through `launch` and `main` with `--device cpu`, the
flags taken from Scene.main's signature, rejected scenes and options,
module commands, discovery of examples/torch/, and the chained codec and
filter grammar against the JAX package's (the same argv gives the same
ffmpeg command from both FFmpeg classes)."""

import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_scene import _import_example

from shaderflow_tpu_torch import cli
from shaderflow_tpu_torch.scene import ShaderScene

REPO = Path(__file__).resolve().parent.parent
GLSL_DEMO = REPO / "examples" / "torch" / "torch_glsl_demo.py"


class TinyScene(ShaderScene):
    """Minimal scene for CLI dispatch tests."""


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_launch_exports_on_the_cpu(tmp_path):
    """launch returns what Scene.main returns; -o x.rgb gets F * H * W * 3
    bytes (4 frames of 32x18 at 10 fps for 0.4 s)."""
    out = tmp_path / "o.rgb"
    result = cli.launch([TinyScene], ["TinyScene", "main", "-o", str(out), "-w", "32",
                                      "--height", "18", "-f", "10", "-t", "0.4",
                                      "--device", "cpu"])
    assert Path(result) == out
    assert out.stat().st_size == 4 * 18 * 32 * 3


def test_main_exports_a_glsl_scene_file(tmp_path):
    """main([<file.py>, Scene, 'main', ...]): the GLSL demo from its file,
    2x SSAA, through the GLSL interpreter; the file's directory leaves
    sys.path afterwards."""
    out = tmp_path / "plasma.rgb"
    paths = list(sys.path)
    cli.main([str(GLSL_DEMO), "Plasma", "main", "-w", "64", "-h", "36", "-f", "10",
              "-t", "0.2", "-s", "2", "--device", "cpu", "-o", str(out)])
    assert sys.path == paths
    frames = np.fromfile(out, np.uint8).reshape(-1, 36, 64, 3)
    assert frames.shape[0] == 2 and frames.std() > 10


def test_module_entry_point(tmp_path):
    """`python -m shaderflow_tpu_torch <file> Plasma main ... --device cpu`
    writes 2 * 54 * 96 * 3 bytes; without --device the run asks for the
    card, and raises on a machine without one."""
    out = tmp_path / "x.rgb"
    args = [sys.executable, "-m", "shaderflow_tpu_torch", str(GLSL_DEMO), "Plasma", "main",
            "-w", "96", "-h", "54", "-f", "10", "-t", "0.2", "-s", "2"]
    env = dict(os.environ, HOME=str(tmp_path), OMP_NUM_THREADS="1")
    result = subprocess.run([*args, "--device", "cpu", "-o", str(out)], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-4000:]
    assert out.stat().st_size == 2 * 54 * 96 * 3
    if not torch.cuda.is_available():
        result = subprocess.run([*args, "-o", str(tmp_path / "y.rgb")], cwd=REPO, env=env,
                                capture_output=True, text=True, timeout=300)
        assert result.returncode != 0
        assert "torch.cuda.is_available() is False" in result.stderr
        assert not (tmp_path / "y.rgb").exists()


def test_flags_follow_scene_main():
    """Every keyword of Scene.main is a flag with its default, `--device`
    ("cuda") included; booleans get a --no- form."""
    import argparse
    parser = argparse.ArgumentParser(add_help=False)
    cli._add_main_flags(parser)
    defaults = vars(parser.parse_args([]))
    parameters = {name: p.default for name, p in inspect.signature(ShaderScene.main).parameters.items()
                  if name != "self"}
    assert defaults == parameters
    assert defaults["device"] == "cuda"
    assert vars(parser.parse_args(["--device", "cpu", "-w", "64", "-s", "2", "--no-turbo"])) \
        == {**parameters, "device": "cpu", "width": 64, "ssaa": 2.0, "turbo": False}


def test_unknown_scene_and_bad_options_rejected(tmp_path):
    out = tmp_path / "o.rgb"
    assert cli.launch([TinyScene], ["Nope", "main", "-o", str(out)]) is None
    # --cq belongs to NVENC codecs, not x264: a loud rejection, no render
    assert cli.launch([TinyScene], ["TinyScene", "main", "-o", str(out), "--device", "cpu",
                                    "--vcodec", "h264", "--cq", "20"]) is None
    assert cli.launch([TinyScene], ["TinyScene", "main", "-o", str(out), "--device", "cpu",
                                    "h264", "--cq", "20"]) is None
    assert cli.launch([TinyScene], ["TinyScene", "bogus-command"]) is None
    assert not out.exists()


def test_module_command_dispatch(capsys):
    """`PianoRoll midi-stats`: the piano module's registered command."""
    piano_roll = _import_example("torch", "torch_piano_roll")
    cli.launch([piano_roll.PianoRoll], ["PianoRoll", "midi-stats"])
    captured = capsys.readouterr().out
    assert "notes:" in captured and "tempo changes:" in captured


def test_bundled_scene_discovery(capsys):
    """Without a file, the scenes of examples/torch/ are offered."""
    names = {scene.__name__ for scene in cli.bundled_scenes()}
    assert {"Visualizer", "Mandelbrot", "Julia", "PianoRoll", "Basic", "Life",
            "Plasma"} <= names
    cli.main([])   # listing mode
    out = capsys.readouterr().out
    assert "Plasma" in out and "Usage" in out


CHAINS = {
    "h264_aac_scale": ["h264", "--crf", "18", "aac", "--bitrate", "192k",
                       "scale", "--width", "1280"],
    "aliases": ["--vcodec", "h264", "--crf", "18", "av1-svt", "--preset", "6", "anone"],
    "copies_vflip": ["vcopy", "acopy", "vflip"],
    "nvenc_empty_audio": ["h265-nvenc", "--cq", "20", "--preset", "p7", "aempty"],
    "vcodec_acodec_flags": ["--vcodec", "h265", "--crf", "22", "--acodec", "opus",
                            "--bitrate", "96k"],
    "qsv_pcm_scale_height": ["h264-qsv", "--crf", "30", "pcm", "--format", "pcm_s16le",
                             "scale", "--height", "720"],
    "rawvideo_flac": ["vnone", "rawvideo", "flac"],
}


def _command(launch, scene_base, argv: list) -> list:
    captured = {}

    class Probe(scene_base):
        def main(self, **options):
            captured["ffmpeg"] = self.ffmpeg
            captured["options"] = options

    Probe.__name__ = "Probe"
    launch([Probe], ["Probe", "main", "-o", "out.mkv", "-t", "2", *argv])
    ffmpeg = captured["ffmpeg"]
    ffmpeg.pipe_input(width=64, height=36, framerate=30.0)
    ffmpeg.output("out.mkv")
    ffmpeg.time = 2.0
    return ffmpeg.command


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_chained_codecs_match_jax(name):
    """The same chained argv (codec and filter commands, their aliases,
    --vcodec/--acodec) gives the same ffmpeg command list from the port's
    FFmpeg class as from shaderflow_tpu.io.ffmpeg's."""
    from shaderflow_tpu import cli as jax_cli
    from shaderflow_tpu.scene import ShaderScene as JaxScene
    got = _command(cli.launch, ShaderScene, CHAINS[name])
    want = _command(jax_cli.launch, JaxScene, CHAINS[name])
    assert got == want
    assert "-c:v" in got or "-vn" in got
