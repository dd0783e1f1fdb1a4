"""The port's command line from an installed wheel: the wheel built offline
(`pip wheel --no-deps --no-build-isolation`) from a copy of the packaged
files, unpacked, and scene discovery run from it. setup.py bundles
examples/ at shaderflow_tpu/resources/examples, where the JAX CLI looks
when no source tree is beside it; the port's looks there by path."""

import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PACKAGED = ("pyproject.toml", "setup.py", "README.md", "shaderflow_tpu",
            "shaderflow_tpu_torch", "examples")


def test_cli_discovers_scenes_from_an_installed_wheel(tmp_path):
    source = tmp_path / "source"
    source.mkdir()
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc", "assets", "_build")
    for name in PACKAGED:
        path = REPO / name
        if path.is_dir():
            shutil.copytree(path, source / name, ignore=ignore)
        else:
            shutil.copy2(path, source / name)
    built = subprocess.run(
        [sys.executable, "-m", "pip", "wheel", "--no-deps", "--no-build-isolation",
         "--no-index", "-q", "-w", str(tmp_path / "dist"), str(source)],
        capture_output=True, text=True, timeout=240,
        env={**os.environ, "PIP_NO_INPUT": "1", "HOME": str(tmp_path)})
    assert built.returncode == 0, built.stderr[-3000:]
    wheel, = (tmp_path / "dist").glob("*.whl")
    site = tmp_path / "site"
    zipfile.ZipFile(wheel).extractall(site)
    bundled = site / "shaderflow_tpu" / "resources" / "examples" / "torch"
    assert (bundled / "torch_demo.py").is_file()
    assert not (site / "examples").exists() and not (site / "shaderflow_tpu_torch" / "examples").exists()
    # The sources built at first use: the CUDA kernels and the frame pump
    assert (site / "shaderflow_tpu_torch" / "csrc" / "fixture.cu").is_file()
    assert (site / "shaderflow_tpu_torch" / "io" / "framepump.cpp").is_file()

    script = """
import sys
sys.modules["jax"] = None
sys.modules["shaderflow_tpu"] = None
from shaderflow_tpu_torch import cli
import shaderflow_tpu_torch
print(shaderflow_tpu_torch.__file__)
print(" ".join(sorted(scene.__name__ for scene in cli.bundled_scenes())))
"""
    run = subprocess.run([sys.executable, "-c", script], cwd=tmp_path, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(site), "HOME": str(tmp_path)})
    assert run.returncode == 0, run.stderr[-3000:]
    location, names = run.stdout.strip().splitlines()[-2:]
    assert Path(location).is_relative_to(site)
    for scene in ("Visualizer", "Audio", "Mandelbrot", "PianoRoll", "Plasma", "Video"):
        assert scene in names.split(), names
