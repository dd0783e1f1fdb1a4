"""
One late frame of every ported example scene, in one PNG, for the eye.

    python examples/torch/contact_sheet.py [--device cuda] [--out PATH]
                                           [--width 192 --height 108]

Counterpart of tools/contact_sheet.py: each scene exported at a small size
(4 frames at 10 fps; 12 for Life and MotionBlur, whose state builds up),
its last frame labelled and tiled four to a row. Runs on the CPU by
default; --device cuda runs it on the card. A scene that fails gets a red
tile, its error is printed, and the tool exits 1 once the sheet is
written. Default output: build/contact_sheet.png (gitignored). Needs no
JAX.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent.parent))
sys.path.insert(0, str(HERE))


def scenes() -> list:
    import torch_demo
    import torch_fractals
    import torch_glsl_demo
    import torch_piano_roll
    return [torch_demo.Basic, torch_demo.ShaderToy, torch_demo.MultiShader,
            torch_demo.Multipass, torch_demo.MotionBlur, torch_demo.Dynamics,
            torch_demo.Video, torch_demo.Waveform, torch_demo.MusicBars,
            torch_demo.Visualizer, torch_demo.RayMarch, torch_demo.Life,
            torch_fractals.Mandelbrot, torch_fractals.MandelbrotRotated,
            torch_fractals.Julia, torch_fractals.Tetration, torch_piano_roll.PianoRoll,
            torch_glsl_demo.Plasma]


def late_frame(cls, width: int, height: int, device: str) -> np.ndarray:
    """The last frame of a short export of cls()."""
    frames = 12 if cls.__name__ in ("Life", "MotionBlur") else 4
    with tempfile.TemporaryDirectory() as tmp:
        output = Path(tmp) / "o.rgb"
        scene = cls()
        try:
            scene.main(width=width, height=height, fps=10, time=frames / 10,
                       output=str(output), device=device)
        finally:
            scene.destroy()
        width, height = scene.resolution           # as the scene rounded them
        return np.fromfile(output, np.uint8).reshape(-1, height, width, 3)[-1]


def main(argv=None) -> int:
    from PIL import Image, ImageDraw
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--out", type=Path, default=HERE.parent.parent / "build" /
                        "contact_sheet.png")
    parser.add_argument("--width", type=int, default=192)
    parser.add_argument("--height", type=int, default=108)
    args = parser.parse_args(argv)
    tiles, failed = [], []
    for cls in scenes():
        try:
            image = Image.fromarray(late_frame(cls, args.width, args.height, args.device))
            image = image.resize((args.width, args.height))
        except Exception as error:   # a red tile; the exit code reports it
            image = Image.new("RGB", (args.width, args.height), (120, 0, 0))
            failed.append(cls.__name__)
            print(f"{cls.__name__}: FAILED {type(error).__name__}: {error}", file=sys.stderr)
        ImageDraw.Draw(image).text((4, 2), cls.__name__, fill=(255, 255, 0))
        tiles.append(image)
    columns = 4
    rows = -(-len(tiles) // columns)
    sheet = Image.new("RGB", (columns * args.width, rows * args.height))
    for index, tile in enumerate(tiles):
        sheet.paste(tile, ((index % columns) * args.width, (index // columns) * args.height))
    args.out.parent.mkdir(parents=True, exist_ok=True)
    sheet.save(args.out)
    print(f"saved {args.out} ({sheet.size[0]}x{sheet.size[1]}, {len(tiles)} scenes)")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
