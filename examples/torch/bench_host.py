"""
Frames a second of the port's host-bound paths on one CUDA card, for the
port in a given checkout, so that two trees can be compared in one run.

    python examples/torch/bench_host.py [--repo DIR] [--label NAME] [--json PATH]

Imports shaderflow_tpu_torch and the example scenes from DIR (default: this
checkout) and times, at 1920x1080 and 60 fps, each after a short warm-up
export that builds its kernels: the visualizer (2x SSAA) and RayMarch and
Basic (ssaa 1) exported 2 s, 1 s and 2 s into the NullSink (frames over
the wall of main(), set-up included), and the realtime visualizer's
unpaced ceiling (2x SSAA, headless, fps=1000 without frameskip, 300
frames; SHADERFLOW_AUDIO_BACKEND=none). Prints one JSON line with the
tree's label, the card and the four rates (appended to PATH with --json).
Host time bounds these paths, and a one-card machine shares its host, so
single runs spread: compare trees in turns, parent, change, change,
parent, in one call. Needs a CUDA card; no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent.parent
WIDTH, HEIGHT, FPS = 1920, 1080, 60
# The port's run-time switches (shaderflow_tpu_torch/switches.py NAMES),
# named here so that the check needs neither tree's package
SWITCHES = ("SHADERFLOW_PIPELINE_DEPTH", "SHADERFLOW_BATCH_TRACE", "SHADERFLOW_NO_TAILFUSE",
            "SKIP_TPU", "SHADERFLOW_REF_SLOT0")


def null_fps(cls, seconds: float, **options) -> float:
    """cls() exported `seconds` into the NullSink after a 0.1 s warm-up
    export: frames over the wall of main()."""
    import torch
    cls().main(width=WIDTH, height=HEIGHT, fps=FPS, time=0.1, output="null",
               device="cuda", **options)
    torch.cuda.synchronize()
    started = time.perf_counter()
    cls().main(width=WIDTH, height=HEIGHT, fps=FPS, time=seconds, output="null",
               device="cuda", **options)
    torch.cuda.synchronize()
    return seconds * FPS / (time.perf_counter() - started)


def ceiling_fps(cls, frames: int) -> float:
    """The realtime loop unpaced (fps=1000, no frameskip), headless, 2x
    SSAA, for `frames` frames: frames over the wall of main()."""
    import torch
    from shaderflow_tpu_torch.scene import WindowBackend
    scene = cls(backend=WindowBackend.Headless)
    scene.frame_limit = frames
    started = time.perf_counter()
    scene.main(width=WIDTH, height=HEIGHT, fps=1000, ssaa=2, frameskip=False, device="cuda")
    torch.cuda.synchronize()
    return scene._frame_counter / (time.perf_counter() - started)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--repo", default=str(HERE))
    parser.add_argument("--label", default="tree")
    parser.add_argument("--json", default=None)
    args = parser.parse_args()
    inherited = [name for name in SWITCHES if name in os.environ]
    if inherited:
        print(f"bench_host: {', '.join(inherited)} set in the environment; it measures "
              "the default path", file=sys.stderr)
        return 2
    repo = Path(args.repo).resolve()
    sys.path.insert(0, str(repo))
    sys.path.insert(0, str(repo / "examples" / "torch"))
    os.environ["SHADERFLOW_AUDIO_BACKEND"] = "none"
    import torch
    if not torch.cuda.is_available():
        print("bench_host: needs a CUDA card", file=sys.stderr)
        return 2
    import torch_demo
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    ceiling_fps(torch_demo.Visualizer, 5)
    result = dict(label=args.label, repo=str(repo), card=card,
                  visualizer_null_fps=null_fps(torch_demo.Visualizer, 2.0, ssaa=2),
                  raymarch_null_fps=null_fps(torch_demo.RayMarch, 1.0),
                  basic_null_fps=null_fps(torch_demo.Basic, 2.0),
                  realtime_visualizer_ceiling_fps=ceiling_fps(torch_demo.Visualizer, 300))
    line = json.dumps(result)
    print(line, flush=True)
    if args.json:
        with open(args.json, "a") as handle:
            handle.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
