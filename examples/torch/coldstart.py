"""
Where a first export's start-up goes, on one CUDA card.

    python examples/torch/coldstart.py [--keep-cache] [--seconds 10] [--batch N]
                                       [--width 1920 --height 1080] [--cpu]

Counterpart of tools/coldstart.py. Runs the headline export (the
visualizer at 1920x1080@60, 2x SSAA, 10 s, output="null", at the port's
default batch) in a child process and reports each phase a first-time
user pays before frames flow, from the timings the package keeps:

  import_torch_cuda_init   import torch and the example scenes, CUDA's
                           context made
  build <sources> <tool>   each nvcc batch (its sources built in
                           parallel, one wall), g++ and Triton build
                           (shaderflow_tpu_torch.build.build_events: a
                           Triton entry is a generated kernel's first
                           launch, its JIT compile or its load from the
                           cache)
  spectrogram_run,         the whole-export audio precomputes
  waveform_run             (precompute_timings["run"], device work included)
  engine_build_batch<F>    each flush that built a new K1 (engine.compile_events)
  cold_export_total        the first Scene.main, all of the above inside
  warm_export_total        a second export in the same process

By default the child runs from a copy of shaderflow_tpu_torch/ and
examples/torch/ in a temporary directory (examples/assets linked), so the
package's build directory starts empty, and without TRITON_CACHE_DIR in
its environment, so Triton's cache starts empty inside it (build.py puts
it there). --keep-cache runs the checkout's own tree, its kernels built,
in a fresh process. Prints one JSON line. Needs no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent


def child(args) -> dict:
    """The export in this process -> phases (seconds) and build events."""
    phases: dict[str, float] = {}
    wall0 = started = time.perf_counter()
    import torch
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(HERE))
    if args.device == "cuda":
        torch.cuda.init()
        torch.zeros(1, device="cuda")
    import torch_demo
    from shaderflow_tpu_torch import build
    phases["import_torch_cuda_init"] = time.perf_counter() - started

    scene = torch_demo.Visualizer()
    common = dict(time=args.seconds, width=args.width, height=args.height, fps=60.0, ssaa=2.0,
                  batch=args.batch, output="null", device=args.device)

    def export() -> float:
        started = time.perf_counter()
        scene.main(**common)
        if args.device == "cuda":
            torch.cuda.synchronize()
        return time.perf_counter() - started

    phases["cold_export_total"] = export()
    phases["cold_total_wall"] = time.perf_counter() - wall0
    events = [{"source": source, "tool": tool, "seconds": seconds}
              for source, tool, seconds in build.build_events]
    for module, tag in ((scene.spectrogram, "spectrogram"), (scene.waveform, "waveform")):
        for key, value in module.precompute_timings.items():
            phases[f"{tag}_{key}"] = value
    for index, (frames, seconds) in enumerate(scene.engine.compile_events):
        phases[f"engine_build_{index}_batch{frames}"] = seconds
    phases["warm_export_total"] = export()
    return {"phases": phases, "build_events": events,
            "device": torch.cuda.get_device_name(0) if args.device == "cuda" else "cpu"}


def fresh_tree(directory: Path) -> Path:
    """shaderflow_tpu_torch/ and examples/torch/ copied under `directory`
    (no build outputs), examples/assets linked -> the copy's coldstart.py."""
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc")
    shutil.copytree(REPO / "shaderflow_tpu_torch", directory / "shaderflow_tpu_torch",
                    ignore=ignore)
    shutil.copytree(HERE, directory / "examples" / "torch", ignore=ignore)
    (directory / "examples" / "assets").symlink_to(REPO / "examples" / "assets")
    return directory / "examples" / "torch" / Path(__file__).name


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[1])
    parser.add_argument("--keep-cache", action="store_true",
                        help="run the checkout's built tree in a fresh process")
    parser.add_argument("--seconds", type=float, default=10.0)
    parser.add_argument("--batch", type=int, default=None,
                        help="frames a flush (default: the port's default batch)")
    parser.add_argument("--width", type=int, default=1920)
    parser.add_argument("--height", type=int, default=1080)
    parser.add_argument("--cpu", dest="device", action="store_const", const="cpu",
                        default="cuda", help="run on the CPU (no kernel builds)")
    parser.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.child:
        print(json.dumps(child(args)), flush=True)
        return 0
    from_argv = [f"--seconds={args.seconds}", f"--width={args.width}",
                 f"--height={args.height}"] + ([f"--batch={args.batch}"] if args.batch else []) \
        + (["--cpu"] if args.device == "cpu" else [])
    env = {key: value for key, value in os.environ.items() if key != "TRITON_CACHE_DIR"}
    with tempfile.TemporaryDirectory(prefix="coldstart_") as tmp:
        script = Path(__file__).resolve() if args.keep_cache else fresh_tree(Path(tmp))
        process = subprocess.run([sys.executable, str(script), "--child", *from_argv],
                                 env=env, capture_output=True, text=True)
    if process.returncode != 0:
        print(process.stderr[-4000:], file=sys.stderr)
        raise RuntimeError("coldstart: the export's process failed")
    result = json.loads(process.stdout.strip().splitlines()[-1])
    print(json.dumps({
        "metric": f"coldstart visualizer {args.seconds:g}s export @{args.height}p60 ssaa=2",
        "cache": "checkout" if args.keep_cache else "fresh", **result}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
