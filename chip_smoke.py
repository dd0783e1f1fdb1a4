#!/usr/bin/env python3
"""
Smoke test of the PyTorch port (shaderflow_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line (any failure raises; exit code != 0):
  1. card and toolchain: nvidia-smi name / power limit, torch, CUDA,
     Triton and nvcc versions
  2. build: kernel K3's CUDA library (nvcc) and K1's first Triton compile
  3. K3 vs its plain version at the slice's shapes (the default view's
     lines at 3840x2160 render size, max_iter 500 and its cap): counts
     exactly equal; CUDA-event medians of both
  4. K1 vs its plain version: the Mandelbrot tail spec at 3840x2160 ->
     1920x1080, s = 2: at most 1 u8 step, on < 1 % of values; medians
  5. the slice: Mandelbrot().main(1920x1080, 60 fps, 2x SSAA, 2 s) to a
     .rgb file on the card; file size, non-constant frames, both launch
     counters equal to the frames rendered, one frame recomputed through
     the plain functions within 1 u8 step
  6. an output="null" export of the same configuration: frames/s
Then the per-kernel JSON line, the card line, and last
{"ok": true, "device": {...}}. Needs no network and no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT, FPS, SSAA, SECONDS = 1920, 1080, 60, 2, 2.0


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, repeats: int = 10) -> float:
    """Median CUDA-event time of fn() over `repeats` runs, after one warm-up."""
    import torch
    fn()
    times = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def frame_inputs(scene, index: int):
    """Frame `index` of the scene's last captured batch: its Frag on the card."""
    import torch
    from shaderflow_tpu_torch.engine import FrameUniforms
    from shaderflow_tpu_torch.shader import Frag, finish_coords
    engine = scene.engine
    packed, spec = engine.stack_captures()
    row = torch.from_numpy(packed[index]).to(scene.device)
    uniforms = FrameUniforms(row, spec)
    return Frag(coords=finish_coords(engine._coords, uniforms["iResolution"]),
                uniforms=uniforms, statics={**engine._statics, "iLayer": 0})


def plain_frame(scene, index: int):
    """Recompute frame `index` with the plain PyTorch functions only:
    camera lines, escape_lines_plain, the tail on full tensors, final pass."""
    import torch
    import torch_fractals
    from shaderflow_tpu_torch.ops import fractal, tailfuse
    ctx = frame_inputs(scene, index)
    quality = max(1, int(1000.0 * ctx.uniform("iQualityS")))
    gluv_x, gluv_y = ctx.camera.line("gluv")
    iters = fractal.escape_lines_plain(gluv_x - 0.5, gluv_y, quality, 3.0,
                                       torch_fractals.mandelbrot_cap(quality),
                                       torch.float32)
    render_h, render_w = scene.engine._render_size
    spec = tailfuse.make_spec(
        torch_fractals.mandelbrot_tail(quality, True), render_h, render_w,
        iters=iters, oob=tailfuse.Col(ctx.camera.out_of_bounds_x.to(torch.float32)))
    return tailfuse.tail_plain(spec, render_h, render_w, HEIGHT, WIDTH, SSAA,
                               scene.aspect_ratio)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this checks the "
              "port on a CUDA card", file=sys.stderr)
        return 2
    if not (REPO / "shaderflow_tpu_torch").is_dir():
        print(f"chip_smoke: no shaderflow_tpu_torch package next to {__file__}: "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "examples" / "torch"))
    import numpy as np
    import torch_fractals
    from shaderflow_tpu_torch import build
    from shaderflow_tpu_torch.ops import fractal, tailfuse, tailgen
    from shaderflow_tpu_torch.ops.cameralib import project_trivial
    from shaderflow_tpu_torch.shader import make_coords

    device = torch.device("cuda")
    card = card_line()

    # 1. Card and toolchain
    import triton
    nvcc_version = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    say("card", nvidia_smi=repr(card), kind=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, triton=triton.__version__, nvcc=repr(nvcc_version))

    # 2. Build: K3's library (nvcc, plain C interface)
    started = time.perf_counter()
    fractal._escape_library()
    say("build", k3_library_s=f"{time.perf_counter() - started:.3f}",
        ptxas=repr(build.build_log.get("escape", "cached").replace("\n", " | ")))

    # 3. K3 vs plain at the slice's shapes: the default view's lines
    render_h, render_w = HEIGHT * SSAA, WIDTH * SSAA
    aspect = WIDTH / HEIGHT
    coords = make_coords(render_h, render_w, aspect, device)
    rays = project_trivial(
        gluv_x=(coords.u_line * 2.0 - 1.0) * aspect, gluv_y=coords.v_line * 2.0 - 1.0,
        position=[0.0, 0.0, 0.0], zoom=1.0, isometric=0.0, orbital=0.0, dolly=0.0,
        focal_length=1.0, aspect=aspect, want_aspect=aspect, resolution=[WIDTH, HEIGHT])
    gluv_x, gluv_y = rays.line("gluv")
    cx, cy = (gluv_x - 0.5).contiguous(), gluv_y.contiguous()
    quality = 500
    cap = torch_fractals.mandelbrot_cap(quality)
    k3_args = (cx, cy, quality, 3.0, cap, torch.float32)
    counts = fractal.escape_iterations_sep(*k3_args)
    plain_counts = fractal.escape_lines_plain(*k3_args)
    torch.cuda.synchronize()
    k3_err = (counts - plain_counts).abs().max().item()
    if not torch.equal(counts, plain_counts):
        raise AssertionError(f"K3 counts differ from the plain loop on "
                             f"{int((counts != plain_counts).sum())} pixels (max {k3_err})")
    k3_ms = median_ms(lambda: fractal.escape_iterations_sep(*k3_args), 20)
    k3_plain_ms = median_ms(lambda: fractal.escape_lines_plain(*k3_args), 10)
    say("k3", shape=f"{render_h}x{render_w}", max_iter=quality, cap=cap,
        mean_count=f"{counts.mean().item():.3f}", equal=True,
        ms=f"{k3_ms:.4f}", plain_ms=f"{k3_plain_ms:.4f}")

    # 4. K1 vs plain: the Mandelbrot tail spec at the slice's shapes
    spec = tailfuse.make_spec(
        torch_fractals.mandelbrot_tail(quality, True), render_h, render_w,
        iters=counts, oob=tailfuse.Col(rays.out_of_bounds_x.to(torch.float32)))
    k1_args = (spec, render_h, render_w, HEIGHT, WIDTH, SSAA, aspect)
    started = time.perf_counter()
    frame = tailfuse.fused_tail_final(*k1_args)
    torch.cuda.synchronize()
    say("build", k1_first_triton_compile_s=f"{time.perf_counter() - started:.3f}")
    plain = tailfuse.tail_plain(*k1_args)
    diff = (frame.to(torch.int16) - plain.to(torch.int16)).abs()
    k1_err = diff.max().item()
    k1_share = (diff != 0).float().mean().item()
    if k1_err > 1 or k1_share >= 0.01:
        raise AssertionError(f"K1 vs plain: max {k1_err} u8 steps on {k1_share:.4%}")
    # Device time of the bound kernel (tracing and source generation are
    # host work, overlapped with the device in the export loop)
    launch = tailgen.prepare(*k1_args, device)
    k1_out = torch.empty((HEIGHT, WIDTH, 3), dtype=torch.uint8, device=device)
    k1_ms = median_ms(lambda: launch(k1_out), 20)
    k1_plain_ms = median_ms(lambda: tailfuse.tail_plain(*k1_args), 10)
    say("k1", render=f"{render_h}x{render_w}", out=f"{HEIGHT}x{WIDTH}", s=SSAA,
        max_u8_diff=k1_err, differing_share=f"{k1_share:.6f}",
        ms=f"{k1_ms:.4f}", plain_ms=f"{k1_plain_ms:.4f}")

    # 5. The slice through the port's entry point, counters from zero
    fractal.escape_iterations_sep.launches = 0
    tailfuse.fused_tail_final.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        output = Path(tmp) / "mandelbrot.rgb"
        scene = torch_fractals.Mandelbrot()
        started = time.perf_counter()
        scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS,
                   output=str(output), device="cuda")
        export_s = time.perf_counter() - started
        launches = {"k3": fractal.escape_iterations_sep.launches,
                    "k1": tailfuse.fused_tail_final.launches}
        frames = round(SECONDS * FPS)
        frame_bytes = HEIGHT * WIDTH * 3
        if output.stat().st_size != frames * frame_bytes:
            raise AssertionError(f"{output.name}: {output.stat().st_size} bytes, "
                                 f"expected {frames} frames of {frame_bytes}")
        if launches != {"k3": frames, "k1": frames}:
            raise AssertionError(f"launch counters {launches} != {frames} frames rendered")
        check = frames // 2
        exported = np.fromfile(output, np.uint8, count=frame_bytes,
                               offset=check * frame_bytes).reshape(HEIGHT, WIDTH, 3)
        first = np.fromfile(output, np.uint8, count=frame_bytes).reshape(HEIGHT, WIDTH, 3)
        if exported.std() == 0 or first.std() == 0:
            raise AssertionError("constant exported frame")
        recomputed = plain_frame(scene, check).cpu().numpy()
        frame_diff = np.abs(exported.astype(np.int16) - recomputed.astype(np.int16))
        if frame_diff.max() > 1:
            raise AssertionError(f"exported frame {check} vs plain functions: "
                                 f"max {frame_diff.max()} u8 steps")
    say("slice", frames=frames, seconds=f"{export_s:.3f}", launches=launches,
        file_bytes=frames * frame_bytes, frame_checked=check,
        max_u8_diff_vs_plain=int(frame_diff.max()),
        differing_share=f"{(frame_diff != 0).mean():.6f}")

    # 6. Informational: render throughput into the NullSink
    scene = torch_fractals.Mandelbrot()
    started = time.perf_counter()
    scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS,
               output="null", device="cuda")
    null_s = time.perf_counter() - started
    say("timing", config="Mandelbrot 1920x1080 60fps 2xSSAA 2s null",
        frames=frames, seconds=f"{null_s:.4f}", fps=f"{frames / null_s:.3f}",
        card=repr(card))

    kernels = [
        {"name": "K3 escape_lines (Mandelbrot escape counts, lines form)",
         "route": "cuda", "source": "shaderflow_tpu_torch/csrc/escape.cu",
         "replaces": "shaderflow_tpu/ops/fractal.py:66",
         "launches": launches["k3"], "max_abs_err": k3_err,
         "ms": k3_ms, "plain_ms": k3_plain_ms},
        {"name": "K1 fused tail + 2x2 pool + u8 quantize (Mandelbrot tail)",
         "route": "triton", "source": "shaderflow_tpu_torch/ops/tailgen.py",
         "replaces": "shaderflow_tpu/ops/tailfuse.py:485",
         "launches": launches["k1"], "max_abs_err": k1_err,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
