#!/usr/bin/env python3
"""
Smoke test of the PyTorch port (shaderflow_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line (any failure raises; exit code != 0):
  1. card and toolchain: nvidia-smi name / power limit, torch, CUDA,
     Triton and nvcc versions
  2. build: every CUDA C++ library (one nvcc per source, all at once),
     ptxas's report; K3's registers, spills and SASS instructions an
     escape step for each form (shaderflow_tpu_torch/tools/sass.py)
  Mandelbrot slice (1920x1080, 60 fps, 2x SSAA, 2 s):
  3. K3 vs its plain version at the slice's shapes (the default view's
     lines at 3840x2160, max_iter 500 and its cap): counts exactly equal
  4. K1 (a) vs its plain version: the Mandelbrot tail spec at 3840x2160 ->
     1920x1080, s = 2: at most 1 u8 step, on < 1 % of values
  5. the slice through Mandelbrot().main(...) to a .rgb file: file size,
     non-constant frames, launch counters (K3 == K1 == frames, K2 == 0), one
     frame recomputed through the plain functions within 1 u8 step
  6. an output="null" export of the same configuration: frames/s
  Music visualizer slice (1920x1080, 60 fps, 2x SSAA, 2 s of the asset):
  7. the slice through Visualizer().main(...) to a .rgb file: file size,
     non-constant frames, launch counters (K2 == flushes, K1 == frames,
     K3 == 0), one frame recomputed through the plain functions (plain K2
     gather, plain tail) within 1 u8 step
  8. K2 vs its plain version: seeded (128, 115, 2) tables over the
     visualizer's angle field at 2160x3840: torch.equal; times of the
     kernel, the plain gather and one library call (index_select)
  9. K1 (b)+(c) vs its plain version: the visualizer's tail spec of one real
     frame (Indexed stacks, ColSampled rows) at 3840x2160 -> 1920x1080,
     s = 2: at most 1 u8 step, on < 1 % of values
 10. an output="null" export of the visualizer: frames/s
  PianoRoll slice (3840x2160, 60 fps, ssaa=1: the equal-resolution regime):
 11. the slice through PianoRoll().main(...) to a .rgb file of 0.5 s (30
     frames): file size, non-constant frames, launch counters (K1 (d) ==
     frames, K1 (a)/(b)/(c), K2, K3 == 0), one frame recomputed through the
     plain functions (plain planes, stencil, quantize): at most 1 u8 step
 12. K1 (d) vs its plain version on the PianoRoll tail of one real frame
     (54 columns, 3 scalars) at 3840x2160, s = 1: the bf16 planes bit-equal,
     the final u8 at most 1 step on < 1 % of values
 13. an output="null" export of PianoRoll 4K60 ssaa=1, 2 s: frames/s
  Fractal plane form (1920x1080, 60 fps, 2x SSAA, 2 s): Julia, and
  Mandelbrot under a camera rolled 30 degrees (camera.rotate2d)
 14. each slice through main(...) to a .rgb file: file size, non-constant
     frames, launch counters (K3 planes == K1 (a) == frames, K3 lines ==
     K1 (d) == K2 == 0), one frame recomputed through the plain functions
 15. K3 planes vs its plain version at 3840x2160 on each slice's frame 0:
     Julia (z0 planes, c as 0-d device tensors read through a pointer) and
     the rotated view (c planes from the general camera, the interior test
     in-kernel): torch.equal
 16. an output="null" export of each: frames/s
  The tools (each its own path: counters zeroed before, read after)
 17. T3: the cost walker's fixture (csrc/fixture.cu, x * 2 + 1 over four
     (32, 128) blocks) equal to its plain version, and the walker's counts
     equal to the hand counts (body x grid)
 18. T1: the bf16 op probe through K1's compiler, its table printed; every
     op of the recorded table (tailgen.BF16_PROBE_OK) must still be `ok`
 19. T2: the f32-vs-bf16 chain, both times, the speedup and the verdict;
     each kernel equal to its plain chain
  The bf16 tail mode at blur level 1 (SHADERFLOW_TAIL_BF16=1,
  SHADERFLOW_VIZ_BLUR_LEVEL=1: what the JAX package grades)
 20. the visualizer slice (1920x1080, 60 fps, 2x SSAA, 2 s) through main(...)
     to a .rgb file: counters (K2 == flushes, K1 == K1 bf16 == frames,
     K3 == 0), one frame recomputed through the plain functions
 21. K1 bf16 (b)+(c) vs its plain version on frame 0's tail spec, and
 22. K1 bf16 (a) on the Mandelbrot spec of phase 4: 0 u8 steps targeted,
     at most 1 on < 1 % of values; and each against the tail run eagerly
     on tensors (no tracer) within tailfuse.EAGER_BF16_BAR
 23. an output="null" export of the bf16 level-1 visualizer: frames/s
  The offline example scenes (SCENE_PATHS: Basic 512x288@30 5 s; MusicBars
  and Waveform 1280x720@30 2 s of the asset; RayMarch 1920x1080@60 2 s;
  Tetration 1920x1080@60 2x SSAA 2 s; Dynamics, MultiShader, Multipass,
  MotionBlur and Life 1920x1080@60 1 s)
 24. each scene through main(...) to a .rgb file: file size, non-constant
     frames, launch counters (K1 (a) == frames for Tetration, every kernel
     0 elsewhere: the plain final pass), one frame checked within 1 u8 step
     (recomputed through the plain functions; MultiShader, Multipass,
     MotionBlur and Life against the same scene run with device="cpu" up to
     that frame); then an output="null" export: frames/s, and the device
     ms, kernels and copies and host ms of one frame (engine.render_frame)
     with the busy share they imply
 25. K1 (a) vs its plain version on Tetration's tail spec of frame 0 at
     3840x2160 -> 1920x1080, s = 2: at most 1 u8 step, on < 1 % of values
Kernel times (`ms`, `plain_ms`, `library_ms`) are device time: the
durations of the kernels a call launched, from torch.profiler's CUDA
events, averaged over repeated calls; `call_ms` is the median of CUDA
events recorded around one call, host launch time included. Each K1 row
also has the compiled kernel's registers and spills (Triton's n_regs,
n_spills) and its tile. Each kernel's bound comes from the cost walker
(shaderflow_tpu_torch/tools/flopcount.py: the kernel's declared ops and
bytes for this run's inputs): the larger of its bytes over 3.35 TB/s and
its ALU ops over one float32 instruction per lane and clock (128 x 132 x
1.98e9 a second) or its special-function ops over 16 per SM and clock,
the H100 SXM peaks. Then the per-kernel JSON line, the card line, and
last {"ok": true, "device": {...}}. Needs no network and no JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT, FPS, SSAA, SECONDS = 1920, 1080, 60, 2, 2.0
# K3's float32-output kernel of each form (parts of its mangled name)
K3_KERNELS = {"lines": ("escape_kernel", "6LinesCfE"),
              "rotated": ("escape_kernel", "5PairCfE"),
              "julia": ("escape_kernel", "6ApartCfE")}


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def median_ms(fn, repeats: int = 10) -> float:
    """Median CUDA-event time of fn() over `repeats` runs, after one warm-up:
    events recorded around the call, so on an idle stream the host's launch
    time counts too (call_ms)."""
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


def device_ms(fn, repeats: int = 20) -> float:
    """Device time of one fn() call: the durations of the kernels and copies
    it launched, from torch.profiler's CUDA events (device_type CUDA) over
    `repeats` calls after one warm-up. The profiler can lose an activity
    record or hand it to the next session, so each kernel counts by its
    mean duration times its launches a call (its records over `repeats`,
    rounded; a stray record rounds to none). A process's first profile can
    come back empty: a profile that records nothing is taken again, twice
    at most."""
    return device_profile(fn, repeats)[0]


def device_profile(fn, repeats: int = 20) -> tuple[float, int]:
    """device_ms's measurement -> (device ms of one call, the kernels and
    copies it launched: the records of each name over `repeats`, rounded)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(repeats):
                fn()
            torch.cuda.synchronize()
        durations: dict = {}
        for event in prof.events():
            if event.device_type == DeviceType.CUDA:
                durations.setdefault(event.name, []).append(event.device_time)
        total = sum(statistics.mean(times) * round(len(times) / repeats)
                    for times in durations.values())
        if total > 0:
            return total / 1e3, sum(round(len(times) / repeats)
                                    for times in durations.values())
    raise AssertionError(f"torch.profiler recorded no device time for {repeats} calls")


def k1_figures(launch) -> dict:
    """The compiled K1 behind `launch` (after a launch): registers a thread,
    spills, and its tile (output rows, output columns, warps); fails on a
    spilled register."""
    from shaderflow_tpu_torch.ops import tailgen
    regs, spills = tailgen.registers(launch.compiled)
    if spills:
        raise AssertionError(f"K1 with tile {launch.tile} spills {spills} registers")
    return {"n_regs": regs, "n_spills": spills, "tile": list(launch.tile)}


def walked_bound(run, loop_trips: float = 0.0) -> tuple[float, str]:
    """Run `run` (one kernel call) under the cost walker -> the kernel's
    bound (ms, "bytes" or "operations") for this run's inputs: each kernel
    declares its ops by class and its bytes (each input read once, each
    output written once); `loop_trips` closes a data-dependent loop with
    the measured mean trips per pixel."""
    from shaderflow_tpu_torch.tools import flopcount
    with flopcount.Walker() as walker:
        run()
    if not walker.kernels:
        raise AssertionError("the walked call declared no kernel")
    return flopcount.roofline(walker.cost, loop_trips)


def escape_steps(counts, interior) -> int:
    """The escape steps this run's data takes: the counts of the pixels
    outside the interior shortcut."""
    return int((counts[~interior] if interior is not None else counts).sum().item())


def frame_inputs(scene, index: int):
    """Frame `index` of the Mandelbrot scene's last batch: its Frag on the card."""
    import torch
    engine = scene.engine
    packed, spec = engine.stack_captures()
    row = torch.from_numpy(packed[index]).to(scene.device)
    return engine.frame_context(row, spec, index, engine.frame_indices()[index], {}, {})


def plain_mandelbrot_frame(scene, index: int):
    """Recompute Mandelbrot frame `index` with the plain PyTorch functions
    only: camera lines, escape_lines_plain, the tail on full tensors, final
    pass."""
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


def visualizer_spec(scene, index: int):
    """The tail spec of visualizer frame `index` of the last batch, built
    with the plain functions only: the bar field through the plain K2
    gather, the cached static fields, the frame's textures and uniforms."""
    import torch
    import torch_demo
    from shaderflow_tpu_torch.engine import PreludeCtx
    from shaderflow_tpu_torch.ops import sampling
    engine = scene.engine
    packed, spec = engine.stack_captures()
    frames = engine.frame_indices()
    ctx = PreludeCtx(torch.tensor(frames, device=scene.device), engine.bound_sequences(),
                     engine._render_size, scene.aspect_ratio)
    tables, circle, left = torch_demo.bar_field_inputs(ctx)
    batch, bins, channels = tables.shape
    index_field = sampling.lookup_index(circle, bins, channels, left)
    bar = sampling.expand_plain(tables.reshape(batch, -1).to(torch.bfloat16),
                                index_field, torch.bfloat16)
    bar = bar.reshape(batch, *circle.shape)
    row = torch.from_numpy(packed[index]).to(scene.device)
    frag = engine.frame_context(row, spec, index, frames[index], {"iBarField": bar},
                                engine.invariant_preludes())
    return torch_demo.visualizer_frag(frag)


def piano_spec(scene, index: int):
    """The PianoRoll tail spec of frame `index` of the last batch (its
    column lines and scalars, built on the card by the scene's fragment)."""
    import torch_piano_roll
    return torch_piano_roll.piano_roll_frag(frame_inputs(scene, index))


def fractal_plain_frame(scene, index: int, render_h: int, render_w: int):
    """Recompute frame `index` of a Julia or rotated Mandelbrot export with
    the plain functions only: the camera, escape_plain on its planes, the
    tail on full tensors, the final pass -> (frame, escape operands)."""
    import torch
    import torch_fractals
    from shaderflow_tpu_torch.ops import fractal, tailfuse
    ctx = frame_inputs(scene, index)
    quality = max(1, int(1000.0 * ctx.uniform("iQualityS")))
    cam = ctx.camera
    if isinstance(scene, torch_fractals.Julia):
        cx, cy = torch_fractals.julia_c(ctx)
        z0 = cam.gluv
        operands = (z0, cx, cy, None)
        iters = fractal.escape_plain(z0[..., 0], z0[..., 1], cx, cy, quality, 3.0,
                                     saturate=torch_fractals.julia_cap(quality),
                                     out_dtype=torch.float32)
        tail = torch_fractals.julia_tail(quality)
    else:
        gluv = cam.gluv
        c = torch.stack([gluv[..., 0] - 0.5, gluv[..., 1]], dim=-1)
        interior = fractal._interior_mask(c[..., 0], c[..., 1])
        operands = (c, None, None, interior)
        iters = fractal.escape_plain(c[..., 0], c[..., 1], c[..., 0], c[..., 1], quality, 3.0,
                                     interior=interior,
                                     saturate=torch_fractals.mandelbrot_cap(quality),
                                     out_dtype=torch.float32)
        tail = torch_fractals.mandelbrot_tail(quality, False)
    spec = tailfuse.make_spec(tail, render_h, render_w, iters=iters,
                              oob=cam.out_of_bounds.to(torch.float32))
    frame = tailfuse.tail_plain(spec, render_h, render_w, HEIGHT, WIDTH, SSAA,
                                scene.aspect_ratio)
    return frame, operands, quality


# The offline example scenes (examples/torch/torch_demo.py, torch_fractals.py)
# at the sizes of their configurations: class name, example module, width,
# height, fps, seconds, ssaa. MultiShader, Multipass, MotionBlur and Life
# (programs, layers and temporal rings: the engine's program loop) are
# checked against the same scene run with device="cpu"; the others against
# one frame recomputed through the plain functions.
SCENE_PATHS = (
    ("Basic", "torch_demo", 512, 288, 30, 5.0, 1),
    ("MusicBars", "torch_demo", 1280, 720, 30, 2.0, 1),
    ("Waveform", "torch_demo", 1280, 720, 30, 2.0, 1),
    ("RayMarch", "torch_demo", 1920, 1080, 60, 2.0, 1),
    ("Tetration", "torch_fractals", 1920, 1080, 60, 2.0, 2),
    ("Dynamics", "torch_demo", 1920, 1080, 60, 1.0, 1),
    ("MultiShader", "torch_demo", 1920, 1080, 60, 1.0, 1),
    ("Multipass", "torch_demo", 1920, 1080, 60, 1.0, 1),
    ("MotionBlur", "torch_demo", 1920, 1080, 60, 1.0, 1),
    ("Life", "torch_demo", 1920, 1080, 60, 1.0, 1),
)
CPU_CHECKED = ("MultiShader", "Multipass", "MotionBlur", "Life")
# The temporal scenes are compared on this frame (past MotionBlur's 10-deep
# ring and Life's second simulation step), the CPU run rendering frames 0..it
TEMPORAL_CHECK_FRAME = 12


def plain_scene_frame(scene, index: int, height: int, width: int):
    """Recompute frame `index` of a one-program scene's last batch with the
    plain functions only: its fragment on the frame's uniforms and
    textures, then the tail's plain version (tail_plain) or the plain final
    pass."""
    from shaderflow_tpu_torch.ops import tailfuse
    from shaderflow_tpu_torch.ops.downsample import final_pass
    out = scene.shader.fragment(frame_inputs(scene, index))
    render_h, render_w = scene.engine._render_size
    if isinstance(out, tailfuse.TailSpec):
        return tailfuse.tail_plain(out, render_h, render_w, height, width, scene.subsample,
                                   scene.aspect_ratio)
    return final_pass(out, height, width, int(scene.subsample))


def scene_path(cls, width: int, height: int, fps: int, seconds: float, ssaa: int,
               counters, card: str) -> dict:
    """One offline example scene through main(..., device="cuda"): a .rgb
    export with its file size, non-constant frames and kernel launch
    counters (K1 (a) once a frame for Tetration, no kernel elsewhere), its
    one-frame check (plain functions, or device="cpu" for the scenes of
    CPU_CHECKED), then a null export's fps, and the device ms, kernels and
    copies a frame (device_profile of one engine.render_frame of that
    export's last batch) and the busy share they imply."""
    import numpy as np
    import torch
    zero_counters, read_counters = counters
    name = cls.__name__
    frames = round(seconds * fps)
    options = dict(width=width, height=height, fps=fps, ssaa=ssaa, time=seconds)
    with tempfile.TemporaryDirectory() as tmp:
        output = Path(tmp) / f"{name}.rgb"
        scene = cls()
        zero_counters()
        started = time.perf_counter()
        scene.main(output=str(output), device="cuda", **options)
        export_s = time.perf_counter() - started
        launches = read_counters()
        expected = {key: 0 for key in launches}
        if name == "Tetration":
            expected["k1"] = frames
        if launches != expected:
            raise AssertionError(f"{name} launch counters {launches}, expected {expected}")
        check_export(output, frames, output.name, height, width, other=-1)
        # the checked frame: the middle one of the last batch (whose
        # captures the plain recompute reads), or TEMPORAL_CHECK_FRAME
        temporal = any(getattr(module, "texture", None) is not None
                       and module.texture.temporal > 1 for module in scene.modules)
        batch = len(scene.engine.frame_indices())
        check = TEMPORAL_CHECK_FRAME if temporal else frames - batch + batch // 2
        exported = np.fromfile(output, np.uint8, count=height * width * 3,
                               offset=check * height * width * 3).reshape(height, width, 3)
        if name in CPU_CHECKED:
            reference = Path(tmp) / "cpu.rgb"
            # a stateless scene replays host state up to the frame (start=)
            cls().main(output=str(reference), device="cpu",
                       **{**options, "time": (check + 1) / fps,
                          "start": 0.0 if temporal else check / fps})
            want = np.fromfile(reference, np.uint8).reshape(-1, height, width, 3)[-1]
            how = "device=cpu"
        else:
            want = plain_scene_frame(scene, check - (frames - batch), height,
                                     width).cpu().numpy()
            how = "plain functions"
        frame_err, frame_share = u8_diff(exported, want)
        if frame_err > 1:
            raise AssertionError(f"{name} frame {check} vs {how}: max {frame_err} u8 steps "
                                 f"on {frame_share:.4%}")
        say(f"{name.lower()}_slice", size=f"{width}x{height}", fps=fps, ssaa=ssaa,
            frames=frames, bytes=output.stat().st_size, seconds=f"{export_s:.3f}",
            launches=launches,
            frame_checked=check, checked_against=repr(how), max_u8_diff=frame_err,
            differing_share=f"{frame_share:.3e}")
        del exported, want

    scene = cls()
    started = time.perf_counter()
    scene.main(output="null", device="cuda", **options)
    null_s = time.perf_counter() - started
    engine = scene.engine
    packed, spec = engine.stack_captures()
    indices = engine.frame_indices()
    last = len(indices) - 1
    row = torch.from_numpy(packed[last]).to("cuda")
    per_batch, invariant = engine._run_preludes(indices)
    out = torch.empty((height, width, 3), dtype=torch.uint8, device="cuda")

    def render():
        engine.render_frame(row, spec, last, indices[last], per_batch, invariant, out)

    frame_ms, frame_launches = device_profile(render, 3)
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(3):
        render()
    host_ms = (time.perf_counter() - started) / 3 * 1e3
    torch.cuda.synchronize()
    result = dict(frames=frames, seconds=null_s, fps=frames / null_s,
                  device_ms_per_frame=frame_ms, launches_per_frame=frame_launches,
                  host_ms_per_frame=host_ms, busy=frames * frame_ms / 1e3 / null_s,
                  launches=launches, max_u8_diff=frame_err)
    say(f"{name.lower()}_timing",
        config=f"{name} {width}x{height} {fps}fps ssaa={ssaa} {seconds:g}s null",
        frames=frames, seconds=f"{null_s:.4f}", fps=f"{result['fps']:.3f}",
        device_ms_per_frame=f"{frame_ms:.4f}", launches_per_frame=frame_launches,
        host_ms_per_frame=f"{host_ms:.4f}", busy=f"{result['busy']:.4f}", card=repr(card))
    return result


def check_export(output: Path, frames: int, name: str, height: int = HEIGHT,
                 width: int = WIDTH, other: int = 0):
    """File size and two non-constant frames of a .rgb export: the middle
    one and frame `other` (a scene whose first frame is silent takes the
    last)."""
    import numpy as np
    frame_bytes = height * width * 3
    if output.stat().st_size != frames * frame_bytes:
        raise AssertionError(f"{name}: {output.stat().st_size} bytes, "
                             f"expected {frames} frames of {frame_bytes}")
    check = frames // 2
    exported = np.fromfile(output, np.uint8, count=frame_bytes,
                           offset=check * frame_bytes).reshape(height, width, 3)
    first = np.fromfile(output, np.uint8, count=frame_bytes,
                        offset=(other % frames) * frame_bytes).reshape(height, width, 3)
    if exported.std() == 0 or first.std() == 0:
        raise AssertionError(f"{name}: constant exported frame")
    return check, exported


def u8_diff(got, want) -> tuple[int, float]:
    import numpy as np
    diff = np.abs(np.asarray(got).astype(np.int16) - np.asarray(want).astype(np.int16))
    return int(diff.max()), float((diff != 0).mean())


def eager_check(name: str, frame, tail_args) -> tuple[int, float]:
    """A bf16 K1 frame against the tail run eagerly on tensors (no tracer:
    tailfuse.eval_reference(eager=True)) -> (max u8 steps, PSNR dB); fails
    outside tailfuse.EAGER_BF16_BAR."""
    import numpy as np
    from shaderflow_tpu_torch.ops import tailfuse
    eager = tailfuse.tail_plain(*tail_args, eager=True).cpu().numpy()
    diff = np.abs(np.asarray(frame).astype(np.int16) - eager.astype(np.int16))
    mse = float(np.mean(diff.astype(np.float64) ** 2))
    psnr = float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
    steps, psnr_bar = tailfuse.EAGER_BF16_BAR
    if diff.max() > steps or psnr < psnr_bar:
        raise AssertionError(f"{name} vs the eager tail: max {diff.max()} u8 steps, "
                             f"{psnr:.2f} dB (bar {steps} steps, {psnr_bar} dB)")
    return int(diff.max()), psnr


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
    import torch_demo
    import torch_fractals
    from shaderflow_tpu_torch import build
    import torch_piano_roll
    from shaderflow_tpu_torch.engine import PreludeCtx
    from shaderflow_tpu_torch.ops import fractal, sampling, tailfuse, tailgen
    from shaderflow_tpu_torch.ops.cameralib import project_trivial
    from shaderflow_tpu_torch.shader import make_coords
    from shaderflow_tpu_torch.tools import bench_dtype, flopcount, probe_bf16_ops, sass

    device = torch.device("cuda")
    card = card_line()
    frames = round(SECONDS * FPS)
    render_h, render_w = HEIGHT * SSAA, WIDTH * SSAA
    aspect = WIDTH / HEIGHT

    # 1. Card and toolchain
    import triton
    nvcc_version = subprocess.run([build.nvcc(), "--version"], capture_output=True,
                                  text=True, check=True).stdout.strip().splitlines()[-1]
    say("card", nvidia_smi=repr(card), kind=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, triton=triton.__version__, nvcc=repr(nvcc_version))

    # 2. Build: every missing or stale CUDA library at once (plain C
    # interfaces), and ptxas's report of each; K3's registers, spills and
    # SASS instructions a step of each form's float32 kernel
    started = time.perf_counter()
    built = build.build_cuda_libraries()
    fractal._escape_library()
    sampling._lookup_library()
    flopcount._fixture_library()
    sources = {source.stem: source for source in build.cuda_sources()}
    say("build", libraries=",".join(built) or "cached",
        seconds=f"{time.perf_counter() - started:.3f}",
        ptxas=repr(" | ".join(build.ptxas_report(sources[n]).strip().replace("\n", " ; ")
                              for n in ("escape", "lookup", "fixture"))))
    escape_sass = sass.dump(build.library_path(sources["escape"]))
    escape_ptxas = build.ptxas_report(sources["escape"])
    k3_compiled = {}
    for form, parts in K3_KERNELS.items():
        step = sass.step_figures(escape_sass, *parts)
        k3_compiled[form] = {**sass.ptxas_figures(escape_ptxas, *parts),
                             **{key: step[key] for key in ("loop_instructions", "loop_steps",
                                                           "instructions_per_step")}}
        say("k3_compiled", form=form, **k3_compiled[form], ops=step["ops"])

    # 3. K3 vs plain at the slice's shapes: the default view's lines
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
    k3_ms = device_ms(lambda: fractal.escape_iterations_sep(*k3_args))
    k3_call_ms = median_ms(lambda: fractal.escape_iterations_sep(*k3_args), 20)
    k3_plain_ms = device_ms(lambda: fractal.escape_lines_plain(*k3_args), 5)
    grid_x, grid_y = torch.broadcast_tensors(cx[None, :], cy[:, None])
    steps = escape_steps(counts, fractal._interior_mask(grid_x, grid_y))
    k3_bound_ms, k3_bound_by = walked_bound(lambda: fractal.escape_iterations_sep(*k3_args),
                                            steps / counts.numel())
    say("k3", shape=f"{render_h}x{render_w}", max_iter=quality, cap=cap,
        steps=int(steps), equal=True, ms=f"{k3_ms:.4f}", call_ms=f"{k3_call_ms:.4f}",
        plain_ms=f"{k3_plain_ms:.4f}",
        bound_ms=f"{k3_bound_ms:.4f}", bound_by=k3_bound_by)

    # 4. K1 (a) vs plain: the Mandelbrot tail spec at the slice's shapes
    spec = tailfuse.make_spec(
        torch_fractals.mandelbrot_tail(quality, True), render_h, render_w,
        iters=counts, oob=tailfuse.Col(rays.out_of_bounds_x.to(torch.float32)))
    k1_args = (spec, render_h, render_w, HEIGHT, WIDTH, SSAA, aspect)
    started = time.perf_counter()
    frame = tailfuse.fused_tail_final(*k1_args)
    torch.cuda.synchronize()
    say("build", k1_mandelbrot_first_triton_compile_s=f"{time.perf_counter() - started:.3f}")
    k1_err, k1_share = u8_diff(frame.cpu(), tailfuse.tail_plain(*k1_args).cpu())
    if k1_err > 1 or k1_share >= 0.01:
        raise AssertionError(f"K1 (a) vs plain: max {k1_err} u8 steps on {k1_share:.4%}")
    # Device time of the bound kernel (tracing and source generation are
    # host work, overlapped with the device in the export loop)
    launch = tailgen.prepare(*k1_args, device)
    k1_out = torch.empty((HEIGHT, WIDTH, 3), dtype=torch.uint8, device=device)
    k1_ms = device_ms(lambda: launch(k1_out))
    k1_call_ms = median_ms(lambda: launch(k1_out), 20)
    k1_plain_ms = device_ms(lambda: tailfuse.tail_plain(*k1_args), 5)
    k1_bound_ms, k1_bound_by = walked_bound(lambda: launch(k1_out))
    k1_compiled = k1_figures(launch)
    say("k1a", render=f"{render_h}x{render_w}", out=f"{HEIGHT}x{WIDTH}", s=SSAA,
        max_u8_diff=k1_err, differing_share=f"{k1_share:.3e}",
        ms=f"{k1_ms:.4f}", call_ms=f"{k1_call_ms:.4f}", plain_ms=f"{k1_plain_ms:.4f}",
        bound_ms=f"{k1_bound_ms:.4f}", bound_by=k1_bound_by, **k1_compiled)

    def zero_counters():
        fractal.escape_iterations_sep.launches = 0
        fractal.escape_iterations.launches = 0
        sampling.expand_tables.launches = 0
        tailfuse.fused_tail_final.launches = 0
        tailfuse.fused_tail_final.planes_launches = 0
        tailfuse.fused_tail_final.bf16_launches = 0

    def read_counters():
        return {"k3": fractal.escape_iterations_sep.launches,
                "k3p": fractal.escape_iterations.launches,
                "k2": sampling.expand_tables.launches,
                "k1": tailfuse.fused_tail_final.launches,
                "k1d": tailfuse.fused_tail_final.planes_launches,
                "k1h": tailfuse.fused_tail_final.bf16_launches}

    with tempfile.TemporaryDirectory() as tmp:
        # 5. The Mandelbrot slice through the port's entry point
        output = Path(tmp) / "mandelbrot.rgb"
        scene = torch_fractals.Mandelbrot()
        zero_counters()
        started = time.perf_counter()
        scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS,
                   output=str(output), device="cuda")
        export_s = time.perf_counter() - started
        mandelbrot_launches = read_counters()
        if mandelbrot_launches != {"k3": frames, "k3p": 0, "k2": 0, "k1": frames, "k1d": 0,
                                   "k1h": 0}:
            raise AssertionError(f"Mandelbrot launch counters {mandelbrot_launches}, "
                                 f"expected K3 == K1 == {frames} frames, K2 == 0")
        check, exported = check_export(output, frames, output.name)
        frame_err, frame_share = u8_diff(exported, plain_mandelbrot_frame(scene, check).cpu())
        if frame_err > 1:
            raise AssertionError(f"Mandelbrot frame {check} vs plain functions: "
                                 f"max {frame_err} u8 steps")
        say("mandelbrot_slice", frames=frames, seconds=f"{export_s:.3f}",
            launches=mandelbrot_launches, frame_checked=check,
            max_u8_diff_vs_plain=frame_err, differing_share=f"{frame_share:.3e}")

        # 6. Mandelbrot render throughput into the NullSink
        scene = torch_fractals.Mandelbrot()
        started = time.perf_counter()
        scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS,
                   output="null", device="cuda")
        null_s = time.perf_counter() - started
        say("mandelbrot_timing", config="Mandelbrot 1920x1080 60fps 2xSSAA 2s null",
            frames=frames, seconds=f"{null_s:.4f}", fps=f"{frames / null_s:.3f}",
            card=repr(card))

        # 7. The visualizer slice through the port's entry point
        output = Path(tmp) / "visualizer.rgb"
        scene = torch_demo.Visualizer()
        zero_counters()
        started = time.perf_counter()
        scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS,
                   output=str(output), device="cuda")
        export_s = time.perf_counter() - started
        visualizer_launches = read_counters()
        flushes = -(-frames // scene.default_batch_size())
        if visualizer_launches != {"k3": 0, "k3p": 0, "k2": flushes, "k1": frames, "k1d": 0,
                                    "k1h": 0}:
            raise AssertionError(f"Visualizer launch counters {visualizer_launches}, "
                                 f"expected K2 == {flushes} flushes, K1 == {frames} "
                                 "frames, K3 == 0")
        check, exported = check_export(output, frames, output.name)
        frame_spec = visualizer_spec(scene, check)
        tail_args = (frame_spec, render_h, render_w, HEIGHT, WIDTH, SSAA, aspect)
        frame_err, frame_share = u8_diff(exported, tailfuse.tail_plain(*tail_args).cpu())
        if frame_err > 1:
            raise AssertionError(f"Visualizer frame {check} vs plain functions: "
                                 f"max {frame_err} u8 steps on {frame_share:.4%}")
        say("visualizer_slice", frames=frames, flushes=flushes, seconds=f"{export_s:.3f}",
            launches=visualizer_launches, frame_checked=check,
            max_u8_diff_vs_plain=frame_err, differing_share=f"{frame_share:.3e}")

    # 8. K2 vs plain: seeded tables over the visualizer's angle field
    import numpy as np
    rng = np.random.default_rng(2)
    batch, bins, channels = 128, 115, 2
    spectrogram = torch.from_numpy(
        rng.random((batch, bins, 1, channels), np.float32) * 900.0).to(device)
    ctx = PreludeCtx(torch.arange(batch, device=device), {"iSpectrogram": spectrogram},
                     (render_h, render_w), aspect)
    tables, circle, left = torch_demo.bar_field_inputs(ctx)
    index_field = sampling.lookup_index(circle, bins, channels, left)
    flat16 = tables.reshape(batch, -1).to(torch.bfloat16).contiguous()
    got = sampling.expand_tables(flat16, index_field, torch.bfloat16)
    want = sampling.expand_plain(flat16, index_field, torch.bfloat16)
    library = flat16.index_select(1, index_field)
    k2_err = (got.float() - want.float()).abs().max().item()
    if not (torch.equal(got, want) and torch.equal(library, want)):
        raise AssertionError(f"K2 differs from the plain gather on "
                             f"{int((got != want).sum())} values (max {k2_err})")
    k2_ms = device_ms(lambda: sampling.expand_tables(flat16, index_field, torch.bfloat16))
    k2_call_ms = median_ms(lambda: sampling.expand_tables(flat16, index_field,
                                                          torch.bfloat16), 20)
    k2_plain_ms = device_ms(lambda: sampling.expand_plain(flat16, index_field,
                                                          torch.bfloat16), 10)
    k2_library_ms = device_ms(lambda: flat16.index_select(1, index_field), 10)
    k2_bound_ms, k2_bound_by = walked_bound(
        lambda: sampling.expand_tables(flat16, index_field, torch.bfloat16))
    say("k2", tables=f"{batch}x{bins}x{channels}", field=f"{render_h}x{render_w}",
        equal=True, ms=f"{k2_ms:.4f}", call_ms=f"{k2_call_ms:.4f}",
        plain_ms=f"{k2_plain_ms:.4f}", library_ms=f"{k2_library_ms:.4f}",
        bound_ms=f"{k2_bound_ms:.4f}",
        bound_by=k2_bound_by)
    del got, want, library

    # 9. K1 (b)+(c) vs plain: the visualizer tail of one real frame
    frame = tailfuse.fused_tail_final(*tail_args)
    k1v_err, k1v_share = u8_diff(frame.cpu(), tailfuse.tail_plain(*tail_args).cpu())
    if k1v_err > 1 or k1v_share >= 0.01:
        raise AssertionError(f"K1 (b)+(c) vs plain: max {k1v_err} u8 steps on {k1v_share:.4%}")
    launch = tailgen.prepare(*tail_args, device)
    k1v_ms = device_ms(lambda: launch(k1_out))
    k1v_call_ms = median_ms(lambda: launch(k1_out), 20)
    k1v_plain_ms = device_ms(lambda: tailfuse.tail_plain(*tail_args), 5)
    k1v_bound_ms, k1v_bound_by = walked_bound(lambda: launch(k1_out))
    k1v_compiled = k1_figures(launch)
    say("k1bc", render=f"{render_h}x{render_w}", out=f"{HEIGHT}x{WIDTH}", s=SSAA,
        frame=check, max_u8_diff=k1v_err, differing_share=f"{k1v_share:.3e}",
        ms=f"{k1v_ms:.4f}", call_ms=f"{k1v_call_ms:.4f}", plain_ms=f"{k1v_plain_ms:.4f}",
        bound_ms=f"{k1v_bound_ms:.4f}", bound_by=k1v_bound_by, **k1v_compiled)

    # 10. Visualizer render throughput into the NullSink
    scene = torch_demo.Visualizer()
    started = time.perf_counter()
    scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS,
               output="null", device="cuda")
    null_s = time.perf_counter() - started
    say("visualizer_timing", config="Visualizer 1920x1080 60fps 2xSSAA 2s null",
        frames=frames, seconds=f"{null_s:.4f}", fps=f"{frames / null_s:.3f}",
        card=repr(card))

    # 11. The PianoRoll slice at 4K60, ssaa=1, 0.5 s, through the entry point
    piano_w, piano_h, piano_frames = 3840, 2160, 30
    with tempfile.TemporaryDirectory() as tmp:
        output = Path(tmp) / "pianoroll.rgb"
        scene = torch_piano_roll.PianoRoll()
        zero_counters()
        started = time.perf_counter()
        scene.main(width=piano_w, height=piano_h, fps=FPS, ssaa=1, time=piano_frames / FPS,
                   output=str(output), device="cuda")
        export_s = time.perf_counter() - started
        piano_launches = read_counters()
        if piano_launches != {"k3": 0, "k3p": 0, "k2": 0, "k1": 0, "k1d": piano_frames,
                              "k1h": 0}:
            raise AssertionError(f"PianoRoll launch counters {piano_launches}, expected "
                                 f"K1 (d) == {piano_frames} frames and no other kernel")
        check, exported = check_export(output, piano_frames, output.name, piano_h, piano_w)
        frame_spec = piano_spec(scene, check)
        planes_args = (frame_spec, piano_h, piano_w, piano_h, piano_w, 1, scene.aspect_ratio)
        plain_planes = tailfuse.planes_plain(frame_spec, piano_h, piano_w, scene.aspect_ratio)
        plain_frame = tailfuse.final_equal_resolution(plain_planes, scene.subsample)
        frame_err, frame_share = u8_diff(exported, plain_frame.cpu())
        if frame_err > 1:
            raise AssertionError(f"PianoRoll frame {check} vs plain functions: "
                                 f"max {frame_err} u8 steps on {frame_share:.4%}")
        say("pianoroll_slice", size=f"{piano_w}x{piano_h}", ssaa=1, frames=piano_frames,
            seconds=f"{export_s:.3f}", launches=piano_launches, frame_checked=check,
            max_u8_diff_vs_plain=frame_err, differing_share=f"{frame_share:.3e}")
        del exported

    # 12. K1 (d) vs plain: the PianoRoll tail of that real frame at 4K, s = 1
    planes = tailfuse.fused_tail_final(*planes_args, quantize=False)
    torch.cuda.synchronize()
    if not torch.equal(planes.view(torch.int16), plain_planes.view(torch.int16)):
        differing = int((planes.view(torch.int16) != plain_planes.view(torch.int16)).sum())
        raise AssertionError(f"K1 (d) bf16 planes differ from the plain version on "
                             f"{differing} values")
    k1d_err = (planes.float() - plain_planes.float()).abs().max().item()
    final = tailfuse.final_equal_resolution(planes, scene.subsample)
    k1d_u8, k1d_share = u8_diff(final.cpu(), plain_frame.cpu())
    if k1d_u8 > 1 or k1d_share >= 0.01:
        raise AssertionError(f"K1 (d) final u8 vs plain: max {k1d_u8} on {k1d_share:.4%}")
    launch = tailgen.prepare(*planes_args, device, quantize=False)
    planes_out = torch.empty_like(planes)
    k1d_ms = device_ms(lambda: launch(planes_out))
    k1d_call_ms = median_ms(lambda: launch(planes_out), 20)
    k1d_plain_ms = device_ms(lambda: tailfuse.planes_plain(
        frame_spec, piano_h, piano_w, scene.aspect_ratio), 5)
    stencil_ms = device_ms(lambda: tailfuse.final_equal_resolution(planes, scene.subsample), 10)
    k1d_bound_ms, k1d_bound_by = walked_bound(lambda: launch(planes_out))
    k1d_compiled = k1_figures(launch)
    graph, _ = tailgen.trace(frame_spec, piano_h, piano_w, scene.aspect_ratio)
    started = time.perf_counter()
    for _ in range(20):
        tailgen.prepare(*planes_args, device, quantize=False)
    prepare_ms = (time.perf_counter() - started) / 20 * 1e3
    say("k1d", render=f"{piano_h}x{piano_w}", s=1, frame=check, inputs=len(graph.inputs) - 2,
        nodes=len(graph.nodes), planes_bit_equal=True, max_u8_diff=k1d_u8,
        differing_share=f"{k1d_share:.3e}", ms=f"{k1d_ms:.4f}", call_ms=f"{k1d_call_ms:.4f}",
        plain_ms=f"{k1d_plain_ms:.4f}", bound_ms=f"{k1d_bound_ms:.4f}",
        bound_by=k1d_bound_by, stencil_quantize_ms=f"{stencil_ms:.4f}",
        host_trace_prepare_ms=f"{prepare_ms:.4f}", **k1d_compiled)
    del planes, planes_out, plain_planes, final, plain_frame

    # 13. PianoRoll render throughput into the NullSink
    scene = torch_piano_roll.PianoRoll()
    started = time.perf_counter()
    scene.main(width=piano_w, height=piano_h, fps=FPS, ssaa=1, time=SECONDS,
               output="null", device="cuda")
    null_s = time.perf_counter() - started
    say("pianoroll_timing", config="PianoRoll 3840x2160 60fps ssaa=1 2s null",
        frames=frames, seconds=f"{null_s:.4f}", fps=f"{frames / null_s:.3f}", card=repr(card))

    # 14. + 15. Julia and the rotated Mandelbrot through the entry point, then
    # K3 planes vs plain on each slice's frame 0
    plane_slices = {}
    for name, cls in (("julia", torch_fractals.Julia),
                      ("rotated_mandelbrot", torch_fractals.MandelbrotRotated)):
        with tempfile.TemporaryDirectory() as tmp:
            output = Path(tmp) / f"{name}.rgb"
            scene = cls()
            zero_counters()
            started = time.perf_counter()
            scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS,
                       output=str(output), device="cuda")
            export_s = time.perf_counter() - started
            launches = read_counters()
            if launches != {"k3": 0, "k3p": frames, "k2": 0, "k1": frames, "k1d": 0,
                            "k1h": 0}:
                raise AssertionError(f"{name} launch counters {launches}, expected K3 planes "
                                     f"== K1 == {frames} frames, no other kernel")
            check, exported = check_export(output, frames, output.name)
            plain_frame, _, _ = fractal_plain_frame(scene, check, render_h, render_w)
            frame_err, frame_share = u8_diff(exported, plain_frame.cpu())
            if frame_err > 1:
                raise AssertionError(f"{name} frame {check} vs plain functions: "
                                     f"max {frame_err} u8 steps on {frame_share:.4%}")
            say(f"{name}_slice", frames=frames, seconds=f"{export_s:.3f}", launches=launches,
                frame_checked=check, max_u8_diff_vs_plain=frame_err,
                differing_share=f"{frame_share:.3e}")
        _, (z0, cx, cy, interior), quality = fractal_plain_frame(scene, 0, render_h, render_w)
        if name == "julia":
            cap = torch_fractals.julia_cap(quality)
            k3p_args = (z0, cx, cy, quality, 3.0, None, cap, True, torch.float32)
            run_kernel = lambda: fractal.escape_iterations_z0(*k3p_args)
            run_plain = lambda: fractal.escape_plain(z0[..., 0], z0[..., 1], cx, cy, quality,
                                                     3.0, saturate=cap, out_dtype=torch.float32)
        else:
            cap = torch_fractals.mandelbrot_cap(quality)
            c = z0
            run_kernel = lambda: fractal.escape_iterations(c, quality, 3.0, cap, torch.float32)
            run_plain = lambda: fractal.escape_plain(c[..., 0], c[..., 1], c[..., 0], c[..., 1],
                                                     quality, 3.0, interior=interior,
                                                     saturate=cap, out_dtype=torch.float32)
        counts, plain_counts = run_kernel(), run_plain()
        torch.cuda.synchronize()
        err = (counts - plain_counts).abs().max().item()
        if not torch.equal(counts, plain_counts):
            raise AssertionError(f"K3 planes ({name}) counts differ from the plain loop on "
                                 f"{int((counts != plain_counts).sum())} pixels (max {err})")
        k3p_ms = device_ms(run_kernel)
        k3p_call_ms = median_ms(run_kernel, 20)
        k3p_plain_ms = device_ms(run_plain, 3)
        steps = escape_steps(counts, interior)
        k3p_bound_ms, k3p_bound_by = walked_bound(run_kernel, steps / counts.numel())
        plane_slices[name] = dict(launches=launches, err=err, ms=k3p_ms, call_ms=k3p_call_ms,
                                  plain_ms=k3p_plain_ms, bound_ms=k3p_bound_ms,
                                  bound_by=k3p_bound_by)
        say(f"k3p_{name}", shape=f"{render_h}x{render_w}", max_iter=quality, cap=cap,
            steps=steps, c="0-d device tensors" if name == "julia" else "planes, interior "
            "in-kernel", equal=True, ms=f"{k3p_ms:.4f}", call_ms=f"{k3p_call_ms:.4f}",
            plain_ms=f"{k3p_plain_ms:.4f}",
            bound_ms=f"{k3p_bound_ms:.4f}", bound_by=k3p_bound_by)
        del counts, plain_counts, z0, interior

        # 16. Render throughput into the NullSink
        scene = cls()
        started = time.perf_counter()
        scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS,
                   output="null", device="cuda")
        null_s = time.perf_counter() - started
        say(f"{name}_timing", config=f"{cls.__name__} 1920x1080 60fps 2xSSAA 2s null",
            frames=frames, seconds=f"{null_s:.4f}", fps=f"{frames / null_s:.3f}",
            card=repr(card))

    # 17. T3: the cost walker's fixture and the walker's counts (its own path)
    x = (torch.arange(128 * 128, dtype=torch.float32, device=device) / 7.0).reshape(128, 128)
    flopcount.fixture.launches = 0
    with flopcount.Walker() as walker:
        fixture_out = flopcount.fixture(x)
    t3_launches = flopcount.fixture.launches
    fixture_want = flopcount.fixture_plain(x)
    torch.cuda.synchronize()
    t3_err = (fixture_out - fixture_want).abs().max().item()
    hand = (4 * 2 * 32 * 128, 2 * 128 * 128 * 4)   # body x grid: ops, bytes
    if not torch.equal(fixture_out, fixture_want) or t3_launches != 1:
        raise AssertionError(f"T3 fixture vs x * 2 + 1: max {t3_err}, launches {t3_launches}")
    if (walker.cost.alu, walker.cost.kernel_bytes) != hand:
        raise AssertionError(f"walker counted {walker.cost}, hand count (ops, bytes) {hand}")
    t3_ms = device_ms(lambda: flopcount.fixture(x))
    t3_call_ms = median_ms(lambda: flopcount.fixture(x), 20)
    t3_plain_ms = device_ms(lambda: flopcount.fixture_plain(x))
    one, two = torch.ones((), device=device), torch.full((), 2.0, device=device)
    if not torch.equal(torch.addcmul(one, x, two), fixture_want):
        raise AssertionError("T3's library call differs from x * 2 + 1")
    t3_library_ms = device_ms(lambda: torch.addcmul(one, x, two))
    t3_bound_ms, t3_bound_by = flopcount.roofline(walker.cost)
    say("t3", shape="128x128", blocks=4, equal=True, walker_alu=int(walker.cost.alu),
        walker_bytes=int(walker.cost.kernel_bytes), hand=hand, launches=t3_launches,
        ms=f"{t3_ms:.4f}", call_ms=f"{t3_call_ms:.4f}", plain_ms=f"{t3_plain_ms:.4f}",
        bound_ms=f"{t3_bound_ms:.6f}",
        bound_by=t3_bound_by, library_ms=f"{t3_library_ms:.4f}")

    # 18. T1: the bf16 op probe through K1's compiler (its own path)
    probe_bf16_ops.run_op.launches = 0
    started = time.perf_counter()
    table = probe_bf16_ops.probe_all(device)
    t1_s = time.perf_counter() - started
    t1_launches = probe_bf16_ops.run_op.launches
    for name, result in table.items():
        say("t1", op=name, result=repr(result))
    probe_faults = {op: table[op] for op in tailgen.BF16_PROBE_OK if table[op] != "ok"}
    if probe_faults or t1_launches == 0:
        raise AssertionError(f"the recorded bf16 probe table says ok, but the probe finds "
                             f"{probe_faults} on this card (launches {t1_launches})")
    a16, b16 = probe_bf16_ops.inputs(device)[1]
    mul = probe_bf16_ops.compile_op("mul")
    t1_err = (probe_bf16_ops.run_op(mul, a16, b16).float() - (a16 * b16).float()).abs().max().item()
    t1_ms = device_ms(lambda: probe_bf16_ops.run_op(mul, a16, b16))
    t1_call_ms = median_ms(lambda: probe_bf16_ops.run_op(mul, a16, b16), 20)
    t1_plain_ms = device_ms(lambda: a16 * b16)
    t1_bound_ms, t1_bound_by = walked_bound(lambda: probe_bf16_ops.run_op(mul, a16, b16))
    say("t1_summary", ops=len(table), ok=sum(r == "ok" for r in table.values()),
        seconds=f"{t1_s:.3f}", launches=t1_launches,
        mul_ms=f"{t1_ms:.4f}", mul_call_ms=f"{t1_call_ms:.4f}",
        mul_plain_ms=f"{t1_plain_ms:.4f}",
        bound_ms=f"{t1_bound_ms:.6f}", bound_by=t1_bound_by)

    # 19. T2: the tail-shaped chain in float32 and bfloat16 (its own path)
    bench_dtype.chain.launches = 0
    t2 = bench_dtype.bench()
    t2_launches = bench_dtype.chain.launches
    t2_f32, t2_bf16 = t2["float32"], t2["bfloat16"]
    if not (t2_f32["equal"] and t2_bf16["equal"]):
        raise AssertionError(f"T2 chain vs plain: f32 max {t2_f32['max_abs_err']}, "
                             f"bf16 max {t2_bf16['max_abs_err']}")
    t2_inputs = bench_dtype.inputs(torch.bfloat16)
    t2_bound_ms, t2_bound_by = walked_bound(lambda: bench_dtype.chain(*t2_inputs))
    t2_f32_inputs = bench_dtype.inputs(torch.float32)
    t2_times = {}
    for dtype, inputs in (("bf16", t2_inputs), ("f32", t2_f32_inputs)):
        t2_times[dtype] = dict(
            ms=device_ms(lambda: bench_dtype.chain(*inputs)),
            call_ms=median_ms(lambda: bench_dtype.chain(*inputs), 20),
            plain_ms=device_ms(lambda: bench_dtype.chain_plain(*inputs), 3))
    say("t2", shape=f"{bench_dtype.H}x{bench_dtype.W}", reps=bench_dtype.REPS,
        launches=t2_launches, **{f"{dtype}_{key}": f"{value:.4f}" for dtype in t2_times
                                 for key, value in t2_times[dtype].items()},
        f32_bench_ms=f"{t2_f32['ms']:.4f}", bf16_bench_ms=f"{t2_bf16['ms']:.4f}",
        f32_tops=f"{t2_f32['tops']:.2f}", bf16_tops=f"{t2_bf16['tops']:.2f}",
        bound_ms=f"{t2_bound_ms:.4f}", bound_by=t2_bound_by,
        verdict=repr(bench_dtype.verdict(t2_times["f32"]["ms"], t2_times["bf16"]["ms"])))

    # 20. The bf16 tail mode at blur level 1: the visualizer slice
    os.environ.update(SHADERFLOW_TAIL_BF16="1", SHADERFLOW_VIZ_BLUR_LEVEL="1")
    with tempfile.TemporaryDirectory() as tmp:
        output = Path(tmp) / "visualizer_bf16.rgb"
        scene = torch_demo.Visualizer()
        zero_counters()
        started = time.perf_counter()
        scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS,
                   output=str(output), device="cuda")
        export_s = time.perf_counter() - started
        bf16_launches = read_counters()
        flushes = -(-frames // scene.default_batch_size())
        if bf16_launches != {"k3": 0, "k3p": 0, "k2": flushes, "k1": frames, "k1d": 0,
                             "k1h": frames}:
            raise AssertionError(f"bf16 visualizer launch counters {bf16_launches}, expected "
                                 f"K2 == {flushes} flushes, K1 == K1 bf16 == {frames} "
                                 "frames, K3 == 0")
        check, exported = check_export(output, frames, output.name)
        frame_spec = visualizer_spec(scene, check)
        tail_args = (frame_spec, render_h, render_w, HEIGHT, WIDTH, SSAA, aspect)
        frame_err, frame_share = u8_diff(exported, tailfuse.tail_plain(*tail_args).cpu())
        if frame_err > 1:
            raise AssertionError(f"bf16 visualizer frame {check} vs plain functions: "
                                 f"max {frame_err} u8 steps on {frame_share:.4%}")
        say("visualizer_bf16_slice", frames=frames, flushes=flushes, blur_level=1,
            seconds=f"{export_s:.3f}", launches=bf16_launches, frame_checked=check,
            max_u8_diff_vs_plain=frame_err, differing_share=f"{frame_share:.3e}")
        spec0 = visualizer_spec(scene, 0)
        del exported

    # 21. K1 bf16 (b)+(c) vs plain: the bf16 level-1 visualizer tail of frame 0
    tail0 = (spec0, render_h, render_w, HEIGHT, WIDTH, SSAA, aspect)
    frame = tailfuse.fused_tail_final(*tail0).cpu()
    k1h_err, k1h_share = u8_diff(frame, tailfuse.tail_plain(*tail0).cpu())
    if k1h_err > 1 or k1h_share >= 0.01:
        raise AssertionError(f"K1 bf16 (b)+(c) vs plain: max {k1h_err} u8 steps on "
                             f"{k1h_share:.4%}")
    k1h_eager = eager_check("K1 bf16 (b)+(c)", frame, tail0)
    launch = tailgen.prepare(*tail0, device)
    k1h_ms = device_ms(lambda: launch(k1_out))
    k1h_call_ms = median_ms(lambda: launch(k1_out), 20)
    k1h_plain_ms = device_ms(lambda: tailfuse.tail_plain(*tail0), 5)
    k1h_bound_ms, k1h_bound_by = walked_bound(lambda: launch(k1_out))
    k1h_compiled = k1_figures(launch)
    say("k1bf16_bc", render=f"{render_h}x{render_w}", out=f"{HEIGHT}x{WIDTH}", s=SSAA,
        frame=0, max_u8_diff=k1h_err, differing_share=f"{k1h_share:.3e}",
        eager_max_u8_diff=k1h_eager[0], eager_psnr_db=f"{k1h_eager[1]:.2f}",
        ms=f"{k1h_ms:.4f}", call_ms=f"{k1h_call_ms:.4f}", plain_ms=f"{k1h_plain_ms:.4f}",
        bound_ms=f"{k1h_bound_ms:.4f}", bound_by=k1h_bound_by, **k1h_compiled)

    # 22. K1 bf16 (a) vs plain: the Mandelbrot tail spec of phase 4 in bf16
    frame = tailfuse.fused_tail_final(*k1_args).cpu()
    k1ha_err, k1ha_share = u8_diff(frame, tailfuse.tail_plain(*k1_args).cpu())
    if k1ha_err > 1 or k1ha_share >= 0.01:
        raise AssertionError(f"K1 bf16 (a) vs plain: max {k1ha_err} u8 steps on "
                             f"{k1ha_share:.4%}")
    k1ha_eager = eager_check("K1 bf16 (a)", frame, k1_args)
    launch = tailgen.prepare(*k1_args, device)
    k1ha_ms = device_ms(lambda: launch(k1_out))
    k1ha_call_ms = median_ms(lambda: launch(k1_out), 20)
    k1ha_bound_ms, k1ha_bound_by = walked_bound(lambda: launch(k1_out))
    k1ha_compiled = k1_figures(launch)
    say("k1bf16_a", render=f"{render_h}x{render_w}", out=f"{HEIGHT}x{WIDTH}", s=SSAA,
        max_u8_diff=k1ha_err, differing_share=f"{k1ha_share:.3e}",
        eager_max_u8_diff=k1ha_eager[0], eager_psnr_db=f"{k1ha_eager[1]:.2f}",
        ms=f"{k1ha_ms:.4f}", call_ms=f"{k1ha_call_ms:.4f}",
        bound_ms=f"{k1ha_bound_ms:.4f}", bound_by=k1ha_bound_by, **k1ha_compiled)

    # 23. bf16 level-1 visualizer throughput into the NullSink
    scene = torch_demo.Visualizer()
    started = time.perf_counter()
    scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS,
               output="null", device="cuda")
    null_s = time.perf_counter() - started
    say("visualizer_bf16_timing",
        config="Visualizer 1920x1080 60fps 2xSSAA 2s null, bf16 tail, blur level 1",
        frames=frames, seconds=f"{null_s:.4f}", fps=f"{frames / null_s:.3f}", card=repr(card))

    # 24. The offline example scenes (configs 1, 2 and 4, Tetration, and the
    # engine's program loop), each its own path: counters zeroed before it
    # runs and read after; back to the default f32 tail and blur level
    for variable in ("SHADERFLOW_TAIL_BF16", "SHADERFLOW_VIZ_BLUR_LEVEL"):
        os.environ.pop(variable, None)
    import importlib
    scenes = {}
    for name, module, width, height, fps, seconds, ssaa in SCENE_PATHS:
        cls = getattr(importlib.import_module(module), name)
        scenes[name] = scene_path(cls, width, height, fps, seconds, ssaa,
                                  (zero_counters, read_counters), card)
        if name == "Tetration":
            tetration = cls()
            tetration.main(width=width, height=height, fps=fps, ssaa=ssaa, time=2 / fps,
                           output="null", device="cuda")
            tetration_spec = tetration.shader.fragment(frame_inputs(tetration, 0))

    # 25. K1 (a) vs plain on Tetration's tail spec of frame 0 at 3840x2160 ->
    # 1920x1080, s = 2 (its hue pick: remainder, floor, abs, where, atan2)
    tetra_args = (tetration_spec, render_h, render_w, HEIGHT, WIDTH, SSAA, aspect)
    frame = tailfuse.fused_tail_final(*tetra_args)
    k1t_err, k1t_share = u8_diff(frame.cpu(), tailfuse.tail_plain(*tetra_args).cpu())
    if k1t_err > 1 or k1t_share >= 0.01:
        raise AssertionError(f"K1 (a) on Tetration's tail vs plain: max {k1t_err} u8 steps "
                             f"on {k1t_share:.4%}")
    launch = tailgen.prepare(*tetra_args, device)
    k1t_ms = device_ms(lambda: launch(k1_out))
    k1t_call_ms = median_ms(lambda: launch(k1_out), 20)
    k1t_plain_ms = device_ms(lambda: tailfuse.tail_plain(*tetra_args), 5)
    k1t_bound_ms, k1t_bound_by = walked_bound(lambda: launch(k1_out))
    k1t_compiled = k1_figures(launch)
    say("k1a_tetration", render=f"{render_h}x{render_w}", out=f"{HEIGHT}x{WIDTH}", s=SSAA,
        frame=0, max_u8_diff=k1t_err, differing_share=f"{k1t_share:.3e}",
        ms=f"{k1t_ms:.4f}", call_ms=f"{k1t_call_ms:.4f}", plain_ms=f"{k1t_plain_ms:.4f}",
        bound_ms=f"{k1t_bound_ms:.4f}", bound_by=k1t_bound_by,
        launches=scenes["Tetration"]["launches"]["k1"], **k1t_compiled)
    del frame, tetration_spec
    print(json.dumps({"scenes": scenes}))

    julia = plane_slices["julia"]
    kernels = [
        {"name": "K1 (a) fused tail + 2x2 pool + u8 quantize (Mandelbrot tail: planes, cols)",
         "route": "triton", "source": "shaderflow_tpu_torch/ops/tailgen.py",
         "replaces": "shaderflow_tpu/ops/tailfuse.py:485",
         "launches": mandelbrot_launches["k1"], "max_abs_err": k1_err,
         "ms": k1_ms, "call_ms": k1_call_ms, "plain_ms": k1_plain_ms, "bound_ms": k1_bound_ms,
         "bound_by": k1_bound_by, "library_ms": None, **k1_compiled,
         "bf16_ms": k1ha_ms, "bf16_call_ms": k1ha_call_ms, "bf16_bound_ms": k1ha_bound_ms,
         "bf16_compiled": k1ha_compiled,
         "tetration": {"launches": scenes["Tetration"]["launches"]["k1"],
                       "max_abs_err": k1t_err, "ms": k1t_ms, "call_ms": k1t_call_ms,
                       "plain_ms": k1t_plain_ms, "bound_ms": k1t_bound_ms,
                       "bound_by": k1t_bound_by, **k1t_compiled}},
        {"name": "K1 (b)+(c) fused tail with Indexed and ColSampled inputs (visualizer tail)",
         "route": "triton", "source": "shaderflow_tpu_torch/ops/tailgen.py",
         "replaces": "shaderflow_tpu/ops/tailfuse.py:485",
         "launches": visualizer_launches["k1"], "max_abs_err": k1v_err,
         "ms": k1v_ms, "call_ms": k1v_call_ms, "plain_ms": k1v_plain_ms,
         "bound_ms": k1v_bound_ms, "bound_by": k1v_bound_by, "library_ms": None,
         **k1v_compiled},
        {"name": "K2 lookup_expand (bar-field table expand)",
         "route": "cuda", "source": "shaderflow_tpu_torch/csrc/lookup.cu",
         "replaces": "shaderflow_tpu/ops/sampling.py:851",
         "launches": visualizer_launches["k2"], "max_abs_err": k2_err,
         "ms": k2_ms, "call_ms": k2_call_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
         "bound_by": k2_bound_by, "library_ms": k2_library_ms},
        {"name": "K1 (d) fused tail, quantize=False: bf16 planes at s = 1 (PianoRoll tail)",
         "route": "triton", "source": "shaderflow_tpu_torch/ops/tailgen.py",
         "replaces": "shaderflow_tpu/ops/tailfuse.py:485",
         "launches": piano_launches["k1d"], "max_abs_err": k1d_err,
         "ms": k1d_ms, "call_ms": k1d_call_ms, "plain_ms": k1d_plain_ms,
         "bound_ms": k1d_bound_ms, "bound_by": k1d_bound_by, "library_ms": None,
         **k1d_compiled},
        {"name": "K3 escape_lines (Mandelbrot escape counts, lines form)",
         "route": "cuda", "source": "shaderflow_tpu_torch/csrc/escape.cu",
         "replaces": "shaderflow_tpu/ops/fractal.py:66",
         "launches": mandelbrot_launches["k3"], "max_abs_err": k3_err,
         "ms": k3_ms, "call_ms": k3_call_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound_ms,
         "bound_by": k3_bound_by, "library_ms": None, **k3_compiled["lines"]},
        {"name": "K3 escape_planes (Julia escape counts, planes form, c on the device)",
         "route": "cuda", "source": "shaderflow_tpu_torch/csrc/escape.cu",
         "replaces": "shaderflow_tpu/ops/fractal.py:66",
         "launches": julia["launches"]["k3p"], "max_abs_err": julia["err"],
         "ms": julia["ms"], "call_ms": julia["call_ms"], "plain_ms": julia["plain_ms"],
         "bound_ms": julia["bound_ms"], "bound_by": julia["bound_by"], "library_ms": None,
         **k3_compiled["julia"],
         "rotated": {**plane_slices["rotated_mandelbrot"], **k3_compiled["rotated"]}},
        {"name": "K1 bf16 (b)+(c): the bf16 color chain (bf16 level-1 visualizer tail)",
         "route": "triton", "source": "shaderflow_tpu_torch/ops/tailgen.py",
         "replaces": "shaderflow_tpu/ops/tailfuse.py:485",
         "launches": bf16_launches["k1h"], "max_abs_err": k1h_err,
         "ms": k1h_ms, "call_ms": k1h_call_ms, "plain_ms": k1h_plain_ms,
         "bound_ms": k1h_bound_ms, "bound_by": k1h_bound_by, "library_ms": None,
         **k1h_compiled},
        {"name": "T1 probe_bf16_ops (one bf16 kernel per op; timed: mul at 256x256)",
         "route": "triton", "source": "shaderflow_tpu_torch/tools/probe_bf16_ops.py",
         "replaces": "tools/probe_bf16_ops.py:45",
         "launches": t1_launches, "max_abs_err": t1_err,
         "ms": t1_ms, "call_ms": t1_call_ms, "plain_ms": t1_plain_ms, "bound_ms": t1_bound_ms,
         "bound_by": t1_bound_by, "library_ms": t1_plain_ms,
         "table": table},
        {"name": "T2 bench_dtype chain (timed: bf16; f32 beside it)",
         "route": "triton", "source": "shaderflow_tpu_torch/tools/bench_dtype.py",
         "replaces": "tools/bench_vpu_dtype.py:35",
         "launches": t2_launches, "max_abs_err": t2_bf16["max_abs_err"],
         **t2_times["bf16"], "bound_ms": t2_bound_ms, "bound_by": t2_bound_by, "library_ms": None,
         **{f"f32_{key}": value for key, value in t2_times["f32"].items()},
         "speedup": t2_times["f32"]["ms"] / t2_times["bf16"]["ms"]},
        {"name": "T3 cost-walker fixture x * 2 + 1 (128x128, four (32, 128) blocks)",
         "route": "cuda", "source": "shaderflow_tpu_torch/csrc/fixture.cu",
         "replaces": "tests/test_flopcount.py:64",
         "launches": t3_launches, "max_abs_err": t3_err,
         "ms": t3_ms, "call_ms": t3_call_ms, "plain_ms": t3_plain_ms, "bound_ms": t3_bound_ms,
         "bound_by": t3_bound_by, "library_ms": t3_library_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
