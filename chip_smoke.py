#!/usr/bin/env python3
"""
Smoke test of the PyTorch port (shaderflow_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh    # phases 43-44 alone, on every card there

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
 17. T3: the cost walker's fixture (csrc/fixture.cu, x * 2 + 1, one flat
     16-byte stream) at 128x128 (four logical (32, 128) blocks), at a 64
     MiB stream (32 x 4096 rows) and at 32 and 32 x 133 rows: one launch
     each, torch.equal to its plain version, the walker's counts equal to
     the hand counts (body x logical grid); the launch's CTAs, threads and
     registers; at 128x128 and at the stream size its device ms beside its
     bound (the share) and beside an empty kernel's (the gap)
 18. T1: the bf16 op probe through K1's compiler, one launch an op over
     both input sets stacked, its table printed; every op of the recorded
     table (tailgen.BF16_PROBE_OK) must still be `ok`; the launches and
     the timed stacked launch beside phase 17's empty launch
 19. T2: the f32-vs-bf16 chain (csrc/chain.cu), each dtype equal to its
     plain chain, timed in turns by CUDA-graph replay beside its bound; its
     square root equal to torch.sqrt on every float32 in [2^-10, 4); each
     kernel's registers and spills (none allowed), SASS instructions a
     round and packed bf16x2 arithmetic (required in bf16), a round's
     issue slots (40 against 80 rounds); the verdict
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
  and Waveform 1280x720@30 2 s of the asset; RayMarch 1920x1080@60 1 s;
  Tetration 1920x1080@60 2x SSAA 1 s; Dynamics, MultiShader, Multipass,
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
  The GLSL front-end and the command line (examples/torch/torch_glsl_demo.py)
 26. Plasma (examples/glsl/shaders/plasma.frag) at 1920x1080@60, 2x SSAA,
     2 s through cli.main to a .rgb file: file size, the GLSL interpreter
     (not the missing-texture program), no kernel launched, the middle
     frame against device="cpu" within 1 u8 step on < 1 %; the same command
     as a `python -m shaderflow_tpu_torch` process (file size); a null
     export through cli.main: fps, device ms, kernels, host ms a frame, busy
 27. the masked loop (Escape: a per-pixel break over 256 trips) at
     1920x1080, 2x SSAA: a frame's wall ms, trips and host reads for each
     read interval k, on two views; device ms, kernels and host ms a frame
     at the k in use; the card against the CPU at 480x270
 28. Mandelbrot through cli.main at 1920x1080@60, 2x SSAA, 1 s: K3 and K1
     (a) launch once a frame, nothing else
  The realtime preview (Scene.main without an output, 1920x1080, 2x SSAA)
 29. the visualizer, headless, at 60 fps for REALTIME_FRAMES frames: K1 ==
     K2 == frames rendered, K3 == 0; the achieved fps, the frames whose dt
     exceeded 1.5 periods, the host ms a frame (capture, flush enqueue,
     the wait on frame k-1), one frame's device ms and kernels
     (device_profile), the micro-batch size it ended at, the staging
     upload against a fresh pin_memory(); the unpaced ceiling (fps=1000,
     frameskip off, CEILING_FRAMES frames: frames per wall second; run
     first, so the paced run starts with its kernels built); frame
     2 at dt = 1/60 against its plain recomputation (plain K2 gather,
     plain tail: at most 1 u8 step on < 1 %) and against device="cpu" (at
     most 1 step on < 2 %); the realtime tail's K1 and K2 at batch 1 timed
     against their plain versions and bounds
 30. Mandelbrot, the same way: K3 == K1 == frames; the achieved fps and
     the ceiling
 31. the display pump on the visualizer with a recording stub window
     (show / poll): frames offered, shown and dropped, the median D2H ms;
     the last shown frame equal to a copy of the engine's frame at that
     index, taken on the render stream when it was flushed (no torn frame)
Then a {"realtime": ...} line with phases 29-31's figures.
  Any supersampling factor (the general final pass where the ratio is
  not an integer: the tail through its plain path, no K1; K1 at an
  integer ratio above the subsample), mipmaps and video
 32. (a) the visualizer at 1920x1080@60, ssaa 1.5 (render 2880x1620), a 1 s
     null export: K2 == batches, K1 == K3 == 0; (b) Mandelbrot at -s 4
     through cli.main (render 7680x4320, subsample 2), a 1 s null export:
     K3 == K1 == frames, every K1 launch one of ratio 4; fps, device ms,
     kernels and host ms a frame; the last frame against device="cpu"
     (a), against the plain path on the card (b), at most 1 u8 step on
     < 2 % / < 1 %; K2, K3 and K1 at these shapes against their plain
     versions, timed, with their bounds (the any_ssaa entries; K1's
     registers and spills)
 33. a realtime Mandelbrot at 1080p, ssaa 0.5 (render 960x540, upsampled):
     warm-up, REALTIME_FRAMES at 60 fps: K3 == frames, K1 == 0, fps, late
     ticks, host and device ms; frame 2 against device="cpu"
 34. a mipmapped background (mip_background_scene: background.png at about
     4 texels a pixel through stexture) at 1080p, isotropic and with
     anisotropy=4: no kernel, one pyramid build a run, fps, device ms;
     frame 0 against device="cpu"
 35. the Video scene at 3840x2160@60, ssaa 1, 2 s from a 3840x2160 60 fps
     source through the port's ffmpeg pipe (a stub ffmpeg and ffprobe on
     PATH replay pre-made rgb24 frames): no kernel, the texture streamed
     as u8 through the staging buffer; fps beside the stub pipe's own rate;
     frame 1 against device="cpu"
Then an {"any_ssaa": ...} line (32-34) and a {"video": ...} line (35).
  The audio and export surface
 36. the visualizer at 1920x1080@60, 2x SSAA, SECONDS, its audio decoded
     from music.flac through the port's ffmpeg pipe (a stub ffmpeg and
     ffprobe on PATH replay music.wav's samples as f32le) to a .rgb file:
     bit-equal to the export of music.wav read by the stdlib; counters K2
     == batches, K1 == frames, nothing else; the progress relay over every
     frame; the decode's time; a null export's fps, device and host ms a
     frame; then output "pipe" and "tcp://127.0.0.1:<port>" without ffmpeg
     (PipeSink; TCPSink into a listener thread here): the .rgb bytes; and
     "pipe" with the stub as encoder: its stdout, F x H x W x 3 bytes fed
 37. the Audio scene (a recorder's volume as brightness) in the realtime
     loop, headless, 1920x1080@60, ssaa 1, REALTIME_FRAMES frames after a
     warm-up, its recorder a stub backend feeding a sine: no kernel of
     K1-K3 (counters 0), fps, late ticks, host ms a frame, device ms and
     kernels a frame; frame 29 at dt = 1/60 equal to device="cpu"'s; where
     pygame imports, a run on SDL's dummy driver
Then an {"audio": ...} line (36-37).
  The live piano, the HUD, the cv2 preview, FluidSynth and segments
 38. the live PianoRoll at 3840x2160, ssaa 1, in the realtime loop,
     headless (a warm-up, the unpaced ceiling, then REALTIME_FRAMES at 60
     fps): the note scan each frame into three streamed textures, K1 (d)
     == frames and nothing else; fps, late ticks, host ms a frame with the
     scan apart, device ms and kernels a frame; frame 2 at dt = 1/60
     against its plain recomputation and against device="cpu" (at most 1
     u8 step on < 1 %); K1 (d) on its tail: planes bit-equal to plain,
     timed against its bound (the K1 (d) row's realtime entry)
 39. the realtime visualizer at 1920x1080, 2x SSAA through the display
     pump into a stub window with the HUD on: K1 == K2 == frames, fps
     against 60, the HUD's ms a frame, the last shown frame outside the
     HUD's box equal to the engine's frame
 40. realtime Mandelbrot at 1920x1080, 2x SSAA in the cv2 preview through
     a stub cv2 module (no real window): waitKey's 'w' moves the camera,
     its release synthesized; the last shown frame equal to the engine's
 41. the FluidSynth hooks through a stub synth module: the log of a
     PianoRoll run on the card equal to the CPU's
 42. the visualizer at 1920x1080@60, 2x SSAA, SECONDS as two segments
     exported by two concurrent processes on the card
     (parallel.export_segment), joined: sha256-equal to the single
     export; each process's seconds and counters
Then a {"live": ...} line (38-42).
  Multi-device sharding (parallel/mesh.py), each configuration exported
  through Scene.main(devices=N) with N shards of the card (mesh_devices,
  each shard on a stream of its own) and, where the machine has N cards,
  with one shard on each; every export's frames sha256-equal to the
  single device's:
 43. frame sharding: the visualizer, Mandelbrot and Tetration at
     1920x1080@60, 2x SSAA, MESH_SECONDS, single and over MESH_SHARDS
     shards: launch counters (K1 == frames, K3 == frames for Mandelbrot,
     K2 == flushes x shards for the visualizer), frames per shard, fps of
     a null export, device ms and kernels a frame (one flush of
     MESH_PROFILE_FRAMES, kernel time summed over the shards' streams),
     their share of the wall time, the peak of torch.cuda.memory_allocated
     above what was allocated before the export
 44. row sharding: MotionBlur and Life at 1920x1080@60, ssaa 1 (phase
     24's configuration), MESH_SECONDS, the same figures, no kernel of
     K1-K3; every shard's row window and its rings, distinct tensors equal
     across shards
Then a {"mesh": ...} line (43-44).
  The frame pump (io/framepump.{py,cpp}) behind FFmpegSink's turbo
 45. the visualizer at 1920x1080@60, 2x SSAA, SECONDS to an .mp4 path
     through a stub encoder on PATH that drains at most DRAIN_FPS frames a
     second and writes the sha256 of what it read: FramePump.is_native; the
     stub's drain rate alone; a null export's fps; exports with
     turbo=True, buffers=5 and with turbo=False, once each at the default
     batch, in turns at batches of 8 (buffers=16 too): fps of each, every
     one sha256-equal to the same frames' .rgb export, K1 == frames, K2 ==
     flushes
Then a {"framepump": ...} line (45).
  Config 5 with its A/V mux
 46. PianoRoll at 3840x2160@60, ssaa 1, SECONDS to an .mp4 at the default
     batch through the stub encoder (unpaced; it also decodes the audio):
     the encoder's argv (the audio input, -shortest, the video options),
     sha256 equal to the same frames' .rgb export, K1 (d) == frames, fps,
     the default batch (32) and the pipeline depth the budget chose (2)
Then a {"config5": ...} line (46).
  The JAX package's run-time switches (switches.NAMES: none may be set
  when the script starts; each phase sets its own around its calls
  only), on the visualizer at 1920x1080@60, 2x SSAA, SECONDS unless
  stated
 47. (a) SHADERFLOW_PIPELINE_DEPTH: .rgb exports at batch 8 by default and
     at depths 1, 2, 3, sha256-equal, fps of each; (b)
     SHADERFLOW_BATCH_TRACE=1 on phase 45's encoder export (turbo) at the
     default batch and at batch 8: a line a flush, the median capture,
     dispatch and drain ms; (c) SHADERFLOW_NO_TAILFUSE=1: Mandelbrot and
     the visualizer exported on the card under it raise before any launch
     (the port takes the reference tail on CPU tensors only); frames
     REF_FRAMES of the card's default export within 1 u8 step of the
     reference route's on the CPU on < 1 % of values (the visualizer
     < 2 %), null-export fps; (d) SKIP_TPU=1: SKIP_RUNS traced null
     exports of SKIP_SECONDS (capture, dispatch and drain ms a frame from
     inside the loop, fps over the wall) and a .rgb export, every frame
     zero, no kernel counted, a watched flush with no CUDA activity (the
     profile and a TorchDispatchMode, tools/watch.py), beside phases 6 and
     10, the realtime loop's unpaced ceiling; (e)
     SHADERFLOW_REF_SLOT0=1: MotionBlur at 1920x1080@60, ssaa 1, 13 frames
     on the card against device="cpu" (1 u8 step on < 1 %), unlike the
     default export
Then a {"switches": ...} line (47).
  The repo's gating and accounting tools (examples/torch/), each run as
  its own process(es) from this checkout; each prints its table or JSON
  on the lines before its phase line
 48. the PSNR gate (psnr_gate.py): the port's frames on the card against
     the GL oracle (tools/gl_oracle.py) at the JAX gate's eight configs
     and bars, and the visualizer and Mandelbrot at 1920x1080, 2x SSAA;
     the FUSED-vs-REF and bf16-tail-vs-ref rows against the reference
     route on the CPU; every row at its bar, K1, K1 bf16, K2, K3 lines and
     planes launched
 49. the roofline (roofline.py) of the six graded configs, each in its own
     process: steady ms a frame (a three-batch export less a one-batch
     one), the walker's count of one flush, the bound, the unit that
     bounds it and the share (none over 100 %); Mandelbrot's useful and
     executed escape steps a pixel
 50. the cold start (coldstart.py) of the 10 s visualizer export at
     1080p60, 2x SSAA from an empty build directory and Triton cache (an
     nvcc build at least), then with this checkout's (no nvcc build): each
     build, the precomputes, the flushes that built a K1, both exports
Then a {"tools": ...} line (48-50). Phase 17 also times an empty kernel
(csrc/fixture.cu), the floor under T1's and T3's single launches.
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

import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT, FPS, SSAA, SECONDS = 1920, 1080, 60, 2, 2.0
# The realtime phases: frames at the 60 fps target, frames of the unpaced
# run, frames of the display pump's run
REALTIME_FRAMES, CEILING_FRAMES, PUMP_FRAMES = 180, 300, 120
GLSL_DEMO = REPO / "examples" / "torch" / "torch_glsl_demo.py"
# The GLSL masked loop's host-read intervals timed, and the view of its
# second measurement, above the set, where every lane escapes within 30 trips
SYNC_CHOICES = (1, 2, 4, 8, 16, 32)
OUTSIDE_VIEW = ("astuv.x * 0.5 - 1.5, astuv.y * 0.2);",
                "astuv.x * 0.5 - 0.5, astuv.y * 0.2 + 1.12);")
# K3's float32-output kernel of each form (parts of its mangled name)
K3_KERNELS = {"lines": ("escape_kernel", "6LinesCfE"),
              "rotated": ("escape_kernel", "5PairCfE"),
              "julia": ("escape_kernel", "6ApartCfE")}


STARTED = time.perf_counter()


def say(phase: str, **fields) -> None:
    """One phase line; `at_s` is the script's elapsed seconds."""
    fields["at_s"] = f"{time.perf_counter() - STARTED:.1f}"
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
    at most; after a third empty one the call is timed with CUDA events
    around it (median_ms, the host's launch included), and a [profiler]
    line says so."""
    return device_profile(fn, repeats)[0]


def device_profile(fn, repeats: int = 20) -> tuple[float, int]:
    """device_ms's measurement -> (device ms of one call, the kernels and
    copies it launched: the records of each name over `repeats`, rounded;
    None when the profiler recorded nothing and CUDA events timed it)."""
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
    ms = median_ms(fn, repeats)
    say("profiler", recorded="nothing in three profiles", timed_with="cuda events",
        ms=f"{ms:.4f}")
    return ms, None


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
    return engine.frame_context(row, spec, index, engine.frame_indices()[index], {}, {},
                                engine.state)


def mandelbrot_k3_args(scene, index: int):
    """Frame `index`'s K3 (lines form) operands and its Frag: (cx, cy,
    quality, bailout, cap, dtype), ctx."""
    import torch
    import torch_fractals
    ctx = frame_inputs(scene, index)
    quality = max(1, int(1000.0 * ctx.uniform("iQualityS")))
    gluv_x, gluv_y = ctx.camera.line("gluv")
    return ((gluv_x - 0.5).contiguous(), gluv_y.contiguous(), quality, 3.0,
            torch_fractals.mandelbrot_cap(quality), torch.float32), ctx


def plain_mandelbrot_frame(scene, index: int, height: int = HEIGHT, width: int = WIDTH,
                           subsample: int = SSAA):
    """Recompute Mandelbrot frame `index` with the plain PyTorch functions
    only: camera lines, escape_lines_plain, the tail on full tensors, final
    pass (any regime: tail_plain)."""
    import torch
    import torch_fractals
    from shaderflow_tpu_torch.ops import fractal, tailfuse
    k3_args, ctx = mandelbrot_k3_args(scene, index)
    iters = fractal.escape_lines_plain(*k3_args)
    render_h, render_w = scene.engine._render_size
    spec = tailfuse.make_spec(
        torch_fractals.mandelbrot_tail(k3_args[2], True), render_h, render_w,
        iters=iters, oob=tailfuse.Col(ctx.camera.out_of_bounds_x.to(torch.float32)))
    return tailfuse.tail_plain(spec, render_h, render_w, height, width, subsample,
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
    ctx = PreludeCtx(torch.tensor(frames, device=scene.device),
                     engine.bound_sequences(engine.state),
                     engine._render_size, scene.aspect_ratio)
    tables, circle, left = torch_demo.bar_field_inputs(ctx)
    batch, bins, channels = tables.shape
    index_field = sampling.lookup_index(circle, bins, channels, left)
    bar = sampling.expand_plain(tables.reshape(batch, -1).to(torch.bfloat16),
                                index_field, torch.bfloat16)
    bar = bar.reshape(batch, *circle.shape)
    row = torch.from_numpy(packed[index]).to(scene.device)
    frag = engine.frame_context(row, spec, index, frames[index], {"iBarField": bar},
                                engine.invariant_preludes(engine.state), engine.state)
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
    ("RayMarch", "torch_demo", 1920, 1080, 60, 1.0, 1),
    ("Tetration", "torch_fractals", 1920, 1080, 60, 1.0, 2),
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
    frame_ms, frame_launches, host_ms = frame_profile(scene, height, width)
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


def last_frame(scene, height: int, width: int):
    """render() of the last frame of the scene's last batch into a (H, W, 3)
    u8 tensor on the card (engine.render_frame)."""
    import torch
    engine = scene.engine
    packed, spec = engine.stack_captures()
    indices = engine.frame_indices()
    last = len(indices) - 1
    row = torch.from_numpy(packed[last]).to("cuda")
    per_batch, invariant = engine._run_preludes(indices, engine.state)
    out = torch.empty((height, width, 3), dtype=torch.uint8, device="cuda")

    def render():
        engine.render_frame(row, spec, last, indices[last], per_batch, invariant, out,
                            engine.state)
    return render


def frame_profile(scene, height: int, width: int) -> tuple[float, int, float]:
    """One frame of the scene's last batch (engine.render_frame): its device
    ms and kernels and copies (device_profile), and the host ms of its
    enqueue."""
    import torch
    render = last_frame(scene, height, width)
    frame_ms, frame_launches = device_profile(render, 3)
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(3):
        render()
    host_ms = (time.perf_counter() - started) / 3 * 1e3
    torch.cuda.synchronize()
    return frame_ms, frame_launches, host_ms


def cli_export(argv: list):
    """cli.main(argv) in this process, as `python -m shaderflow_tpu_torch`
    runs it -> the scene it ran, for its counters and engine."""
    import functools
    from shaderflow_tpu_torch import cli
    from shaderflow_tpu_torch.scene import ShaderScene
    ran = []
    original = ShaderScene.main

    @functools.wraps(original)   # the CLI reads its flags from this signature
    def recorded(self, **options):
        ran.append(self)
        return original(self, **options)

    ShaderScene.main = recorded
    try:
        cli.main([str(arg) for arg in argv])
    finally:
        ShaderScene.main = original
    if len(ran) != 1:
        raise AssertionError(f"cli.main({argv}) ran {len(ran)} scenes")
    return ran[0]


def glsl_plasma_path(counters, card: str) -> dict:
    """The GLSL Plasma scene (examples/glsl/shaders/plasma.frag) at
    1920x1080@60, 2x SSAA, 2 s through cli.main to a .rgb file: file size,
    the program is the GLSL interpreter, no kernel launched (the fragment's
    result takes the plain final pass), the middle frame against the same
    frame rendered with device="cpu"; the same command as a
    `python -m shaderflow_tpu_torch` process (file size); then a null
    export through cli.main: fps, and one frame's device ms, kernels, host
    ms and the busy share."""
    import numpy as np
    import torch_glsl_demo
    from shaderflow_tpu_torch.shader import missing_fragment
    zero_counters, read_counters = counters
    frames = round(SECONDS * FPS)
    flags = ["-w", WIDTH, "-h", HEIGHT, "-f", FPS, "-s", SSAA, "-t", SECONDS]
    command = [GLSL_DEMO, "Plasma", "main", *flags]
    with tempfile.TemporaryDirectory() as tmp:
        output = Path(tmp) / "plasma.rgb"
        zero_counters()
        started = time.perf_counter()
        scene = cli_export([*command, "--device", "cuda", "-o", output])
        export_s = time.perf_counter() - started
        launches = read_counters()
        if any(launches.values()):
            raise AssertionError(f"Plasma launched kernels {launches}: the GLSL path has none")
        interpreter = getattr(scene.shader.fragment, "glsl_interpreter", None)
        if scene.shader.fragment is missing_fragment or interpreter is None:
            raise AssertionError("Plasma resolved to the missing-texture program")
        check, exported = check_export(output, frames, output.name, HEIGHT, WIDTH)
        reference = Path(tmp) / "cpu.rgb"
        torch_glsl_demo.Plasma().main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA,
                                      time=(check + 1) / FPS, start=check / FPS,
                                      output=str(reference), device="cpu")
        want = np.fromfile(reference, np.uint8).reshape(-1, HEIGHT, WIDTH, 3)[-1]
        frame_err, frame_share = u8_diff(exported, want)
        if frame_err > 1 or frame_share >= 0.01:
            raise AssertionError(f"Plasma frame {check} vs device=cpu: max {frame_err} u8 "
                                 f"steps on {frame_share:.4%}")
        say("plasma_slice", size=f"{WIDTH}x{HEIGHT}", fps=FPS, ssaa=SSAA, frames=frames,
            bytes=output.stat().st_size, seconds=f"{export_s:.3f}", launches=launches,
            frame_checked=check, checked_against="'device=cpu'", max_u8_diff=frame_err,
            differing_share=f"{frame_share:.3e}")
        output.unlink()
        process_output = Path(tmp) / "plasma_process.rgb"
        started = time.perf_counter()
        result = subprocess.run([sys.executable, "-m", "shaderflow_tpu_torch",
                                 *(str(arg) for arg in command), "-o", str(process_output)],
                                cwd=REPO, capture_output=True, text=True, timeout=600)
        if result.returncode != 0:
            raise AssertionError(f"python -m shaderflow_tpu_torch failed:\n{result.stderr[-4000:]}")
        size = process_output.stat().st_size
        if size != frames * HEIGHT * WIDTH * 3:
            raise AssertionError(f"python -m shaderflow_tpu_torch wrote {size} bytes")
        say("plasma_process", command="'python -m shaderflow_tpu_torch ... Plasma main'",
            bytes=size, seconds=f"{time.perf_counter() - started:.3f}")

    started = time.perf_counter()
    scene = cli_export([*command, "--device", "cuda", "-o", "null"])
    null_s = time.perf_counter() - started
    frame_ms, frame_launches, host_ms = frame_profile(scene, HEIGHT, WIDTH)
    result = dict(frames=frames, seconds=null_s, fps=frames / null_s,
                  device_ms_per_frame=frame_ms, launches_per_frame=frame_launches,
                  host_ms_per_frame=host_ms, busy=frames * frame_ms / 1e3 / null_s,
                  launches=launches, max_u8_diff=frame_err)
    say("plasma_timing", config=f"Plasma {WIDTH}x{HEIGHT} {FPS}fps ssaa={SSAA} {SECONDS:g}s "
        "null, cli.main", frames=frames, seconds=f"{null_s:.4f}", fps=f"{result['fps']:.3f}",
        device_ms_per_frame=f"{frame_ms:.4f}", launches_per_frame=frame_launches,
        host_ms_per_frame=f"{host_ms:.4f}", busy=f"{result['busy']:.4f}", card=repr(card))
    return result


def glsl_loop_path(card: str) -> dict:
    """The GLSL front-end's masked loop (torch_glsl_demo.Escape: a per-pixel
    break over 256 trips) at 1920x1080, 2x SSAA: one frame's wall time
    (enqueue and device, synchronized) for each host-read interval k of
    SYNC_CHOICES, with its trips and host reads, on Escape's view (lanes
    inside the set run all 256 trips) and on a view where every lane
    escapes early (the trips a k runs past the last escape are masked);
    then Escape on the card against the CPU at 480x270, 2x SSAA."""
    import numpy as np
    import torch
    import torch_glsl_demo
    from shaderflow_tpu_torch import glsl

    class Outside(torch_glsl_demo.Escape):
        def build(self):
            self.shader.fragment = torch_glsl_demo.ESCAPE_FRAG.replace(*OUTSIDE_VIEW)

    times = {}
    for view, cls in (("escape", torch_glsl_demo.Escape), ("outside", Outside)):
        scene = cls()
        scene.main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=1 / FPS,
                   output="null", device="cuda")
        interpreter = scene.shader.fragment.glsl_interpreter
        render = last_frame(scene, HEIGHT, WIDTH)
        times[view] = {}
        for k in SYNC_CHOICES:
            interpreter.sync_every = k
            walls = []
            for _ in range(3):
                torch.cuda.synchronize()
                started = time.perf_counter()
                render()
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - started) * 1e3)
            stats = dict(interpreter.stats)
            times[view][k] = dict(ms=statistics.median(walls), trips=stats["trips"],
                                  syncs=stats["syncs"])
            if view == "outside" and stats["trips"] >= 256:
                raise AssertionError("the view above the set ran to the trip cap")
            say("glsl_loop", view=view, size=f"{WIDTH * SSAA}x{HEIGHT * SSAA}", k=k,
                frame_ms=f"{times[view][k]['ms']:.4f}", trips=stats["trips"],
                syncs=stats["syncs"], card=repr(card))
        interpreter.sync_every = glsl.Interpreter.SYNC_EVERY
        if view == "escape":
            frame_ms, frame_launches, host_ms = frame_profile(scene, HEIGHT, WIDTH)
            say("glsl_loop_profile", view=view, k=glsl.Interpreter.SYNC_EVERY,
                device_ms_per_frame=f"{frame_ms:.4f}", launches_per_frame=frame_launches,
                host_ms_per_frame=f"{host_ms:.4f}", card=repr(card))
    frames = {}
    with tempfile.TemporaryDirectory() as tmp:
        for device in ("cuda", "cpu"):
            output = Path(tmp) / f"{device}.rgb"
            torch_glsl_demo.Escape().main(width=480, height=270, fps=FPS, ssaa=SSAA,
                                          time=1 / FPS, output=str(output), device=device)
            frames[device] = np.fromfile(output, np.uint8).reshape(270, 480, 3)
    err, share = u8_diff(frames["cuda"], frames["cpu"])
    if frames["cuda"].std() == 0 or err > 1 or share >= 0.01:
        raise AssertionError(f"Escape 480x270 on the card vs the CPU: max {err} u8 steps "
                             f"on {share:.4%}")
    best = {view: min(SYNC_CHOICES, key=lambda k: times[view][k]["ms"]) for view in times}
    say("glsl_loop_check", size="480x270", ssaa=SSAA, max_u8_diff=err,
        differing_share=f"{share:.3e}", k_in_use=glsl.Interpreter.SYNC_EVERY,
        fastest_k=best)
    return dict(times=times, k=glsl.Interpreter.SYNC_EVERY, fastest_k=best,
                device_ms_per_frame=frame_ms, launches_per_frame=frame_launches,
                host_ms_per_frame=host_ms, max_u8_diff=err)


def cli_mandelbrot_path(counters) -> dict:
    """Mandelbrot (torch_fractals.py) at 1920x1080@60, 2x SSAA, 1 s through
    cli.main to a .rgb file: K3 (lines) and K1 (a) once a frame, nothing
    else, and the file's size."""
    zero_counters, read_counters = counters
    frames = FPS
    with tempfile.TemporaryDirectory() as tmp:
        output = Path(tmp) / "mandelbrot.rgb"
        zero_counters()
        started = time.perf_counter()
        cli_export([REPO / "examples" / "torch" / "torch_fractals.py", "Mandelbrot", "main",
                    "-w", WIDTH, "-h", HEIGHT, "-f", FPS, "-s", SSAA, "-t", 1,
                    "--device", "cuda", "-o", output])
        export_s = time.perf_counter() - started
        launches = read_counters()
        expected = {key: 0 for key in launches}
        expected.update(k3=frames - graph_launches(), k1=frames)
        if launches != expected:
            raise AssertionError(f"Mandelbrot through cli.main: launch counters {launches}, "
                                 f"expected {expected}")
        check_export(output, frames, output.name, HEIGHT, WIDTH)
        say("mandelbrot_cli", frames=frames, bytes=output.stat().st_size,
            seconds=f"{export_s:.3f}", launches=launches)
    return dict(frames=frames, seconds=export_s, launches=launches)


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


# --------------------------------------------------------------------------- #
# The realtime preview (phases 29-31)

class StubWindow:
    """A window that records what it is shown (the display pump's phase)."""

    def __init__(self):
        self.shown = 0
        self.last = None
        self.size = (WIDTH, HEIGHT)

    def show(self, frame) -> None:
        self.shown += 1
        self.last = frame.copy()

    def poll(self) -> list:
        return []

    def set_exclusive(self, state) -> None:
        pass

    def set_fullscreen(self, state) -> None:
        pass

    def close(self) -> None:
        pass


def realtime_run(cls, counters, fps: float, frames: int, frameskip: bool = True,
                 backend=None, window=None, keep=0, ssaa: float = SSAA,
                 width: int = WIDTH, height: int = HEIGHT, prepare=None) -> dict:
    """cls().main(...) with no output, headless (or with `window`) until
    `frames` frames: its counters, wall fps, the dt of every tick, the host
    time of each frame's capture (scene.next) and flush enqueue; `keep` > 0
    also keeps copies of the last `keep` flushed frames by frame index,
    taken on the render stream right after each flush; `prepare(scene)`
    runs on the built scene before the loop."""
    import torch
    from shaderflow_tpu_torch.scene import WindowBackend
    zero_counters, read_counters = counters
    scene = cls(backend=backend or WindowBackend.Headless)
    scene.frame_limit = frames
    if window is not None:
        scene.open_window = lambda: window
    scene.initialize()
    if prepare is not None:
        prepare(scene)
    ticks, stamps, tick_s, capture_s, flush_s, copies, pumps = [], [], [], [], [], {}, []
    tick, step, flush = scene._realtime_frame, scene.next, scene.engine.flush

    def timed_tick(dt=0.0):
        started = time.perf_counter()
        stamps.append(started)
        tick(dt=dt)
        ticks.append((dt, scene._rt_batch_active))
        tick_s.append(time.perf_counter() - started)

    def timed_next(dt=0.0):
        started = time.perf_counter()
        step(dt=dt)
        capture_s.append(time.perf_counter() - started)

    def timed_flush(count=None):
        started = time.perf_counter()
        out = flush(count)
        flush_s.append(time.perf_counter() - started)
        if keep:
            copies[scene._frame_counter - 1] = out[-1].clone()
            for index in sorted(copies)[:-keep]:
                del copies[index]
        return out

    display = scene._async_display_frame

    def tracked_display(dispatched):
        display(dispatched)
        pumps[:] = [scene._display_pump]

    scene._realtime_frame, scene.next, scene.engine.flush = timed_tick, timed_next, timed_flush
    scene._async_display_frame = tracked_display
    zero_counters()
    started = time.perf_counter()
    scene.main(width=width, height=height, fps=fps, ssaa=ssaa, frameskip=frameskip,
               device="cuda")
    torch.cuda.synchronize()
    wall = time.perf_counter() - started
    scene._realtime_frame, scene.next, scene.engine.flush = tick, step, flush
    rendered = scene._frame_counter
    period = 1.0 / fps
    # late: a tick whose dt exceeded 1.5 of the periods its frames cover
    # (the first tick's dt is the scheduler's start-up, the last tick only
    # ends the loop)
    late = sum(1 for dt, n in ticks[1:-1] if dt > 1.5 * n * period)
    # frames a second between the first and the last frame's tick (the
    # steady loop), and over the whole main() call (set-up included)
    steady = (rendered - 1) / (stamps[-2] - stamps[0])
    return dict(scene=scene, launches=read_counters(), graph=graph_launches(),
                frames=rendered, wall=wall,
                fps=steady, wall_fps=rendered / wall, late=late, ticks=len(ticks),
                first_ticks_ms=[round(1e3 * t, 2) for t in tick_s[:12]],
                first_captures_ms=[round(1e3 * t, 2) for t in capture_s[:12]],
                first_flushes_ms=[round(1e3 * t, 2) for t in flush_s[:12]],
                capture_ms=1e3 * statistics.mean(capture_s),
                flush_ms=1e3 * statistics.mean(flush_s),
                batch=scene._rt_batch_n, copies=copies, pump=pumps[0] if pumps else None)


def realtime_frames(cls, device: str, count: int, ssaa: float = SSAA,
                    width: int = WIDTH, height: int = HEIGHT):
    """cls() driven as the realtime loop drives it, at a fixed dt = 1/60:
    `count` frames of one flush each -> (scene, the last frame)."""
    from shaderflow_tpu_torch.scene import WindowBackend
    scene = cls(backend=WindowBackend.Headless)
    scene._setup_run(width=width, height=height, fps=FPS, ssaa=ssaa, device=device)
    for _ in range(count):
        scene.engine.begin_batch()
        scene.next(dt=1.0 / FPS)
        frame = scene.engine.flush(1)[0]
    return scene, frame


def realtime_visualizer_spec(scene, plain: bool = True):
    """The tail spec of the visualizer's last flushed realtime frame, its
    bar field through the plain K2 gather (plain=True) -> (spec, lookup
    inputs (flat16 (1, n) bf16 table, index field))."""
    import torch
    import torch_demo
    from shaderflow_tpu_torch.ops import sampling
    engine = scene.engine
    packed, spec = engine.stack_captures()
    indices = engine.frame_indices()
    row = torch.from_numpy(packed[-1]).to(scene.device)
    frag = engine.frame_context(row, spec, len(indices) - 1, indices[-1], {}, {}, engine.state)
    original = sampling.expand_tables
    if plain:
        sampling.expand_tables = lambda flat16, index, out_dtype=torch.float32: (
            sampling.expand_plain(flat16, index, out_dtype))
    try:
        tail = torch_demo.visualizer_frag(frag)
    finally:
        sampling.expand_tables = original
    gx, gy = frag.camera.line("gluv")
    table = frag.tex("iSpectrogram").data[:, 0, :]
    bins, channels = table.shape
    index = sampling.lookup_index(torch_demo._angle_field(gx, gy), bins, channels,
                                  gx[None, :] < 0)
    return tail, (table.reshape(1, -1).to(torch.bfloat16).contiguous(), index)


def realtime_paths(counters, card: str) -> dict:
    """Phases 29-31: the realtime preview of the visualizer and Mandelbrot
    at 1920x1080, 2x SSAA, through Scene.main without an output; the
    figures of the {"realtime": ...} line and the realtime entries of the
    K1 (b)+(c) and K2 rows."""
    import numpy as np
    import torch
    import torch_demo
    import torch_fractals
    from shaderflow_tpu_torch.ops import sampling, tailfuse, tailgen
    from shaderflow_tpu_torch.scene import WindowBackend
    os.environ["SHADERFLOW_AUDIO_BACKEND"] = "none"
    os.environ.pop("SHADERFLOW_RT_BATCH", None)
    device = torch.device("cuda")
    render_h, render_w = HEIGHT * SSAA, WIDTH * SSAA
    result = {}

    # 29. The visualizer, headless: a few frames to build its kernels (a
    # build would read as one long frame: with frameskip, most of a paced
    # run's time), unpaced, then at the 60 fps target
    realtime_run(torch_demo.Visualizer, counters, FPS, 3, frameskip=False)
    ceiling = realtime_run(torch_demo.Visualizer, counters, 1000.0, CEILING_FRAMES,
                           frameskip=False)
    run = realtime_run(torch_demo.Visualizer, counters, FPS, REALTIME_FRAMES)
    frames = run["frames"]
    expected = {key: 0 for key in run["launches"]}
    # K2 at batch 1 runs in the fragment: eagerly, then from its graph
    expected.update(k1=frames, k2=frames - run["graph"])
    if run["launches"] != expected or frames < REALTIME_FRAMES // 4:
        raise AssertionError(f"realtime visualizer: launch counters {run['launches']} for "
                             f"{frames} frames, {run['graph']} graph launches, expected K1 "
                             "== K2 (eager and in the graph) == frames, nothing else")
    scene = run["scene"]
    frame_ms, frame_launches, render_host_ms = frame_profile(scene, HEIGHT, WIDTH)
    packed, _ = scene.engine.stack_captures()
    streams = scene.engine.stack_streams()
    arrays = [packed, *streams.values()]
    started = time.perf_counter()
    for _ in range(50):
        scene.engine.upload(packed, streams, scene.engine.state)
    staging_ms = (time.perf_counter() - started) / 50 * 1e3
    torch.cuda.synchronize()
    started = time.perf_counter()
    for _ in range(50):
        [torch.from_numpy(array).pin_memory().to(device, non_blocking=True)
         for array in arrays]
    pin_ms = (time.perf_counter() - started) / 50 * 1e3
    torch.cuda.synchronize()
    viz = dict(target_fps=FPS, frames=frames, fps=run["fps"], wall_fps=run["wall_fps"],
               late_frames=run["late"],
               ticks=run["ticks"], capture_ms=run["capture_ms"], flush_ms=run["flush_ms"],
               host_ms_per_frame=run["capture_ms"] + run["flush_ms"],
               device_ms_per_frame=frame_ms, launches_per_frame=frame_launches,
               busy=frames * frame_ms / 1e3 / run["wall"], batch=run["batch"],
               staging_upload_ms=staging_ms, fresh_pin_ms=pin_ms,
               ceiling_fps=ceiling["fps"], ceiling_frames=ceiling["frames"],
               ceiling_host_ms_per_frame=ceiling["capture_ms"] + ceiling["flush_ms"],
               launches=run["launches"])
    say("realtime_visualizer", size=f"{WIDTH}x{HEIGHT}", ssaa=SSAA, target_fps=FPS,
        frames=frames, fps=f"{run['fps']:.3f}", wall_fps=f"{run['wall_fps']:.3f}",
        late_frames=run["late"], capture_ms=f"{run['capture_ms']:.4f}", flush_ms=f"{run['flush_ms']:.4f}",
        device_ms_per_frame=f"{frame_ms:.4f}", launches_per_frame=frame_launches,
        render_enqueue_host_ms=f"{render_host_ms:.4f}", busy=f"{viz['busy']:.4f}",
        batch=run["batch"], staging_upload_ms=f"{staging_ms:.4f}",
        fresh_pin_ms=f"{pin_ms:.4f}", ceiling_fps=f"{ceiling['fps']:.3f}",
        ceiling_frames=ceiling["frames"], launches=run["launches"], card=repr(card))
    del run, ceiling, scene

    # One frame at a fixed dt: against its plain recomputation on the card
    # and against the same frames on the CPU
    scene, frame = realtime_frames(torch_demo.Visualizer, "cuda", 3)
    frame = frame.cpu().numpy()
    spec, (flat16, index) = realtime_visualizer_spec(scene)
    tail_args = (spec, render_h, render_w, HEIGHT, WIDTH, SSAA, scene.aspect_ratio)
    plain_err, plain_share = u8_diff(frame, tailfuse.tail_plain(*tail_args).cpu())
    if plain_err > 1 or plain_share >= 0.01:
        raise AssertionError(f"realtime visualizer frame 2 vs plain: max {plain_err} u8 "
                             f"steps on {plain_share:.4%}")
    _, cpu_frame = realtime_frames(torch_demo.Visualizer, "cpu", 3)
    cpu_err, cpu_share = u8_diff(frame, cpu_frame.numpy())
    if cpu_err > 1 or cpu_share >= 0.02:
        raise AssertionError(f"realtime visualizer frame 2 vs device=cpu: max {cpu_err} "
                             f"u8 steps on {cpu_share:.4%}")
    # The realtime tail's K1 and K2 at batch 1, against their plain versions
    k1 = tailfuse.fused_tail_final(*tail_args).cpu()
    k1_err, k1_share = u8_diff(k1, tailfuse.tail_plain(*tail_args).cpu())
    if k1_err > 1 or k1_share >= 0.01:
        raise AssertionError(f"K1 on the realtime tail vs plain: max {k1_err} on "
                             f"{k1_share:.4%}")
    launch = tailgen.prepare(*tail_args, device)
    out = torch.empty((HEIGHT, WIDTH, 3), dtype=torch.uint8, device=device)
    k1_bound_ms, k1_bound_by = walked_bound(lambda: launch(out))
    k1_row = dict(launches=viz["launches"]["k1"], max_abs_err=k1_err,
                  ms=device_ms(lambda: launch(out)), call_ms=median_ms(lambda: launch(out), 20),
                  plain_ms=device_ms(lambda: tailfuse.tail_plain(*tail_args), 5),
                  bound_ms=k1_bound_ms, bound_by=k1_bound_by, **k1_figures(launch))
    got = sampling.expand_tables(flat16, index, torch.bfloat16)
    want = sampling.expand_plain(flat16, index, torch.bfloat16)
    if not (torch.equal(got, want) and torch.equal(flat16.index_select(1, index), want)):
        raise AssertionError("K2 at batch 1 differs from the plain gather")
    k2_bound_ms, k2_bound_by = walked_bound(
        lambda: sampling.expand_tables(flat16, index, torch.bfloat16))
    k2_row = dict(launches=viz["launches"]["k2"], max_abs_err=0.0,
                  ms=device_ms(lambda: sampling.expand_tables(flat16, index, torch.bfloat16)),
                  call_ms=median_ms(lambda: sampling.expand_tables(flat16, index,
                                                                   torch.bfloat16), 20),
                  plain_ms=device_ms(lambda: sampling.expand_plain(flat16, index,
                                                                   torch.bfloat16), 10),
                  library_ms=device_ms(lambda: flat16.index_select(1, index), 10),
                  bound_ms=k2_bound_ms, bound_by=k2_bound_by,
                  table=list(flat16.shape), field=[render_h, render_w])
    viz.update(frame_checked=2, max_u8_diff_vs_plain=plain_err,
               differing_share_vs_plain=plain_share, max_u8_diff_vs_cpu=cpu_err,
               differing_share_vs_cpu=cpu_share)
    say("realtime_visualizer_check", frame=2, dt="1/60", max_u8_diff_vs_plain=plain_err,
        differing_share_vs_plain=f"{plain_share:.3e}", max_u8_diff_vs_cpu=cpu_err,
        differing_share_vs_cpu=f"{cpu_share:.3e}")
    say("k1_realtime", render=f"{render_h}x{render_w}", out=f"{HEIGHT}x{WIDTH}", s=SSAA,
        **{key: (f"{value:.4f}" if isinstance(value, float) else value)
           for key, value in k1_row.items()})
    say("k2_realtime", **{key: (f"{value:.4f}" if isinstance(value, float) else value)
                          for key, value in k2_row.items()})
    result["Visualizer"] = viz
    del scene, frame, spec, got, want, k1

    # 30. Mandelbrot, the same way
    realtime_run(torch_fractals.Mandelbrot, counters, FPS, 3, frameskip=False)
    ceiling = realtime_run(torch_fractals.Mandelbrot, counters, 1000.0, CEILING_FRAMES,
                           frameskip=False)
    run = realtime_run(torch_fractals.Mandelbrot, counters, FPS, REALTIME_FRAMES)
    expected = {key: 0 for key in run["launches"]}
    expected.update(k3=run["frames"] - run["graph"], k1=run["frames"])
    if run["launches"] != expected:
        raise AssertionError(f"realtime Mandelbrot: launch counters {run['launches']} for "
                             f"{run['frames']} frames, {run['graph']} graph launches, "
                             "expected K3 (eager and in the graph) == K1 == frames")
    frame_ms, frame_launches, _ = frame_profile(run["scene"], HEIGHT, WIDTH)
    result["Mandelbrot"] = dict(
        target_fps=FPS, frames=run["frames"], fps=run["fps"], wall_fps=run["wall_fps"],
        late_frames=run["late"], host_ms_per_frame=run["capture_ms"] + run["flush_ms"],
        device_ms_per_frame=frame_ms, launches_per_frame=frame_launches,
        batch=run["batch"], ceiling_fps=ceiling["fps"], ceiling_frames=ceiling["frames"],
        ceiling_host_ms_per_frame=ceiling["capture_ms"] + ceiling["flush_ms"],
        launches=run["launches"])
    say("realtime_mandelbrot", size=f"{WIDTH}x{HEIGHT}", ssaa=SSAA, target_fps=FPS,
        frames=run["frames"], fps=f"{run['fps']:.3f}", late_frames=run["late"],
        host_ms_per_frame=f"{run['capture_ms'] + run['flush_ms']:.4f}",
        device_ms_per_frame=f"{frame_ms:.4f}", launches_per_frame=frame_launches,
        ceiling_fps=f"{ceiling['fps']:.3f}", launches=run["launches"], card=repr(card))
    del run, ceiling

    # 31. The display pump on the visualizer, a recording stub window
    window = StubWindow()
    run = realtime_run(torch_demo.Visualizer, counters, FPS, PUMP_FRAMES,
                       backend=WindowBackend.Preview, window=window, keep=16)
    pump = run["pump"]
    if pump is None or window.last is None:
        raise AssertionError("the windowed realtime loop showed no frame through the pump")
    expected = {key: 0 for key in run["launches"]}
    expected.update(k1=run["frames"], k2=run["frames"] - run["graph"])
    if run["launches"] != expected:
        raise AssertionError(f"pump run: launch counters {run['launches']}, "
                             f"{run['graph']} graph launches, expected K1 == K2 (eager and "
                             f"in the graph) == {run['frames']} frames")
    if pump.shown_tag not in run["copies"]:
        raise AssertionError(f"the last shown frame {pump.shown_tag} is older than the "
                             f"copies kept ({sorted(run['copies'])})")
    torn_err, torn_share = u8_diff(window.last, run["copies"][pump.shown_tag].cpu().numpy())
    if torn_err:
        raise AssertionError(f"the last shown frame ({pump.shown_tag}) differs from the "
                             f"engine's frame: max {torn_err} on {torn_share:.4%} (torn)")
    d2h_ms = 1e3 * statistics.median(pump.transfer_times)
    result["Visualizer (display pump)"] = dict(
        target_fps=FPS, frames=run["frames"], fps=run["fps"], late_frames=run["late"],
        offered=pump.offered, transferred=pump.transferred, shown=window.shown,
        dropped=pump.dropped, d2h_ms_median=d2h_ms, decimate=pump.decimate,
        batch=run["batch"], last_shown_frame=pump.shown_tag, last_shown_equal=True,
        host_ms_per_frame=run["capture_ms"] + run["flush_ms"], launches=run["launches"])
    say("realtime_pump", frames=run["frames"], fps=f"{run['fps']:.3f}",
        offered=pump.offered, transferred=pump.transferred, shown=window.shown,
        dropped=pump.dropped, d2h_ms_median=f"{d2h_ms:.4f}", decimate=pump.decimate,
        batch=run["batch"], last_shown_frame=pump.shown_tag, last_shown_equal=True,
        first_ticks_ms=run["first_ticks_ms"], first_captures_ms=run["first_captures_ms"],
        first_flushes_ms=run["first_flushes_ms"], capture_ms=f"{run['capture_ms']:.4f}",
        flush_ms=f"{run['flush_ms']:.4f}", card=repr(card))
    return dict(paths=result, k1=k1_row, k2=k2_row)


# --------------------------------------------------------------------------- #
# Any supersampling factor, mipmaps, video (phases 32-35)

MIP_ZOOM = 2.0        # stuv zoomed by MIP_ZOOM^2: the view spans 4 texture widths
VIDEO_W, VIDEO_H, VIDEO_FPS, VIDEO_SECONDS, VIDEO_PREMADE = 3840, 2160, 60, 2.0, 8

STUB_FFMPEG = r'''#!{python}
import json, re, sys
from pathlib import Path
here = Path(__file__).parent
meta = json.loads((here / "meta.json").read_text())
frames = (here / "frames.rgb").read_bytes()
size = meta["width"] * meta["height"] * 3
args = sys.argv[1:]
vf = args[args.index("-vf") + 1] if "-vf" in args else ""
skip = int(re.search(r"gte\(n\\?,(\d+)\)", vf).group(1)) if "gte(n" in vf else 0
out = sys.stdout.buffer
view = memoryview(frames)
try:
    for k in range(skip, meta["total"]):
        index = k % meta["count"]
        out.write(view[index * size:(index + 1) * size])
    out.flush()
except BrokenPipeError:
    pass
'''

STUB_FFPROBE = r'''#!{python}
import json, sys
from pathlib import Path
meta = json.loads((Path(__file__).parent / "meta.json").read_text())
entries = sys.argv[sys.argv.index("-show_entries") + 1]
answers = {{"stream=width,height": f"{{meta['width']}},{{meta['height']}}",
           "stream=r_frame_rate": f"{{meta['fps']}}/1",
           "format=duration": str(meta["total"] / meta["fps"])}}
if entries in answers:
    print(answers[entries])
'''


def make_stub_decoder(directory: Path, frames, fps: int, total: int) -> Path:
    """A stub `ffmpeg` and `ffprobe` in `directory` (the card machine has no
    ffmpeg binary): the probes answer the frames' size, `fps` and total /
    fps seconds; a decode replays `total` pre-made rgb24 frames, cycling
    through `frames` (N, H, W, 3) u8, from the select filter's first frame
    on. The port's decode path is its real ffmpeg pipe."""
    import numpy as np
    directory.mkdir(parents=True, exist_ok=True)
    count, height, width, _ = frames.shape
    (directory / "frames.rgb").write_bytes(np.ascontiguousarray(frames, np.uint8).tobytes())
    (directory / "meta.json").write_text(json.dumps(dict(width=width, height=height, fps=fps,
                                                         total=total, count=count)))
    for name, source in (("ffmpeg", STUB_FFMPEG), ("ffprobe", STUB_FFPROBE)):
        path = directory / name
        path.write_text(source.format(python=sys.executable))
        path.chmod(0o755)
    return directory


def mip_background_scene(anisotropy=None):
    """The background image (examples/assets/background.png, 1920x1080)
    with mipmaps=True, through stexture zoomed so the view spans four
    texture widths: about 4 texels a pixel at 1080p (also in
    tests/test_torch_mipmaps.py)."""
    from shaderflow_tpu_torch import ops
    from shaderflow_tpu_torch.scene import ShaderScene
    from shaderflow_tpu_torch.texture import ShaderTexture
    background = REPO / "examples" / "assets" / "background.png"

    def frag(sf):
        anchor = ops.vec2(0.5, 0.5).to(sf.device)
        return sf.stexture("background", ops.zoom(sf.stuv, MIP_ZOOM, anchor))

    class MipBackground(ShaderScene):
        def build(self):
            ShaderTexture(scene=self, name="background", mipmaps=True,
                          anisotropy=anisotropy).from_image(background)
            self.shader.fragment = frag

    return MipBackground


def null_export(scene, options: dict) -> tuple:
    """scene.main(output="null", device="cuda", **options) -> (frames, wall
    seconds, fps)."""
    import torch
    started = time.perf_counter()
    scene.main(output="null", device="cuda", **options)
    torch.cuda.synchronize()
    wall = time.perf_counter() - started
    frames = round(options["time"] * options["fps"])
    return frames, wall, frames / wall


def cpu_frame(cls, index: int, options: dict, setup=None):
    """Frame `index` of cls() exported with device="cpu": the host state
    replayed up to it (start=), only that frame rendered -> (H, W, 3) u8."""
    import numpy as np
    with tempfile.TemporaryDirectory() as tmp:
        output = Path(tmp) / "cpu.rgb"
        scene = cls()
        if setup is not None:
            setup(scene)
        fps = options["fps"]
        scene.main(output=str(output), device="cpu",
                   **{**options, "time": (index + 1) / fps, "start": index / fps})
        width, height = scene.resolution
        frame = np.fromfile(output, np.uint8).reshape(-1, height, width, 3)[-1]
        scene.destroy()
        return frame


def any_ssaa_paths(counters, card: str) -> dict:
    """Phases 32-34: the general final pass (the visualizer at ssaa 1.5, a
    realtime Mandelbrot at ssaa 0.5), K1 at ratio 4 (Mandelbrot at -s 4
    through the command line) and the mipmapped background; the
    {"any_ssaa": ...} figures and the any_ssaa entries of the K1, K2 and
    K3 rows."""
    import numpy as np
    import torch
    import torch_demo
    import torch_fractals
    from shaderflow_tpu_torch.engine import PreludeCtx
    from shaderflow_tpu_torch.ops import fractal, sampling, tailfuse, tailgen
    zero_counters, read_counters = counters
    result = {}

    # 32a. The visualizer at 1080p60, ssaa 1.5 (render 2880x1620): K2 once
    # a batch at render size, the tail through the plain path (no K1)
    options = dict(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=1.5, time=1.0)
    scene = torch_demo.Visualizer()
    zero_counters()
    frames, wall, fps = null_export(scene, options)
    launches = read_counters()
    flushes = -(-frames // scene.default_batch_size())
    expected = {key: 0 for key in launches}
    expected["k2"] = flushes
    if launches != expected:
        raise AssertionError(f"visualizer ssaa 1.5: launch counters {launches}, expected "
                             f"K2 == {flushes} batches and nothing else (K1 == 0)")
    render_h, render_w = scene.engine._render_size
    if (render_w, render_h) != (2880, 1620):
        raise AssertionError(f"visualizer ssaa 1.5 rendered {render_w}x{render_h}")
    frame_ms, frame_launches, host_ms = frame_profile(scene, HEIGHT, WIDTH)
    # the last batch's last frame, rendered again, against the CPU's
    out = torch.empty((HEIGHT, WIDTH, 3), dtype=torch.uint8, device="cuda")
    check = frames - 1
    engine = scene.engine
    packed, spec = engine.stack_captures()
    indices = engine.frame_indices()
    per_batch, invariant = engine._run_preludes(indices, engine.state)
    engine.render_frame(torch.from_numpy(packed[-1]).to("cuda"), spec, len(indices) - 1,
                        indices[-1], per_batch, invariant, out, engine.state)
    want = cpu_frame(torch_demo.Visualizer, check, options)
    err, share = u8_diff(out.cpu().numpy(), want)
    if err > 1 or share >= 0.02:
        raise AssertionError(f"visualizer ssaa 1.5 frame {check} vs device=cpu: max {err} "
                             f"u8 steps on {share:.4%}")
    # K2 at this path's shapes: the last batch's tables over the render-size field
    ctx = PreludeCtx(torch.tensor(indices, device="cuda"), engine.bound_sequences(engine.state),
                     engine._render_size, scene.aspect_ratio)
    tables, circle, left = torch_demo.bar_field_inputs(ctx)
    batch, bins, channels = tables.shape
    index_field = sampling.lookup_index(circle, bins, channels, left)
    flat16 = tables.reshape(batch, -1).to(torch.bfloat16).contiguous()
    got = sampling.expand_tables(flat16, index_field, torch.bfloat16)
    if not torch.equal(got, sampling.expand_plain(flat16, index_field, torch.bfloat16)):
        raise AssertionError("K2 at ssaa 1.5 differs from the plain gather")
    k2_bound_ms, k2_bound_by = walked_bound(
        lambda: sampling.expand_tables(flat16, index_field, torch.bfloat16))
    k2_entry = dict(
        launches=launches["k2"], max_abs_err=0.0,
        ms=device_ms(lambda: sampling.expand_tables(flat16, index_field, torch.bfloat16)),
        plain_ms=device_ms(lambda: sampling.expand_plain(flat16, index_field,
                                                         torch.bfloat16), 5),
        library_ms=device_ms(lambda: flat16.index_select(1, index_field), 5),
        bound_ms=k2_bound_ms, bound_by=k2_bound_by, table=list(flat16.shape),
        field=[render_h, render_w])
    del got, flat16, index_field, tables, circle
    result["Visualizer ssaa 1.5"] = dict(
        frames=frames, seconds=wall, fps=fps, device_ms_per_frame=frame_ms,
        launches_per_frame=frame_launches, host_ms_per_frame=host_ms,
        busy=frames * frame_ms / 1e3 / wall, launches=launches, frame_checked=check,
        max_u8_diff_vs_cpu=err, differing_share_vs_cpu=share)
    say("any_ssaa_visualizer", config="Visualizer 1920x1080 60fps ssaa=1.5 s=2 1s null",
        render=f"{render_w}x{render_h}", frames=frames, seconds=f"{wall:.4f}",
        fps=f"{fps:.3f}", device_ms_per_frame=f"{frame_ms:.4f}",
        launches_per_frame=frame_launches, host_ms_per_frame=f"{host_ms:.4f}",
        launches=launches, frame_checked=check, max_u8_diff_vs_cpu=err,
        differing_share_vs_cpu=f"{share:.3e}",
        k2_ms=f"{k2_entry['ms']:.4f}", k2_bound_ms=f"{k2_bound_ms:.4f}", card=repr(card))
    del scene

    # 32b. Mandelbrot at -s 4 through the command line (render 7680x4320,
    # 33.2 M pixels a frame, subsample 2): K3 once a frame, K1 once a frame
    # pooling 4 x 4 blocks (ratio 4 >= s); the last frame against the plain
    # path (the tail on full tensors and the general final pass)
    zero_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    started = time.perf_counter()
    scene = cli_export([REPO / "examples" / "torch" / "torch_fractals.py", "Mandelbrot",
                        "main", "-w", WIDTH, "-h", HEIGHT, "-f", FPS, "-s", 4, "-t", 1,
                        "--device", "cuda", "-o", "null"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - started
    peak_gb = torch.cuda.max_memory_allocated() / 1e9   # the export's own peak
    frames = FPS
    launches = read_counters()
    expected = {key: 0 for key in launches}
    expected.update(k3=frames - graph_launches(), k1=frames)
    ratio_launches = tailfuse.fused_tail_final.ratio_launches
    if launches != expected or ratio_launches != frames:
        raise AssertionError(f"Mandelbrot -s 4: launch counters {launches}, "
                             f"{ratio_launches} K1 launches at ratio 4, expected K3 (eager "
                             f"and in the graph) == K1 == ratio launches == {frames} frames "
                             "and nothing else")
    render_h, render_w = scene.engine._render_size
    if (render_w, render_h) != (7680, 4320):
        raise AssertionError(f"Mandelbrot -s 4 rendered {render_w}x{render_h}")
    frame_ms, frame_launches, host_ms = frame_profile(scene, HEIGHT, WIDTH)
    index = len(scene.engine.frame_indices()) - 1
    out = torch.empty((HEIGHT, WIDTH, 3), dtype=torch.uint8, device="cuda")
    engine = scene.engine
    packed, spec = engine.stack_captures()
    indices = engine.frame_indices()
    engine.render_frame(torch.from_numpy(packed[index]).to("cuda"), spec, index,
                        indices[index], {}, {}, out, engine.state)
    plain = plain_mandelbrot_frame(scene, index, HEIGHT, WIDTH, int(scene.subsample))
    err, share = u8_diff(out.cpu().numpy(), plain.cpu().numpy())
    if err > 1 or share >= 0.01:
        raise AssertionError(f"Mandelbrot -s 4 frame {index} vs the plain path: max {err} "
                             f"u8 steps on {share:.4%}")
    k3_args, ctx = mandelbrot_k3_args(scene, index)
    counts = fractal.escape_iterations_sep(*k3_args)
    if not torch.equal(counts, fractal.escape_lines_plain(*k3_args)):
        raise AssertionError("K3 at -s 4 differs from the plain loop")
    # K1 at ratio 4 on this frame's tail, against its plain version
    k1_args = (tailfuse.make_spec(
        torch_fractals.mandelbrot_tail(k3_args[2], True), render_h, render_w, iters=counts,
        oob=tailfuse.Col(ctx.camera.out_of_bounds_x.to(torch.float32))), render_h, render_w,
        HEIGHT, WIDTH, int(scene.subsample), scene.aspect_ratio)
    k1_err, k1_share = u8_diff(tailfuse.fused_tail_final(*k1_args).cpu(),
                               tailfuse.tail_plain(*k1_args).cpu())
    if k1_err > 1 or k1_share >= 0.01:
        raise AssertionError(f"K1 at ratio 4 vs plain: max {k1_err} on {k1_share:.4%}")
    launch = tailgen.prepare(*k1_args, torch.device("cuda"))
    k1_bound_ms, k1_bound_by = walked_bound(lambda: launch(out))
    k1_entry = dict(
        launches=launches["k1"], ratio_launches=ratio_launches, max_abs_err=k1_err,
        ms=device_ms(lambda: launch(out)), call_ms=median_ms(lambda: launch(out), 20),
        plain_ms=device_ms(lambda: tailfuse.tail_plain(*k1_args), 3),
        bound_ms=k1_bound_ms, bound_by=k1_bound_by, **k1_figures(launch))
    grid_x, grid_y = torch.broadcast_tensors(k3_args[0][None, :], k3_args[1][:, None])
    steps = escape_steps(counts, fractal._interior_mask(grid_x, grid_y))
    k3_bound_ms, k3_bound_by = walked_bound(lambda: fractal.escape_iterations_sep(*k3_args),
                                            steps / counts.numel())
    k3_entry = dict(
        launches=launches["k3"], max_abs_err=0.0,
        ms=device_ms(lambda: fractal.escape_iterations_sep(*k3_args), 10),
        plain_ms=device_ms(lambda: fractal.escape_lines_plain(*k3_args), 3),
        bound_ms=k3_bound_ms, bound_by=k3_bound_by, pixels=int(counts.numel()),
        steps=int(steps))
    del counts, grid_x, grid_y, plain
    result["Mandelbrot -s 4 (cli.main)"] = dict(
        frames=frames, seconds=wall, fps=frames / wall, device_ms_per_frame=frame_ms,
        launches_per_frame=frame_launches, host_ms_per_frame=host_ms,
        busy=frames * frame_ms / 1e3 / wall, launches=launches, frame_checked=index,
        max_u8_diff_vs_plain=err, differing_share_vs_plain=share,
        peak_memory_gb=peak_gb)
    say("any_ssaa_mandelbrot", config="Mandelbrot 1920x1080 60fps -s 4 1s null (cli.main)",
        render=f"{render_w}x{render_h}", frames=frames, seconds=f"{wall:.4f}",
        fps=f"{frames / wall:.3f}", device_ms_per_frame=f"{frame_ms:.4f}",
        launches_per_frame=frame_launches, host_ms_per_frame=f"{host_ms:.4f}",
        launches=launches, frame_checked=index, max_u8_diff_vs_plain=err,
        differing_share_vs_plain=f"{share:.3e}", k3_ms=f"{k3_entry['ms']:.4f}",
        k3_bound_ms=f"{k3_bound_ms:.4f}", k3_steps=int(steps),
        k1_ms=f"{k1_entry['ms']:.4f}", k1_call_ms=f"{k1_entry['call_ms']:.4f}",
        k1_bound_ms=f"{k1_bound_ms:.4f}", k1_bound_by=k1_bound_by,
        k1_plain_ms=f"{k1_entry['plain_ms']:.4f}", k1_regs=k1_entry["n_regs"],
        k1_spills=k1_entry["n_spills"], k1_tile=k1_entry["tile"],
        peak_memory_gb=f"{peak_gb:.3f}",
        card=repr(card))
    del scene, out
    torch.cuda.empty_cache()

    # 33. Realtime Mandelbrot at 1080p, ssaa 0.5 (render 960x540, upsampled
    # by the general resampler): warm-up, then 180 frames at 60 fps
    realtime_run(torch_fractals.Mandelbrot, counters, FPS, 3, frameskip=False, ssaa=0.5)
    run = realtime_run(torch_fractals.Mandelbrot, counters, FPS, REALTIME_FRAMES, ssaa=0.5)
    expected = {key: 0 for key in run["launches"]}
    expected["k3"] = run["frames"] - run["graph"]
    if run["launches"] != expected:
        raise AssertionError(f"realtime Mandelbrot ssaa 0.5: launch counters "
                             f"{run['launches']}, {run['graph']} graph launches, expected K3 "
                             f"(eager and in the graph) == {run['frames']} frames, K1 == 0")
    if run["scene"].engine._render_size != (540, 960):
        raise AssertionError(f"realtime ssaa 0.5 rendered {run['scene'].engine._render_size}")
    frame_ms, frame_launches, _ = frame_profile(run["scene"], HEIGHT, WIDTH)
    _, card_frame = realtime_frames(torch_fractals.Mandelbrot, "cuda", 3, ssaa=0.5)
    _, cpu = realtime_frames(torch_fractals.Mandelbrot, "cpu", 3, ssaa=0.5)
    err, share = u8_diff(card_frame.cpu().numpy(), cpu.numpy())
    if err > 1 or share >= 0.01:
        raise AssertionError(f"realtime Mandelbrot ssaa 0.5 frame 2 vs device=cpu: max "
                             f"{err} u8 steps on {share:.4%}")
    result["Realtime Mandelbrot ssaa 0.5"] = dict(
        target_fps=FPS, frames=run["frames"], fps=run["fps"], wall_fps=run["wall_fps"],
        late_frames=run["late"], host_ms_per_frame=run["capture_ms"] + run["flush_ms"],
        device_ms_per_frame=frame_ms, launches_per_frame=frame_launches,
        batch=run["batch"], launches=run["launches"], frame_checked=2,
        max_u8_diff_vs_cpu=err, differing_share_vs_cpu=share)
    say("any_ssaa_realtime", size=f"{WIDTH}x{HEIGHT}", ssaa=0.5, render="960x540",
        target_fps=FPS, frames=run["frames"], fps=f"{run['fps']:.3f}",
        late_frames=run["late"],
        host_ms_per_frame=f"{run['capture_ms'] + run['flush_ms']:.4f}",
        device_ms_per_frame=f"{frame_ms:.4f}", launches_per_frame=frame_launches,
        launches=run["launches"], max_u8_diff_vs_cpu=err,
        differing_share_vs_cpu=f"{share:.3e}", card=repr(card))
    del run, card_frame, cpu

    # 34. The mipmapped background at 1080p, isotropic and anisotropy=4
    for anisotropy in (None, 4):
        cls = mip_background_scene(anisotropy)
        builds = []
        original = sampling.mip_pyramid

        def counted(*args, **kwargs):
            builds.append(kwargs.get("anisotropy"))
            return original(*args, **kwargs)

        options = dict(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=1, time=1.0)
        scene = cls()
        zero_counters()
        sampling.mip_pyramid = counted
        try:
            frames, wall, fps = null_export(scene, options)
        finally:
            sampling.mip_pyramid = original
        launches = read_counters()
        if any(launches.values()) or builds != [anisotropy or 1]:
            raise AssertionError(f"mipmapped background: counters {launches}, pyramid "
                                 f"builds {builds} (expected none, one build)")
        frame_ms, frame_launches, host_ms = frame_profile(scene, HEIGHT, WIDTH)
        out = torch.empty((HEIGHT, WIDTH, 3), dtype=torch.uint8, device="cuda")
        engine = scene.engine
        packed, spec = engine.stack_captures()
        indices = engine.frame_indices()
        engine.render_frame(torch.from_numpy(packed[0]).to("cuda"), spec, 0, indices[0],
                            {}, {}, out, engine.state)
        want = cpu_frame(cls, indices[0], options)
        err, share = u8_diff(out.cpu().numpy(), want)
        if err > 1 or share >= 0.01:
            raise AssertionError(f"mipmapped background (anisotropy {anisotropy}) vs "
                                 f"device=cpu: max {err} u8 steps on {share:.4%}")
        name = f"Mipmapped background, anisotropy {anisotropy or 'off'}"
        result[name] = dict(
            frames=frames, seconds=wall, fps=fps, device_ms_per_frame=frame_ms,
            launches_per_frame=frame_launches, host_ms_per_frame=host_ms,
            busy=frames * frame_ms / 1e3 / wall, pyramid_builds=len(builds),
            levels=len(original(sampling.Sampler2D(torch.zeros(1080, 1920, 3))).levels),
            max_u8_diff_vs_cpu=err, differing_share_vs_cpu=share)
        say("mipmaps", config=f"MipBackground 1920x1080 60fps ssaa=1 1s null, zoom "
            f"{MIP_ZOOM ** 2:g}x, anisotropy={anisotropy}", frames=frames,
            seconds=f"{wall:.4f}", fps=f"{fps:.3f}", device_ms_per_frame=f"{frame_ms:.4f}",
            launches_per_frame=frame_launches, host_ms_per_frame=f"{host_ms:.4f}",
            pyramid_builds=len(builds), max_u8_diff_vs_cpu=err,
            differing_share_vs_cpu=f"{share:.3e}", card=repr(card))
        del scene, out
    return dict(paths=result, k1=k1_entry, k2=k2_entry, k3=k3_entry)


def video_path(counters, card: str) -> dict:
    """Phase 35: the Video scene at 3840x2160, 60 fps, ssaa 1, from a
    3840x2160 60 fps source decoded through the port's ffmpeg pipe (a stub
    ffmpeg and ffprobe on PATH replay pre-made rgb24 frames): 24.9 MB of
    u8 a frame up through the staging buffer, for VIDEO_SECONDS; the stub
    pipe's own rate; frame 1 against device="cpu" (bit-equal targeted)."""
    import numpy as np
    import torch
    import torch_demo
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    zero_counters, read_counters = counters
    total = round(VIDEO_SECONDS * VIDEO_FPS)
    y, x = np.mgrid[0:VIDEO_H, 0:VIDEO_W].astype(np.float32)
    premade = np.stack([np.stack([128 + 127 * np.sin(x / (37 + k) + k),
                                  128 + 127 * np.sin(y / (23 + k) - k),
                                  128 + 127 * np.sin((x + y) / 71 + 2 * k)], axis=-1)
                        for k in range(VIDEO_PREMADE)]).astype(np.uint8)
    del x, y
    saved_path = os.environ["PATH"]
    with tempfile.TemporaryDirectory() as tmp:
        stub = make_stub_decoder(Path(tmp) / "bin", premade, VIDEO_FPS, total)
        source = Path(tmp) / "source.mp4"
        source.write_bytes(b"stub source: the decoder replays pre-made frames")
        os.environ["PATH"] = f"{stub}{os.pathsep}{saved_path}"
        caches = ("binary", "ffprobe", "get_video_resolution", "get_video_framerate",
                  "get_video_duration", "get_video_total_frames")
        for name in caches:
            getattr(FFmpeg, name).cache_clear()
        try:
            if FFmpeg.binary() != str(stub / "ffmpeg"):
                raise AssertionError(f"the stub ffmpeg is not the one found: {FFmpeg.binary()}")
            # The stub pipe alone: frames a second as the port's reader sees them
            started = time.perf_counter()
            decoded = sum(1 for _ in FFmpeg.iter_video_frames(source))
            pipe_fps = decoded / (time.perf_counter() - started)
            if decoded != total:
                raise AssertionError(f"the stub pipe gave {decoded} frames, not {total}")
            options = dict(width=VIDEO_W, height=VIDEO_H, fps=VIDEO_FPS, ssaa=1,
                           time=VIDEO_SECONDS)

            def set_source(scene):
                scene.path = source

            scene = torch_demo.Video()
            set_source(scene)
            zero_counters()
            frames, wall, fps = null_export(scene, options)
            launches = read_counters()
            if any(launches.values()) or scene.video._frames < total - 2:
                raise AssertionError(f"Video: counters {launches}, {scene.video._frames} "
                                     f"video frames written of {total}")
            if scene.engine._streamed_names != {"iVideo"} or scene.engine._stream_f32:
                raise AssertionError("Video: the texture did not stream as u8")
            frame_ms, frame_launches, host_ms = frame_profile(scene, VIDEO_H, VIDEO_W)
            packed, _ = scene.engine.stack_captures()
            streams = scene.engine.stack_streams()
            upload_bytes = sum(array.nbytes for array in streams.values()) / len(packed)
            started = time.perf_counter()
            for _ in range(5):
                scene.engine.upload(packed, streams, scene.engine.state)
            torch.cuda.synchronize()
            upload_ms = (time.perf_counter() - started) / 5 * 1e3 / len(packed)
            scene.destroy()
            # Frame 1 of a 2-frame export on the card and on the CPU
            with tempfile.TemporaryDirectory() as out_dir:
                frames_out = {}
                for device in ("cuda", "cpu"):
                    output = Path(out_dir) / f"{device}.rgb"
                    check = torch_demo.Video()
                    set_source(check)
                    check.main(output=str(output), device=device,
                               **{**options, "time": 2 / VIDEO_FPS})
                    check.destroy()
                    frames_out[device] = np.fromfile(output, np.uint8).reshape(
                        -1, VIDEO_H, VIDEO_W, 3)[1]
            err, share = u8_diff(frames_out["cuda"], frames_out["cpu"])
            if err > 1 or share >= 0.01 or frames_out["cuda"].std() < 10:
                raise AssertionError(f"Video frame 1 vs device=cpu: max {err} u8 steps on "
                                     f"{share:.4%} (std {frames_out['cuda'].std():.2f})")
        finally:
            os.environ["PATH"] = saved_path
            for name in caches:
                getattr(FFmpeg, name).cache_clear()
    figures = dict(frames=frames, seconds=wall, fps=fps, stub_pipe_fps=pipe_fps,
                   device_ms_per_frame=frame_ms, launches_per_frame=frame_launches,
                   host_ms_per_frame=host_ms, busy=frames * frame_ms / 1e3 / wall,
                   upload_mb_per_frame=upload_bytes / 1e6,
                   staged_upload_ms_per_frame=upload_ms, launches=launches,
                   frame_checked=1, max_u8_diff_vs_cpu=err, differing_share_vs_cpu=share)
    say("video", config=f"Video {VIDEO_W}x{VIDEO_H} {VIDEO_FPS}fps ssaa=1 "
        f"{VIDEO_SECONDS:g}s null, stub ffmpeg source {VIDEO_W}x{VIDEO_H}@{VIDEO_FPS}",
        frames=frames, seconds=f"{wall:.4f}", fps=f"{fps:.3f}",
        stub_pipe_fps=f"{pipe_fps:.3f}", device_ms_per_frame=f"{frame_ms:.4f}",
        launches_per_frame=frame_launches, host_ms_per_frame=f"{host_ms:.4f}",
        upload_mb_per_frame=f"{upload_bytes / 1e6:.3f}",
        staged_upload_ms_per_frame=f"{upload_ms:.4f}", launches=launches,
        max_u8_diff_vs_cpu=err, differing_share_vs_cpu=f"{share:.3e}", card=repr(card))
    return figures


# --------------------------------------------------------------------------- #
# The audio and export surface (phases 36-37)

AUDIO_AMPLITUDE, AUDIO_TONE, AUDIO_CHECK_FRAMES = 0.25, 440.0, 30

STUB_AUDIO_FFMPEG = r"""#!{python}
import json, sys
from pathlib import Path
here = Path(__file__).parent
args = sys.argv[1:]
with open(here / "calls.jsonl", "a") as log:
    log.write(json.dumps(args) + "\n")
if "f32le" in args:
    pcm = memoryview((here / "pcm.f32").read_bytes())
    out = sys.stdout.buffer
    try:
        for start in range(0, len(pcm), 1 << 20):
            out.write(pcm[start:start + (1 << 20)])
        out.flush()
    except BrokenPipeError:
        pass
    sys.exit(0)
# An encode: with STUB_FRAME_BYTES and STUB_DRAIN_FPS, stdin is read a
# frame at a time and drained at that rate at most, and a file output gets
# the sha256 of what came, its size and the seconds from its first byte
import hashlib, os, time
frame = int(os.environ.get("STUB_FRAME_BYTES", "0"))
rate = float(os.environ.get("STUB_DRAIN_FPS", "0"))
hasher, count, started = hashlib.sha256(), 0, None
while chunk := sys.stdin.buffer.read(frame or (1 << 22)):
    started = started or time.monotonic()
    count += len(chunk)
    hasher.update(chunk)
    if frame and rate:
        time.sleep(max(0.0, started + count / frame / rate - time.monotonic()))
seconds = time.monotonic() - started if started else 0.0
if args[-1] == "-":
    sys.stdout.buffer.write(b"STUB" + count.to_bytes(8, "little"))
elif frame:
    Path(args[-1]).write_text(json.dumps(dict(sha256=hasher.hexdigest(), bytes=count,
                                              seconds=seconds)))
"""

STUB_AUDIO_FFPROBE = r"""#!{python}
import json, sys
from pathlib import Path
meta = json.loads((Path(__file__).parent / "meta.json").read_text())
entries = sys.argv[sys.argv.index("-show_entries") + 1]
answers = {{"stream=sample_rate": str(meta["rate"]), "stream=channels": str(meta["channels"]),
           "format=duration": str(meta["frames"] / meta["rate"])}}
if entries in answers:
    print(answers[entries])
"""


def make_stub_audio(directory: Path, samples, rate: int) -> Path:
    """A stub `ffmpeg` and `ffprobe` in `directory` (no ffmpeg binary is
    needed): a decode to f32le replays `samples` (frames, channels)
    float32; the probes answer their rate, channels and duration; an encode
    drains its stdin and, for output "-", writes b"STUB" + the byte count;
    with STUB_FRAME_BYTES and STUB_DRAIN_FPS in the environment it drains
    a frame at a time at that rate at most and writes, to a file output,
    {"sha256", "bytes", "seconds"} of what it read (FRAMEPUMP_PATH).
    Every call's arguments go to calls.jsonl. The port's decode and encode
    paths are its real ffmpeg pipes."""
    import numpy as np
    directory.mkdir(parents=True, exist_ok=True)
    (directory / "pcm.f32").write_bytes(np.ascontiguousarray(samples, "<f4").tobytes())
    (directory / "meta.json").write_text(json.dumps(
        dict(rate=rate, channels=int(samples.shape[1]), frames=int(samples.shape[0]))))
    for name, source in (("ffmpeg", STUB_AUDIO_FFMPEG), ("ffprobe", STUB_AUDIO_FFPROBE)):
        path = directory / name
        path.write_text(source.format(python=sys.executable))
        path.chmod(0o755)
    return directory


def digest(data) -> str:
    """sha256 of bytes, or of a file's bytes read in 64 MB pieces."""
    import hashlib
    hasher = hashlib.sha256()
    if isinstance(data, (bytes, bytearray)):
        hasher.update(data)
        return hasher.hexdigest()
    with open(data, "rb") as handle:
        while piece := handle.read(1 << 26):
            hasher.update(piece)
    return hasher.hexdigest()


class TCPListener:
    """A TCP server on 127.0.0.1 in a thread: reads one connection to its
    EOF, hashing and counting the bytes."""

    def __init__(self):
        import hashlib
        import socket
        import threading
        self.server = socket.create_server(("127.0.0.1", 0))
        self.url = f"tcp://127.0.0.1:{self.server.getsockname()[1]}"
        self.hasher, self.count = hashlib.sha256(), 0
        self.thread = threading.Thread(target=self._serve, daemon=True)
        self.thread.start()

    def _serve(self):
        connection, _ = self.server.accept()
        with connection:
            while chunk := connection.recv(1 << 20):
                self.hasher.update(chunk)
                self.count += len(chunk)

    def result(self) -> tuple[str, int]:
        self.thread.join(timeout=120)
        self.server.close()
        if self.thread.is_alive():
            raise AssertionError("the TCP listener did not see its connection end")
        return self.hasher.hexdigest(), self.count


def audio_export_path(counters, card: str) -> dict:
    """Phase 36: the visualizer at 1920x1080, 60 fps, 2x SSAA, SECONDS, its
    audio decoded from music.flac through the port's ffmpeg pipe (a stub
    ffmpeg and ffprobe on PATH replay the f32le samples of music.wav): its
    .rgb frames bit-equal to the export of music.wav read by the stdlib,
    K2 once a batch and K1 (b)+(c) once a frame, the progress relay over
    every frame, the decode's time in the export's set-up; a null export's
    fps, device and host ms a frame; then output "pipe" and
    "tcp://127.0.0.1:<port>" without ffmpeg (PipeSink, TCPSink into a
    listener here: the .rgb bytes), and "pipe" with the stub encoder (its
    stdout, counting F x H x W x 3 bytes fed)."""
    import wave
    import numpy as np
    import torch_demo
    from shaderflow_tpu_torch import exporting
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    zero_counters, read_counters = counters
    frames = round(SECONDS * FPS)
    frame_bytes = WIDTH * HEIGHT * 3
    options = dict(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS)
    with wave.open(str(torch_demo.MUSIC), "rb") as handle:
        rate, channels = handle.getframerate(), handle.getnchannels()
        pcm = np.frombuffer(handle.readframes(handle.getnframes()), "<i2")
    pcm = (pcm.astype(np.float32) / 32768.0).reshape(-1, channels)
    saved_path = os.environ["PATH"]
    caches = ("binary", "ffprobe", "get_audio_samplerate", "get_audio_channels")
    helpers, relays, decodes = [], [], []
    open_bar, get_audio_numpy = exporting.ExportingHelper.open_bar, FFmpeg.get_audio_numpy
    decode_method = FFmpeg.__dict__["get_audio_numpy"]

    def recorded_open_bar(helper):
        helper.relay = lambda frame, total: relays.append((frame, total))
        helpers.append(helper)
        open_bar(helper)

    def timed_decode(path):
        started = time.perf_counter()
        samples = get_audio_numpy(path)
        decodes.append(time.perf_counter() - started)
        return samples

    def decoder(on: bool, stub: Path) -> None:
        os.environ["PATH"] = f"{stub}{os.pathsep}{saved_path}" if on else saved_path
        for name in caches:
            getattr(FFmpeg, name).cache_clear()
        if (FFmpeg.binary() == str(stub / "ffmpeg")) != on:
            raise AssertionError(f"ffmpeg on PATH is {FFmpeg.binary()}, stub wanted: {on}")

    def visualizer(audio_file=None):
        scene = torch_demo.Visualizer()
        scene.audio_file = audio_file
        return scene

    exporting.ExportingHelper.open_bar = recorded_open_bar
    FFmpeg.get_audio_numpy = staticmethod(timed_decode)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            stub = make_stub_audio(tmp / "bin", pcm, rate)
            flac = tmp / "music.flac"
            flac.write_bytes(b"fLaC stub: the decoder replays music.wav's samples")
            # The WAV export, no decoder on PATH: the stdlib reads the file
            decoder(False, stub)
            visualizer().main(output=str(tmp / "wav.rgb"), device="cuda", **options)
            wav_digest = digest(tmp / "wav.rgb")
            wav_decode_s = decodes[-1]
            (tmp / "wav.rgb").unlink()
            # The same export from music.flac through the decode pipe
            decoder(True, stub)
            relays.clear()
            zero_counters()
            started = time.perf_counter()
            visualizer(flac).main(output=str(tmp / "flac.rgb"), device="cuda", **options)
            export_s = time.perf_counter() - started
            launches = read_counters()
            flac_decode_s = decodes[-1]
            batches = -(-frames // helpers[-1].scene.default_batch_size())
            expected = {key: 0 for key in launches}
            expected.update(k2=batches, k1=frames)
            if launches != expected:
                raise AssertionError(f"visualizer from flac: counters {launches}, expected "
                                     f"K2 == {batches} batches, K1 == {frames} frames")
            flac_digest, size = digest(tmp / "flac.rgb"), (tmp / "flac.rgb").stat().st_size
            if flac_digest != wav_digest or size != frames * frame_bytes:
                raise AssertionError(f"the flac export's {size} bytes differ from the wav "
                                     "export's frames")
            (tmp / "flac.rgb").unlink()
            decoded = [call for call in map(json.loads, (stub / "calls.jsonl").read_text()
                                            .splitlines()) if str(flac) in call]
            if not decoded or "f32le" not in decoded[0]:
                raise AssertionError("music.flac did not go through the ffmpeg decode pipe")
            helper = helpers[-1]
            steps = [frame for frame, total in relays]
            if (helper.frame != frames or {total for _, total in relays} != {frames}
                    or steps != sorted(steps) or steps[0] != 0 or len(steps) != batches):
                raise AssertionError(f"progress: relay {relays}, helper at {helper.frame} "
                                     f"of {frames} frames")
            bar = ("none: no tqdm" if helper.bar is None
                   else "tqdm, off: the relay reports" if helper.bar.disable
                   else f"tqdm at {helper.bar.n}")
            relay_calls = len(relays)
            # Throughput: a null export from flac, and one frame's profile
            scene = visualizer(flac)
            null_frames, wall, fps = null_export(scene, options)
            frame_ms, frame_launches, host_ms = frame_profile(scene, HEIGHT, WIDTH)
            scene.destroy()
            # Pipe and TCP outputs without an encoder: raw rgb24
            decoder(False, stub)
            piped = visualizer().main(output="pipe", device="cuda", **options)
            pipe_ok = isinstance(piped, bytes) and digest(piped) == wav_digest
            del piped
            listener = TCPListener()
            returned = visualizer().main(output=listener.url, device="cuda", **options)
            tcp_digest, tcp_bytes = listener.result()
            if not pipe_ok or tcp_digest != wav_digest or returned != listener.url:
                raise AssertionError(f"pipe equal {pipe_ok}, tcp {tcp_bytes} bytes equal "
                                     f"{tcp_digest == wav_digest}, returned {returned!r}")
            # Pipe with an encoder: the encoder's stdout
            decoder(True, stub)
            encoded = visualizer(flac).main(output="pipe", device="cuda", **options)
            if encoded != b"STUB" + (frames * frame_bytes).to_bytes(8, "little"):
                raise AssertionError(f"the stub encoder's stdout: {encoded[:12]!r}")
            command = [call for call in map(json.loads, (stub / "calls.jsonl").read_text()
                                            .splitlines()) if "rawvideo" in call][-1]
            if command[-3:] != ["-f", "matroska", "-"] or str(flac) not in command:
                raise AssertionError(f"encoder command {command}")
    finally:
        exporting.ExportingHelper.open_bar = open_bar
        FFmpeg.get_audio_numpy = decode_method
        os.environ["PATH"] = saved_path
        for name in caches:
            getattr(FFmpeg, name).cache_clear()
    figures = dict(frames=frames, export_s=export_s, flac_decode_s=flac_decode_s,
                   wav_decode_s=wav_decode_s, seconds=wall, fps=fps,
                   device_ms_per_frame=frame_ms, launches_per_frame=frame_launches,
                   host_ms_per_frame=host_ms, busy=null_frames * frame_ms / 1e3 / wall,
                   launches=launches, relay_calls=relay_calls, bar=bar,
                   rgb_equal_to_wav=True, pipe_equal=True, tcp_bytes=tcp_bytes,
                   encoder_bytes=frames * frame_bytes)
    say("audio_export", config=f"Visualizer {WIDTH}x{HEIGHT} {FPS}fps {SSAA}xSSAA "
        f"{SECONDS:g}s from music.flac (stub decoder)", frames=frames,
        export_s=f"{export_s:.4f}", flac_decode_s=f"{flac_decode_s:.4f}",
        wav_decode_s=f"{wav_decode_s:.4f}", fps=f"{fps:.3f}",
        device_ms_per_frame=f"{frame_ms:.4f}", launches_per_frame=frame_launches,
        host_ms_per_frame=f"{host_ms:.4f}", busy=f"{figures['busy']:.4f}",
        launches=launches, relay_calls=relay_calls, bar=repr(bar), flac_equals_wav=True,
        pipe_equals_rgb=True, tcp_equals_rgb=True, tcp_bytes=tcp_bytes,
        encoder_bytes=frames * frame_bytes, card=repr(card))
    return figures


def stub_audio_backend(amplitude: float = AUDIO_AMPLITUDE):
    """A realtime audio backend module with one recorder: each record(n)
    returns the next n frames (one 60 fps frame's worth, 735, for None) of
    a stereo sine of `amplitude` at AUDIO_TONE Hz."""
    import types
    import numpy as np

    class Recorder:
        _samplerate = 44100.0

        def __init__(self):
            self.position = 0

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        def record(self, numframes=None):
            count = numframes or 735
            t = (self.position + np.arange(count)) / 44100.0
            self.position += count
            tone = (amplitude * np.sin(2 * np.pi * AUDIO_TONE * t)).astype(np.float32)
            return np.stack([tone, tone], axis=1)

    class Device:
        name, channels, isloopback = "stub sine", 2, False

        def recorder(self, samplerate=44100, channels=None, blocksize=512):
            return Recorder()

    module = types.ModuleType("stub_audio_backend")
    module.all_microphones = lambda include_loopback=False: [Device()]
    module.all_speakers = lambda: []
    module.default_microphone = module.default_speaker = Device
    return module


def audio_scene_path(counters, card: str) -> dict:
    """Phase 37: the Audio scene (the recorder's volume as brightness) in
    the realtime loop, headless, at 1920x1080, 60 fps, ssaa 1, for
    REALTIME_FRAMES frames after a warm-up, its recorder a stub backend
    feeding a sine of AUDIO_AMPLITUDE: counters, fps, late ticks, host ms
    a frame, one frame's device ms and kernels; frame AUDIO_CHECK_FRAMES
    at dt = 1/60 equal to the same frames run with device="cpu"; where
    pygame imports, a run on SDL's dummy driver too."""
    import importlib.util
    import torch_demo
    from shaderflow_tpu_torch.audio import BrokenAudio
    backend = BrokenAudio.__dict__["_backend"]
    BrokenAudio._backend = staticmethod(lambda: stub_audio_backend())
    try:
        realtime_run(torch_demo.Audio, counters, FPS, 3, frameskip=False, ssaa=1)
        run = realtime_run(torch_demo.Audio, counters, FPS, REALTIME_FRAMES, ssaa=1)
        frames, scene = run["frames"], run["scene"]
        if type(scene.audio.recorder).__name__ != "Recorder" or frames < REALTIME_FRAMES // 4:
            raise AssertionError(f"Audio: recorder {scene.audio.recorder}, {frames} frames")
        if any(run["launches"].values()):
            raise AssertionError(f"Audio: counters {run['launches']}: its frame is a "
                                 "plain fragment, no kernel of K1-K3 expected")
        frame_ms, frame_launches, render_host_ms = frame_profile(scene, HEIGHT, WIDTH)
        scene.destroy()
        checked = {}
        for device in ("cuda", "cpu"):
            check, frame = realtime_frames(torch_demo.Audio, device, AUDIO_CHECK_FRAMES, ssaa=1)
            checked[device] = (frame.cpu().numpy(), float(check.audio.volume.value))
            check.destroy()
        (card_frame, card_volume), (cpu_frame, cpu_volume) = checked["cuda"], checked["cpu"]
        err, share = u8_diff(card_frame, cpu_frame)
        level = int(card_frame[0, 0, 0])
        if err or card_volume != cpu_volume or level == 0 or (card_frame != level).any():
            raise AssertionError(f"Audio frame {AUDIO_CHECK_FRAMES - 1}: card vs cpu max {err} "
                                 f"u8 steps, volume {card_volume} vs {cpu_volume}, level {level}")
    finally:
        BrokenAudio._backend = backend
    sdl = "pygame absent"
    if importlib.util.find_spec("pygame") is not None:
        os.environ.update(SHADERFLOW_AUDIO_BACKEND="sdl", SHADERFLOW_SDL_AUDIODRIVER="dummy")
        try:
            dummy = realtime_run(torch_demo.Audio, counters, FPS, 60, ssaa=1)
            sdl = (f"{dummy['frames']} frames at {dummy['fps']:.3f} fps, recorder "
                   f"{type(dummy['scene'].audio.recorder).__name__}")
            dummy["scene"].destroy()
        finally:
            os.environ["SHADERFLOW_AUDIO_BACKEND"] = "none"
    figures = dict(target_fps=FPS, frames=frames, fps=run["fps"], wall_fps=run["wall_fps"],
                   late_frames=run["late"], capture_ms=run["capture_ms"],
                   flush_ms=run["flush_ms"], host_ms_per_frame=run["capture_ms"] + run["flush_ms"],
                   device_ms_per_frame=frame_ms, launches_per_frame=frame_launches,
                   busy=frames * frame_ms / 1e3 / run["wall"], launches=run["launches"],
                   checked_frame=AUDIO_CHECK_FRAMES - 1, level=level, volume=card_volume,
                   max_u8_diff_vs_cpu=err, sdl_dummy=sdl)
    say("audio_scene", size=f"{WIDTH}x{HEIGHT}", ssaa=1, target_fps=FPS, frames=frames,
        fps=f"{run['fps']:.3f}", wall_fps=f"{run['wall_fps']:.3f}", late_frames=run["late"],
        capture_ms=f"{run['capture_ms']:.4f}", flush_ms=f"{run['flush_ms']:.4f}",
        device_ms_per_frame=f"{frame_ms:.4f}", launches_per_frame=frame_launches,
        render_enqueue_host_ms=f"{render_host_ms:.4f}", busy=f"{figures['busy']:.4f}",
        launches=run["launches"], checked_frame=AUDIO_CHECK_FRAMES - 1, level=level,
        volume=f"{card_volume:.6f}", max_u8_diff_vs_cpu=err, sdl_dummy=repr(sdl),
        card=repr(card))
    return figures


# --------------------------------------------------------------------------- #
# The live piano, the HUD, the cv2 preview, FluidSynth, segments (38-42)

PIANO_W, PIANO_H = 3840, 2160
SEGMENT_HOSTS = 2
# The FluidSynth phase: frames of its run, and the size (the log is
# host work: the same at any size)
FLUID_FRAMES, FLUID_W, FLUID_H = 90, 320, 180


def piano_live_path(counters, card: str) -> dict:
    """Phase 38: the live PianoRoll at 3840x2160, ssaa 1, in the realtime
    loop, headless: a warm-up, the unpaced ceiling, then REALTIME_FRAMES at
    60 fps; counters (K1 (d) == frames, nothing else), the three piano
    textures streamed, fps, late ticks, host ms a frame with the note scan
    apart, one frame's device ms and kernels; frame 2 at dt = 1/60 against
    its plain recomputation on the card and against device="cpu"; K1 (d)
    on that frame's tail against its plain planes, timed (the K1 (d) row's
    realtime entry)."""
    import torch
    import torch_piano_roll
    from shaderflow_tpu_torch.ops import tailfuse, tailgen
    from shaderflow_tpu_torch.piano.module import ShaderPiano
    os.environ["SHADERFLOW_AUDIO_BACKEND"] = "none"
    os.environ.pop("SHADERFLOW_RT_BATCH", None)
    device = torch.device("cuda")
    size = dict(width=PIANO_W, height=PIANO_H, ssaa=1)
    realtime_run(torch_piano_roll.PianoRoll, counters, FPS, 3, frameskip=False, **size)
    ceiling = realtime_run(torch_piano_roll.PianoRoll, counters, 1000.0, CEILING_FRAMES,
                           frameskip=False, **size)
    scans = []
    scan = ShaderPiano._scan_frame

    def timed_scan(self, now, dt):
        started = time.perf_counter()
        result = scan(self, now, dt)
        scans.append(time.perf_counter() - started)
        return result

    ShaderPiano._scan_frame = timed_scan
    builds = tailgen.compiled.builds
    try:
        run = realtime_run(torch_piano_roll.PianoRoll, counters, FPS, REALTIME_FRAMES, **size)
    finally:
        ShaderPiano._scan_frame = scan
    frames, scene = run["frames"], run["scene"]
    builds = tailgen.compiled.builds - builds
    expected = {key: 0 for key in run["launches"]}
    expected.update(k1d=frames)
    if run["launches"] != expected or frames < REALTIME_FRAMES // 4 or builds:
        raise AssertionError(f"live PianoRoll: launch counters {run['launches']} for {frames} "
                             "frames, expected K1 (d) == frames and nothing else; K1 traced "
                             f"{builds} times in the paced run (its tail is the warm-up's)")
    streamed = {"iPianoKeys", "iPianoRoll", "iPianoChan"}
    if not streamed <= scene.engine._streamed_names:
        raise AssertionError(f"live PianoRoll streams {scene.engine._streamed_names}")
    frame_ms, frame_launches, render_host_ms = frame_profile(scene, PIANO_H, PIANO_W)
    scan_ms = 1e3 * statistics.mean(scans[-frames:])
    del run["scene"], scene

    # Frame 2 at dt = 1/60: against its plain recomputation on the card and
    # against the same frames on the CPU; K1 (d) on its tail
    check, frame = realtime_frames(torch_piano_roll.PianoRoll, "cuda", 3, **size)
    frame = frame.cpu().numpy()
    spec = piano_spec(check, 0)
    aspect = check.aspect_ratio
    plain_planes = tailfuse.planes_plain(spec, PIANO_H, PIANO_W, aspect)
    plain_frame = tailfuse.final_equal_resolution(plain_planes, check.subsample).cpu()
    plain_err, plain_share = u8_diff(frame, plain_frame)
    if plain_err > 1 or plain_share >= 0.01:
        raise AssertionError(f"live PianoRoll frame 2 vs plain: max {plain_err} u8 steps on "
                             f"{plain_share:.4%}")
    _, cpu_frame = realtime_frames(torch_piano_roll.PianoRoll, "cpu", 3, **size)
    cpu_err, cpu_share = u8_diff(frame, cpu_frame.numpy())
    if cpu_err > 1 or cpu_share >= 0.01:
        raise AssertionError(f"live PianoRoll frame 2 vs device=cpu: max {cpu_err} u8 steps "
                             f"on {cpu_share:.4%}")
    planes_args = (spec, PIANO_H, PIANO_W, PIANO_H, PIANO_W, 1, aspect)
    planes = tailfuse.fused_tail_final(*planes_args, quantize=False)
    if not torch.equal(planes.view(torch.int16), plain_planes.view(torch.int16)):
        raise AssertionError("K1 (d) on the live PianoRoll's tail: bf16 planes differ from "
                             "the plain version's")
    launch = tailgen.prepare(*planes_args, device, quantize=False)
    planes_out = torch.empty_like(planes)
    k1d_bound_ms, k1d_bound_by = walked_bound(lambda: launch(planes_out))
    k1d_row = dict(launches=frames, max_abs_err=0.0, ms=device_ms(lambda: launch(planes_out)),
                   call_ms=median_ms(lambda: launch(planes_out), 20),
                   plain_ms=device_ms(lambda: tailfuse.planes_plain(spec, PIANO_H, PIANO_W,
                                                                     aspect), 5),
                   bound_ms=k1d_bound_ms, bound_by=k1d_bound_by, **k1_figures(launch))
    figures = dict(
        target_fps=FPS, frames=frames, fps=run["fps"], wall_fps=run["wall_fps"],
        late_frames=run["late"], capture_ms=run["capture_ms"], scan_ms=scan_ms,
        flush_ms=run["flush_ms"], host_ms_per_frame=run["capture_ms"] + run["flush_ms"],
        device_ms_per_frame=frame_ms, launches_per_frame=frame_launches,
        busy=frames * frame_ms / 1e3 / run["wall"], batch=run["batch"],
        ceiling_fps=ceiling["fps"], ceiling_frames=ceiling["frames"],
        launches=run["launches"], k1_traces=builds, frame_checked=2,
        max_u8_diff_vs_plain=plain_err,
        differing_share_vs_plain=plain_share, max_u8_diff_vs_cpu=cpu_err,
        differing_share_vs_cpu=cpu_share)
    say("piano_live", size=f"{PIANO_W}x{PIANO_H}", ssaa=1, target_fps=FPS, frames=frames,
        fps=f"{run['fps']:.3f}", wall_fps=f"{run['wall_fps']:.3f}", late_frames=run["late"],
        capture_ms=f"{run['capture_ms']:.4f}", scan_ms=f"{scan_ms:.4f}",
        flush_ms=f"{run['flush_ms']:.4f}", device_ms_per_frame=f"{frame_ms:.4f}",
        launches_per_frame=frame_launches, render_enqueue_host_ms=f"{render_host_ms:.4f}",
        busy=f"{figures['busy']:.4f}", batch=run["batch"],
        ceiling_fps=f"{ceiling['fps']:.3f}", launches=run["launches"], k1_traces=builds,
        first_ticks_ms=run["first_ticks_ms"], card=repr(card))
    say("piano_live_check", frame=2, dt="1/60", max_u8_diff_vs_plain=plain_err,
        differing_share_vs_plain=f"{plain_share:.3e}", max_u8_diff_vs_cpu=cpu_err,
        differing_share_vs_cpu=f"{cpu_share:.3e}")
    say("k1d_realtime", render=f"{PIANO_H}x{PIANO_W}", s=1, planes_bit_equal=True,
        **{key: (f"{value:.4f}" if isinstance(value, float) else value)
           for key, value in k1d_row.items()})
    return dict(figures=figures, k1d=k1d_row)


def hud_path(counters, card: str) -> dict:
    """Phase 39: the realtime visualizer at 1920x1080, 2x SSAA through the
    display pump into a recording stub window with the HUD on
    (render_ui): counters (K1 == K2 == frames), fps against 60, the HUD's
    ms a frame; the last shown frame outside the HUD's box equal to the
    engine's frame at that index, and changed inside it."""
    import torch_demo
    from shaderflow_tpu_torch.scene import WindowBackend
    hud_s = []

    def prepare(scene):
        scene.render_ui = True
        draw = scene._draw_hud

        def timed(frame):
            started = time.perf_counter()
            out = draw(frame)
            hud_s.append(time.perf_counter() - started)
            return out
        scene._draw_hud = timed

    # A warm-up first: a kernel build or the HUD's first text would read as
    # one long dt (with frameskip, most of the paced run)
    realtime_run(torch_demo.Visualizer, counters, FPS, 3, frameskip=False,
                 backend=WindowBackend.Preview, window=StubWindow(), prepare=prepare)
    hud_s.clear()
    window = StubWindow()
    run = realtime_run(torch_demo.Visualizer, counters, FPS, PUMP_FRAMES,
                       backend=WindowBackend.Preview, window=window, keep=16, prepare=prepare)
    scene, pump, frames = run["scene"], run["pump"], run["frames"]
    expected = {key: 0 for key in run["launches"]}
    expected.update(k1=frames, k2=frames - run["graph"])
    if run["launches"] != expected or pump is None or window.last is None or not hud_s:
        raise AssertionError(f"HUD run: counters {run['launches']}, expected K1 == K2 == "
                             f"{frames}; shown {window.shown}, HUD draws {len(hud_s)}")
    if pump.shown_tag not in run["copies"]:
        raise AssertionError(f"the last shown frame {pump.shown_tag} is older than the copies")
    engine_frame = run["copies"][pump.shown_tag].cpu().numpy()
    shown = window.last
    y1 = min(shown.shape[0], scene._HUD_ROW0 + scene._HUD_ROWH * len(scene._hud_rows) + 6)
    x1 = min(shown.shape[1], scene._HUD_WIDTH)
    outside = (shown.shape == engine_frame.shape
               and (shown[y1:] == engine_frame[y1:]).all()
               and (shown[:y1, x1:] == engine_frame[:y1, x1:]).all())
    inside_changed = float((shown[:y1, :x1] != engine_frame[:y1, :x1]).mean())
    if not outside or inside_changed < 0.5:
        raise AssertionError(f"HUD frame: outside the box equal {outside}, inside changed "
                             f"{inside_changed:.3f}")
    hud_ms, hud_draws = 1e3 * statistics.mean(hud_s), len(hud_s)
    # The same HUD drawn outside the loop (no render, no pump thread), and
    # its text pass alone: what the HUD costs by itself
    hud_s.clear()
    for _ in range(20):
        scene._draw_hud(engine_frame.copy())
    isolated_ms = 1e3 * statistics.median(hud_s)
    import cv2
    rows = len(scene._hud_rows)
    started = time.perf_counter()
    for _ in range(20):
        text = engine_frame.copy()
        for index in range(rows):
            for color, thickness in (((0, 0, 0), 2), ((255, 255, 255), 1)):
                cv2.putText(text, "fps avg  61.0  min  58.3  target 60 " * 2, (8, 18 + 16 * index),
                            cv2.FONT_HERSHEY_SIMPLEX, 0.42, color, thickness, cv2.LINE_AA)
    text_ms = (time.perf_counter() - started) / 20 * 1e3
    figures = dict(target_fps=FPS, frames=frames, fps=run["fps"], late_frames=run["late"],
                   shown=window.shown, hud_draws=hud_draws, hud_ms_per_frame=hud_ms,
                   hud_isolated_ms=isolated_ms, text_pass_ms_with_copy=text_ms,
                   hud_box=[y1, x1], inside_changed_share=inside_changed,
                   outside_equal=True, host_ms_per_frame=run["capture_ms"] + run["flush_ms"],
                   batch=run["batch"], launches=run["launches"])
    say("hud", size=f"{WIDTH}x{HEIGHT}", ssaa=SSAA, target_fps=FPS, frames=frames,
        fps=f"{run['fps']:.3f}", late_frames=run["late"], shown=window.shown,
        hud_draws=hud_draws, hud_ms_per_frame=f"{hud_ms:.4f}", hud_isolated_ms=f"{isolated_ms:.4f}",
        text_pass_ms_with_copy=f"{text_ms:.4f}", hud_box=f"{y1}x{x1}",
        inside_changed=f"{inside_changed:.4f}", outside_equal=True,
        host_ms_per_frame=f"{run['capture_ms'] + run['flush_ms']:.4f}", batch=run["batch"],
        launches=run["launches"], card=repr(card))
    return figures


class StubCV2:
    """A stand-in for cv2's window functions (no real window opens: the
    card has no display, and a Qt build of OpenCV can abort a process
    without one): records the frames shown, hands out `keys` through
    waitKey (then 255)."""
    WINDOW_NORMAL, WINDOW_FULLSCREEN, WND_PROP_FULLSCREEN = 0, 1, 0
    EVENT_MOUSEMOVE, EVENT_LBUTTONDOWN, EVENT_RBUTTONDOWN, EVENT_MBUTTONDOWN = 0, 1, 2, 3
    EVENT_LBUTTONUP, EVENT_RBUTTONUP, EVENT_MBUTTONUP, EVENT_MOUSEWHEEL = 4, 5, 6, 10

    def __init__(self, keys=()):
        self.keys = list(keys)
        self.calls = []
        self.shown = 0
        self.last = None
        self.callback = None

    def namedWindow(self, title, flags=0):
        self.calls.append("namedWindow")

    def setMouseCallback(self, title, callback):
        self.callback = callback
        self.calls.append("setMouseCallback")

    def imshow(self, title, frame):
        self.shown += 1
        self.last = frame.copy()

    def waitKey(self, delay=0):
        return self.keys.pop(0) if self.keys else 255

    def setWindowProperty(self, *args):
        self.calls.append("setWindowProperty")

    def destroyAllWindows(self):
        self.calls.append("destroyAllWindows")


def cv2_preview_path(counters, card: str) -> dict:
    """Phase 40: realtime Mandelbrot at 1920x1080, 2x SSAA in the cv2
    preview (the window backend a preview asks for; SDL cannot open one
    here) through a stub cv2 module: 'w' through waitKey on the first 20
    ticks moves the camera, then its release is synthesized; counters (K3 == K1 == frames); the last frame shown (BGR)
    equal to the engine's frame at that index."""
    import numpy as np
    import torch_fractals
    from shaderflow_tpu_torch.keyboard import ShaderKeyboard
    from shaderflow_tpu_torch.scene import WindowBackend
    stub = StubCV2(keys=[ord("w")] * 20)
    saved = sys.modules.get("cv2")
    sys.modules["cv2"] = stub
    os.environ.pop("SHADERFLOW_PREVIEW", None)
    positions = []

    def prepare(scene):
        scene.open_window = lambda: None    # SDL refused: the cv2 preview takes over
        positions.append(np.asarray(scene.camera.position.target).copy())

    try:
        realtime_run(torch_fractals.Mandelbrot, counters, FPS, 3, frameskip=False)
        run = realtime_run(torch_fractals.Mandelbrot, counters, FPS, PUMP_FRAMES,
                           backend=WindowBackend.Preview, keep=16, prepare=prepare)
    finally:
        if saved is None:
            sys.modules.pop("cv2", None)
        else:
            sys.modules["cv2"] = saved
    scene, pump, frames = run["scene"], run["pump"], run["frames"]
    expected = {key: 0 for key in run["launches"]}
    expected.update(k3=frames - run["graph"], k1=frames)
    moved = float(np.linalg.norm(np.asarray(scene.camera.position.target) - positions[0]))
    held = scene.keyboard(ShaderKeyboard.Keys.W)
    if (run["launches"] != expected or stub.calls[:2] != ["namedWindow", "setMouseCallback"]
            or stub.calls[-1] != "destroyAllWindows" or not stub.shown or moved <= 0 or held):
        raise AssertionError(f"cv2 preview: counters {run['launches']}, calls {stub.calls}, "
                             f"shown {stub.shown}, camera moved {moved}, W held {held}")
    engine_frame = run["copies"][pump.shown_tag].cpu().numpy()
    err, share = u8_diff(stub.last[..., ::-1], engine_frame)
    if err:
        raise AssertionError(f"cv2 preview: the last shown frame differs from the engine's "
                             f"by {err} u8 steps on {share:.4%}")
    figures = dict(target_fps=FPS, frames=frames, fps=run["fps"], late_frames=run["late"],
                   shown=stub.shown, camera_moved=moved, last_shown_equal=True,
                   launches=run["launches"])
    say("cv2_preview", size=f"{WIDTH}x{HEIGHT}", ssaa=SSAA, frames=frames,
        fps=f"{run['fps']:.3f}", late_frames=run["late"], shown=stub.shown,
        camera_moved=f"{moved:.6f}", w_released=not held, last_shown_equal=True,
        launches=run["launches"], card=repr(card))
    return figures


class SynthLog:
    """A stand-in `fluidsynth` module: Synth() records every call."""

    def __init__(self):
        self.calls = []
        log = self.calls

        class Synth:
            def __init__(self):
                log.append(("Synth",))

            def setting(self, key, value):
                log.append(("setting", key, value))

            def start(self):
                log.append(("start",))

            def sfload(self, path):
                log.append(("sfload", Path(path).name))
                return 1

            def program_select(self, channel, soundfont, bank, preset):
                log.append(("program_select", channel, soundfont, bank, preset))

            def noteon(self, channel, note, velocity):
                log.append(("noteon", channel, note, velocity))

            def noteoff(self, channel, note):
                log.append(("noteoff", channel, note))

        self.Synth = Synth


def fluid_run(device: str) -> list:
    """The PianoRoll with a stub synth and a soundfont, FLUID_FRAMES frames
    as the realtime loop steps them (dt = 1/60, one flush each) on
    `device`, then every note off -> the synth's log."""
    import torch_piano_roll
    from shaderflow_tpu_torch.scene import WindowBackend
    log = SynthLog()
    saved = sys.modules.get("fluidsynth")
    sys.modules["fluidsynth"] = log
    try:
        scene = torch_piano_roll.PianoRoll(backend=WindowBackend.Headless)
        scene.initialize()
        scene.piano.soundfont_file = "piano.sf2"
        scene._setup_run(width=FLUID_W, height=FLUID_H, fps=FPS, ssaa=1, device=device)
        for _ in range(FLUID_FRAMES):
            scene.engine.begin_batch()
            scene.next(dt=1.0 / FPS)
            scene.engine.flush(1)
        scene.piano.fluid_all_notes_off()
    finally:
        if saved is None:
            sys.modules.pop("fluidsynth", None)
        else:
            sys.modules["fluidsynth"] = saved
    return log.calls


def fluid_path(card: str) -> dict:
    """Phase 41: the FluidSynth hooks through a stub `fluidsynth` module:
    the synth's log of a FLUID_FRAMES-frame run on the card equal to
    the same run's on the CPU (start, the soundfont's program_select
    on 32 channels, every noteon and noteoff of the scan)."""
    card_log = fluid_run("cuda")
    cpu_log = fluid_run("cpu")
    kinds = [call[0] for call in card_log]
    if card_log != cpu_log or kinds.count("noteon") == 0 or kinds.count("program_select") != 32:
        raise AssertionError(f"FluidSynth log: card {len(card_log)} calls, cpu {len(cpu_log)}, "
                             f"equal {card_log == cpu_log}, noteon {kinds.count('noteon')}")
    figures = dict(frames=FLUID_FRAMES, calls=len(card_log), noteon=kinds.count("noteon"),
                   noteoff=kinds.count("noteoff"), program_select=kinds.count("program_select"),
                   equal_to_cpu=True, sha256=digest(json.dumps(card_log).encode()))
    say("fluidsynth", size=f"{FLUID_W}x{FLUID_H}", **figures)
    return figures


SEGMENT_SCRIPT = """
import json, sys, time
sys.path.insert(0, {repo!r})
sys.path.insert(0, {examples!r})
import torch
import torch_demo
from shaderflow_tpu_torch.ops import fractal, sampling, tailfuse
from shaderflow_tpu_torch.parallel import export_segment
sampling.expand_tables.launches = tailfuse.fused_tail_final.launches = 0
fractal.escape_iterations_sep.launches = tailfuse.fused_tail_final.planes_launches = 0
started = time.perf_counter()
export_segment(torch_demo.Visualizer(), {output!r}, hosts={hosts}, host={host}, time={seconds},
               fps={fps}, width={width}, height={height}, ssaa={ssaa}, device="cuda")
torch.cuda.synchronize()
print(json.dumps({{"host": {host}, "seconds": time.perf_counter() - started,
                   "k2": sampling.expand_tables.launches,
                   "k1": tailfuse.fused_tail_final.launches,
                   "k1d": tailfuse.fused_tail_final.planes_launches,
                   "k3": fractal.escape_iterations_sep.launches}}))
"""


def segments_path(counters, card: str) -> dict:
    """Phase 42: the visualizer at 1920x1080, 60 fps, 2x SSAA, SECONDS, as
    SEGMENT_HOSTS segments exported by concurrent processes on the one card
    (parallel.export_segment), joined (join_segments): sha256-equal to the
    single export of this process; each process's seconds and counters
    (K2 == its batches, K1 == its frames), the single export's seconds."""
    import torch_demo
    from shaderflow_tpu_torch.parallel import join_segments, segment_plan
    zero_counters, read_counters = counters
    frames = round(SECONDS * FPS)
    with tempfile.TemporaryDirectory() as tmp:
        single = Path(tmp) / "single.rgb"
        zero_counters()
        started = time.perf_counter()
        torch_demo.Visualizer().main(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA,
                                     time=SECONDS, output=str(single), device="cuda")
        single_s = time.perf_counter() - started
        single_launches = read_counters()
        single_sha = digest(single)
        single.unlink()
        joined = Path(tmp) / "joined.rgb"
        processes = []
        started = time.perf_counter()
        for host in range(SEGMENT_HOSTS):
            script = SEGMENT_SCRIPT.format(
                repo=str(REPO), examples=str(REPO / "examples" / "torch"), output=str(joined),
                hosts=SEGMENT_HOSTS, host=host, seconds=SECONDS, fps=FPS, width=WIDTH,
                height=HEIGHT, ssaa=SSAA)
            processes.append(subprocess.Popen([sys.executable, "-c", script],
                                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                              text=True))
        results = []
        try:
            for process in processes:
                out, err = process.communicate(timeout=600)
                if process.returncode != 0:
                    raise AssertionError(f"segment process failed:\n{err[-4000:]}")
                results.append(json.loads(out.strip().splitlines()[-1]))
        finally:
            for process in processes:
                if process.poll() is None:
                    process.kill()
                    process.wait()
        both_s = time.perf_counter() - started
        join_segments(joined, hosts=SEGMENT_HOSTS)
        joined_sha = digest(joined)
        joined_size = joined.stat().st_size
    plan = segment_plan(SECONDS, FPS, SEGMENT_HOSTS)
    for result, (start, end) in zip(results, plan):
        count = round(end * FPS) - round(start * FPS)
        if (result["k1"], result["k2"], result["k1d"], result["k3"]) != (count, 1, 0, 0):
            raise AssertionError(f"segment {result['host']}: counters {result}, expected "
                                 f"K1 == {count} frames, K2 == 1 batch")
    if joined_sha != single_sha or joined_size != frames * HEIGHT * WIDTH * 3:
        raise AssertionError(f"joined segments: sha256 {joined_sha} vs the single export's "
                             f"{single_sha}, {joined_size} bytes")
    figures = dict(hosts=SEGMENT_HOSTS, frames=frames, single_seconds=single_s,
                   single_launches=single_launches, both_seconds=both_s,
                   segments=results, sha256=joined_sha, equal=True)
    say("segments", config=f"Visualizer {WIDTH}x{HEIGHT} {FPS}fps {SSAA}xSSAA {SECONDS}s",
        hosts=SEGMENT_HOSTS, single_seconds=f"{single_s:.3f}",
        segment_seconds=[round(r["seconds"], 3) for r in results],
        both_seconds=f"{both_s:.3f}", launches=[{k: r[k] for k in ("k1", "k2", "k1d", "k3")}
                                                for r in results],
        sha256_equal=True, card=repr(card))
    return figures


# Phases 43-44: seconds of each export, shard counts of the card, frames
# of the profiled flush (divides every shard count)
MESH_SECONDS, MESH_SHARDS, MESH_PROFILE_FRAMES = 1.0, (2, 4), 8


# Phase 45: the stub encoder's drain rate (frames a second: about the
# visualizer's null-export rate at 1080p 2x SSAA, so render and encode take
# about as long), the pump's slots, and the exports of each batch size:
# (batch, [(turbo, buffers), ...]). The default batch (one batch of every
# frame of SECONDS: nothing to overlap) once each; batches of 8, where the
# overlap is measured, in turns, with slots enough for a batch (16) too
DRAIN_FPS, PUMP_BUFFERS = 120.0, 5
PUMP_EXPORTS = ((None, [(True, 5), (False, 5)]),
                (8, [(True, 5), (False, 5), (True, 16), (True, 16), (False, 5), (True, 5)] * 2))


@contextlib.contextmanager
def stub_encoder(directory: Path, music: Path, frame_bytes: int, drain_fps: float):
    """make_stub_audio in `directory` with `music`'s samples (a WAV), first
    on PATH, reading frame_bytes a frame and draining at most drain_fps (0:
    unpaced); FFmpeg's caches cleared on entry and exit, the environment
    restored. Yields the stub's directory."""
    import wave
    import numpy as np
    from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
    with wave.open(str(music), "rb") as handle:
        rate, channels = handle.getframerate(), handle.getnchannels()
        pcm = np.frombuffer(handle.readframes(handle.getnframes()), "<i2")
    pcm = (pcm.astype(np.float32) / 32768.0).reshape(-1, channels)
    caches = ("binary", "ffprobe", "get_audio_samplerate", "get_audio_channels")
    saved = {key: os.environ.get(key) for key in ("PATH", "STUB_FRAME_BYTES", "STUB_DRAIN_FPS")}
    stub = make_stub_audio(directory, pcm, rate)
    try:
        os.environ.update(PATH=f"{stub}{os.pathsep}{saved['PATH']}",
                          STUB_FRAME_BYTES=str(frame_bytes), STUB_DRAIN_FPS=str(drain_fps))
        for name in caches:
            getattr(FFmpeg, name).cache_clear()
        if FFmpeg.binary() != str(stub / "ffmpeg"):
            raise AssertionError(f"ffmpeg on PATH is {FFmpeg.binary()}, not the stub")
        yield stub
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        for name in caches:
            getattr(FFmpeg, name).cache_clear()


def framepump_path(counters, card: str) -> dict:
    """Phase 45: the frame pump behind FFmpegSink's turbo and buffers. The
    visualizer at 1920x1080, 60 fps, 2x SSAA, SECONDS, exported to an .mp4
    path through the stub encoder on PATH (make_stub_audio: the audio
    decoded through it too), which drains a frame at a time at DRAIN_FPS at
    most and writes the sha256 of what it read: FramePump.is_native; the
    stub's drain rate alone (frames pushed through a pump into it); a null
    export's fps; then for each batch size of PUMP_EXPORTS the export with
    turbo=True, buffers=PUMP_BUFFERS and with turbo=False (the default
    batch once each; batch 8 in turns, with buffers=16, slots for a whole
    batch, too): fps of each (frames over main()'s wall), the stub's
    seconds from its first byte (and frames over them), each sha256-equal
    to the same frames' .rgb export, K1 == frames and K2 == flushes."""
    import subprocess
    import numpy as np
    import torch_demo
    from shaderflow_tpu_torch.io.framepump import FramePump
    zero_counters, read_counters = counters
    frames = round(SECONDS * FPS)
    frame_bytes = WIDTH * HEIGHT * 3
    options = dict(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS)
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with stub_encoder(tmp / "bin", torch_demo.MUSIC, frame_bytes, DRAIN_FPS) as stub:
            # The frames every encode must receive (and the kernels built)
            torch_demo.Visualizer().main(output=str(tmp / "frames.rgb"), device="cuda",
                                         **options)
            want = digest(tmp / "frames.rgb")
            (tmp / "frames.rgb").unlink()
            # The stub alone: FRAMES frames pushed through a native pump
            encoder = subprocess.Popen([str(stub / "ffmpeg"), "-f", "rawvideo", "-i", "-",
                                        str(tmp / "drain.json")], stdin=subprocess.PIPE)
            pump = FramePump(encoder.stdin.fileno(), frame_bytes, slots=PUMP_BUFFERS)
            native = pump.is_native
            blank = np.zeros((HEIGHT, WIDTH, 3), np.uint8)
            for _ in range(frames):
                pump.submit(blank)
            pump.close()
            encoder.stdin.close()
            if encoder.wait(timeout=120) != 0 or not native:
                raise AssertionError(f"the stub alone: exit {encoder.returncode}, "
                                     f"native pump {native}")
            drained = json.loads((tmp / "drain.json").read_text())
            if drained["bytes"] != frames * frame_bytes:
                raise AssertionError(f"the stub alone read {drained['bytes']} bytes")
            drain_fps = frames / drained["seconds"]
            _, null_s, null_fps = null_export(torch_demo.Visualizer(), options)
            for batch, exports in PUMP_EXPORTS:
                flushes = -(-frames // (batch or torch_demo.Visualizer().default_batch_size()))
                for turbo, buffers in exports:
                    output = tmp / "out.mp4"
                    zero_counters()
                    started = time.perf_counter()
                    returned = torch_demo.Visualizer().main(
                        output=str(output), turbo=turbo, buffers=buffers, batch=batch,
                        device="cuda", **options)
                    wall = time.perf_counter() - started
                    launches = read_counters()
                    got = json.loads(output.read_text())
                    output.unlink()
                    expected = {key: 0 for key in launches}
                    expected.update(k2=flushes, k1=frames)
                    if (launches != expected or got["sha256"] != want
                            or got["bytes"] != frames * frame_bytes
                            or Path(returned) != output):
                        raise AssertionError(
                            f"turbo={turbo} batch={batch}: counters {launches} (expected "
                            f"{expected}), {got['bytes']} bytes, sha256 equal "
                            f"{got['sha256'] == want}, returned {returned!r}")
                    run = dict(turbo=turbo, buffers=buffers, batch=batch or "default",
                               flushes=flushes, seconds=wall, fps=frames / wall,
                               stub_seconds=got["seconds"],
                               stub_fps=frames / got["seconds"], launches=launches,
                               sha256_equal=True)
                    runs.append(run)
                    say("framepump", **{key: (f"{value:.4f}" if isinstance(value, float)
                                              else value) for key, value in run.items()},
                        card=repr(card))
    summary = {}
    for run in runs:
        mode = f"batch_{run['batch']}_" + (f"turbo{run['buffers']}" if run["turbo"] else "direct")
        summary.setdefault(f"{mode}_fps", []).append(run["fps"])
        summary.setdefault(f"{mode}_stub_fps", []).append(run["stub_fps"])
    figures = dict(config=f"Visualizer {WIDTH}x{HEIGHT} {FPS}fps {SSAA}xSSAA {SECONDS:g}s "
                   f"to .mp4 through a stub encoder draining at most {DRAIN_FPS:g} fps",
                   frames=frames, native=native, drain_fps=drain_fps,
                   null_fps=null_fps, null_seconds=null_s,
                   serial_fps=1.0 / (1.0 / null_fps + 1.0 / drain_fps),
                   lower_fps=min(null_fps, drain_fps), **summary, runs=runs)
    say("framepump_summary", **{key: (f"{value:.4f}" if isinstance(value, float) else value)
                                for key, value in figures.items() if key != "runs"},
        card=repr(card))
    return figures


# --------------------------------------------------------------------------- #
# Config 5 with its mux (46) and the JAX package's run-time switches (47)

# A BATCH_TRACE line (a progress bar may precede it on its line)
TRACE_LINE = re.compile(r"BATCH_TRACE frames=(\d+)\+(\d+) capture=(\d+\.\d)ms "
                        r"dispatch=(\d+\.\d)ms drain=(\d+\.\d)ms$", re.M)
# Phase 46: config 5's size; phase 47: the batch of the depth and trace
# exports, and the depths timed
MUX_WIDTH, MUX_HEIGHT = 3840, 2160
SWITCH_BATCH, DEPTHS = 8, (1, 2, 3)
# Phase 47 (c): the frames held against the reference route on the CPU
# (negative: from the end); 47 (d): the host loop's runs and their length
REF_FRAMES, SKIP_RUNS, SKIP_SECONDS = (0, -1), 3, 10.0


@contextlib.contextmanager
def switched(**values: str):
    """The environment with `values` set, restored after."""
    saved = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def rgb_diff(got: Path, want: Path, frame_bytes: int) -> tuple[int, float]:
    """u8_diff of two .rgb exports of equal size, read a few frames at a
    time -> (max u8 steps, share of differing values)."""
    import numpy as np
    size = want.stat().st_size
    if got.stat().st_size != size:
        raise AssertionError(f"{got.name}: {got.stat().st_size} bytes, {want.name}: {size}")
    a, b = np.memmap(got, np.uint8, "r"), np.memmap(want, np.uint8, "r")
    worst, differing, step = 0, 0, 8 * frame_bytes
    for start in range(0, size, step):
        diff = np.abs(a[start:start + step].astype(np.int16) - b[start:start + step])
        worst, differing = max(worst, int(diff.max())), differing + int(np.count_nonzero(diff))
    return worst, differing / size


def traced_batches(stderr: str, frames: int) -> list[tuple]:
    """The BATCH_TRACE lines of one export -> [(first frame, count,
    capture ms, dispatch ms, drain ms)]; every line in the JAX package's
    format and the batches covering frames 0..frames-1 in order."""
    batches = [(int(m.group(1)), int(m.group(2)), *map(float, m.group(3, 4, 5)))
               for m in TRACE_LINE.finditer(stderr)]
    if len(batches) != stderr.count("BATCH_TRACE") or not batches:
        raise AssertionError(f"BATCH_TRACE lines out of format: {stderr[-2000:]!r}")
    starts = [first for first, *_ in batches]
    if starts != [sum(b[1] for b in batches[:i]) for i in range(len(batches))] \
            or sum(b[1] for b in batches) != frames:
        raise AssertionError(f"BATCH_TRACE batches {[b[:2] for b in batches]} do not cover "
                             f"{frames} frames")
    return batches


def config5_mux_path(counters, card: str) -> dict:
    """Phase 46: config 5 (BASELINE.json: MIDI and audio spectrogram to a 4K60
    export, full A/V mux). PianoRoll at 3840x2160, 60 fps, ssaa 1, SECONDS,
    exported at the default batch to an .mp4 through the stub encoder
    (make_stub_audio: it also decodes the audio; unpaced), which writes the
    sha256 of what it read: the encoder's argv (the audio input,
    -shortest, the video options), the sha256 equal to the same frames'
    .rgb export, K1 (d) == frames and no other kernel, fps over main()'s
    wall, the default batch (32) and the pipeline depth the budget chose
    (2)."""
    import torch_piano_roll
    zero_counters, read_counters = counters
    frames = round(SECONDS * FPS)
    frame_bytes = MUX_WIDTH * MUX_HEIGHT * 3
    options = dict(width=MUX_WIDTH, height=MUX_HEIGHT, fps=FPS, ssaa=1, time=SECONDS)
    audio = str(torch_piano_roll.MUSIC)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # The frames the encoder must receive (and the kernel built)
        started = time.perf_counter()
        torch_piano_roll.PianoRoll().main(output=str(tmp / "frames.rgb"), device="cuda",
                                          **options)
        rgb_s = time.perf_counter() - started
        if (tmp / "frames.rgb").stat().st_size != frames * frame_bytes:
            raise AssertionError(f"PianoRoll .rgb: {(tmp / 'frames.rgb').stat().st_size} bytes")
        want = digest(tmp / "frames.rgb")
        (tmp / "frames.rgb").unlink()
        with stub_encoder(tmp / "bin", torch_piano_roll.MUSIC, frame_bytes, 0.0) as stub:
            output = tmp / "out.mp4"
            scene = torch_piano_roll.PianoRoll()
            zero_counters()
            started = time.perf_counter()
            returned = scene.main(output=str(output), device="cuda", **options)
            wall = time.perf_counter() - started
            launches = read_counters()
            got = json.loads(output.read_text())
            calls = [json.loads(line)
                     for line in (stub / "calls.jsonl").read_text().splitlines()]
    encodes = [args for args in calls if "f32le" not in args]
    argv = encodes[0] if len(encodes) == 1 else []
    inputs = [argv[i + 1] for i, arg in enumerate(argv) if arg == "-i"]
    video = {flag: argv[argv.index(flag) + 1] for flag in ("-s", "-r", "-pix_fmt", "-c:v")
             if flag in argv}
    if (len(encodes) != 1 or inputs != ["-", audio] or "-shortest" not in argv
            or video.get("-s") != f"{MUX_WIDTH}x{MUX_HEIGHT}" or float(video["-r"]) != FPS
            or "-c:v" not in video or argv[-1] != str(output)):
        raise AssertionError(f"config 5's encoder commands: {encodes}")
    expected = {key: 0 for key in launches}
    expected["k1d"] = frames
    if launches != expected:
        raise AssertionError(f"config 5 counters {launches}, expected {expected}")
    if got["sha256"] != want or got["bytes"] != frames * frame_bytes or \
            Path(returned) != output:
        raise AssertionError(f"config 5's .mp4: {got['bytes']} bytes, sha256 equal "
                             f"{got['sha256'] == want}, returned {returned!r}")
    batch = scene.default_batch_size()
    depth = scene.pipeline_depth(batch)
    if (batch, depth) != (32, 2):
        raise AssertionError(f"config 5: default batch {batch}, pipeline depth {depth}; "
                             "expected 32 and 2")
    figures = dict(config=f"PianoRoll {MUX_WIDTH}x{MUX_HEIGHT} {FPS}fps ssaa=1 {SECONDS:g}s "
                   "to .mp4 with its audio muxed, through an unpaced stub encoder",
                   frames=frames, batch=batch, pipeline_depth=depth,
                   flushes=-(-frames // batch), seconds=wall, fps=frames / wall,
                   rgb_seconds=rgb_s, rgb_fps=frames / rgb_s, stub_seconds=got["seconds"],
                   stub_fps=frames / got["seconds"], launches=launches, sha256_equal=True,
                   audio_input=audio, shortest=True, argv=argv)
    say("config5_mux", **{key: (f"{value:.4f}" if isinstance(value, float) else
                                repr(" ".join(value)) if key == "argv" else value)
                          for key, value in figures.items()}, card=repr(card))
    return figures


def depth_path(counters, card: str) -> dict:
    """Phase 47 (a): SHADERFLOW_PIPELINE_DEPTH. The visualizer at 1920x1080,
    60 fps, 2x SSAA, SECONDS, batch SWITCH_BATCH, to a .rgb file without the
    switch and at each depth of DEPTHS: every export sha256-equal to the
    default's, the default depth 2; fps of each (frames over main()'s
    wall)."""
    import torch_demo
    zero_counters, read_counters = counters
    frames = round(SECONDS * FPS)
    options = dict(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS,
                   batch=SWITCH_BATCH)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        output = Path(tmp) / "depth.rgb"
        for depth in (None, *DEPTHS):
            env = {} if depth is None else {"SHADERFLOW_PIPELINE_DEPTH": str(depth)}
            with switched(**env):
                scene = torch_demo.Visualizer()
                zero_counters()
                started = time.perf_counter()
                scene.main(output=str(output), device="cuda", **options)
                wall = time.perf_counter() - started
                chosen = scene.pipeline_depth(SWITCH_BATCH)
            launches = read_counters()
            sha = digest(output)
            output.unlink()
            label = "default" if depth is None else f"depth_{depth}"
            runs[label] = dict(depth=chosen, fps=frames / wall, seconds=wall,
                               launches=launches, sha256_equal=sha == runs.get(
                                   "default", {}).get("sha256", sha), sha256=sha)
            say("switch_depth", run=label, batch=SWITCH_BATCH, depth=chosen,
                seconds=f"{wall:.4f}", fps=f"{frames / wall:.3f}", launches=launches,
                sha256_equal=runs[label]["sha256_equal"], card=repr(card))
            if chosen != (depth or 2) or not runs[label]["sha256_equal"] or \
                    launches["k1"] != frames:
                raise AssertionError(f"SHADERFLOW_PIPELINE_DEPTH={depth}: {runs[label]}")
    return runs


def trace_path(counters, card: str) -> dict:
    """Phase 47 (b): SHADERFLOW_BATCH_TRACE=1 on phase 45's export (the
    visualizer to .mp4 through the stub encoder draining at most DRAIN_FPS,
    turbo on, PUMP_BUFFERS slots) at the default batch and at batch
    SWITCH_BATCH: one line a flush, in the JAX package's format, the frames
    the stub read sha256-equal to the .rgb export's; the median capture,
    dispatch (the host's enqueue of the flush) and drain ms a batch, and
    their sums over the export beside main()'s wall."""
    import io
    import torch_demo
    zero_counters, read_counters = counters
    frames = round(SECONDS * FPS)
    frame_bytes = WIDTH * HEIGHT * 3
    options = dict(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS)
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        torch_demo.Visualizer().main(output=str(tmp / "frames.rgb"), device="cuda", **options)
        want = digest(tmp / "frames.rgb")
        (tmp / "frames.rgb").unlink()
        with stub_encoder(tmp / "bin", torch_demo.MUSIC, frame_bytes, DRAIN_FPS):
            for batch in (None, SWITCH_BATCH):
                output = tmp / "out.mp4"
                err = io.StringIO()
                with switched(SHADERFLOW_BATCH_TRACE="1"), contextlib.redirect_stderr(err):
                    zero_counters()
                    started = time.perf_counter()
                    torch_demo.Visualizer().main(output=str(output), turbo=True,
                                                 buffers=PUMP_BUFFERS, batch=batch,
                                                 device="cuda", **options)
                    wall = time.perf_counter() - started
                launches = read_counters()
                got = json.loads(output.read_text())
                output.unlink()
                batches = traced_batches(err.getvalue(), frames)
                flushes = -(-frames // (batch or torch_demo.Visualizer().default_batch_size()))
                if len(batches) != flushes or launches["k2"] != flushes or \
                        got["sha256"] != want:
                    raise AssertionError(f"trace at batch {batch}: {len(batches)} lines, "
                                         f"{flushes} flushes, counters {launches}, sha256 "
                                         f"equal {got['sha256'] == want}")
                parts = {name: [b[i] for b in batches]
                         for i, name in ((2, "capture"), (3, "dispatch"), (4, "drain"))}
                label = f"batch_{batch or 'default'}"
                runs[label] = dict(
                    lines=len(batches), flushes=flushes, seconds=wall, fps=frames / wall,
                    stub_fps=frames / got["seconds"], sha256_equal=True,
                    **{f"{name}_ms_median": statistics.median(values)
                       for name, values in parts.items()},
                    **{f"{name}_ms_total": sum(values) for name, values in parts.items()},
                    batches=[list(b) for b in batches])
                say("switch_trace", run=label, **{
                    key: (f"{value:.4f}" if isinstance(value, float) else value)
                    for key, value in runs[label].items() if key != "batches"},
                    card=repr(card))
    return runs


def no_tailfuse_path(counters, card: str) -> dict:
    """Phase 47 (c): SHADERFLOW_NO_TAILFUSE=1. The port takes the reference
    tail on CPU tensors only: under the switch an export on the card
    raises before anything runs (no launch, no output file). The PSNR
    gate's FUSED-vs-REF row: Mandelbrot and the visualizer at 1920x1080,
    60 fps, 2x SSAA, SECONDS exported on the card by default (K1 ==
    frames; K3 == frames for Mandelbrot, K2 == flushes for the
    visualizer), frames REF_FRAMES of it against the reference route's
    (the switch, device="cpu", cpu_frame): within 1 u8 step on < 1 % of
    values (the visualizer < 2 %); fps of the card's null export."""
    import numpy as np
    import torch_demo
    import torch_fractals
    zero_counters, read_counters = counters
    frames = round(SECONDS * FPS)
    indices = [index % frames for index in REF_FRAMES]
    options = dict(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS)
    figures = {}
    for cls, bar in ((torch_fractals.Mandelbrot, 0.01), (torch_demo.Visualizer, 0.02)):
        name = cls.__name__
        flushes = -(-frames // cls().default_batch_size())
        fused = {"k3": frames if name == "Mandelbrot" else 0, "k3p": 0,
                 "k2": flushes if name == "Visualizer" else 0, "k1": frames, "k1d": 0,
                 "k1h": 0}
        zeros = {key: 0 for key in fused}
        with tempfile.TemporaryDirectory() as tmp:
            tmp = Path(tmp)
            refused = tmp / "refused.rgb"
            with switched(SHADERFLOW_NO_TAILFUSE="1"):
                zero_counters()
                try:
                    cls().main(output=str(refused), device="cuda", **options)
                    refusal = ""
                except RuntimeError as error:
                    refusal = str(error)
                refused_launches = read_counters()
                if "SHADERFLOW_NO_TAILFUSE" not in refusal or refused_launches != zeros \
                        or refused.exists():
                    raise AssertionError(f"{name} on the card under SHADERFLOW_NO_TAILFUSE=1: "
                                         f"raised {refusal!r}, counters {refused_launches}, "
                                         f"output written {refused.exists()}")
                started = time.perf_counter()
                reference = [cpu_frame(cls, index, options) for index in indices]
                cpu_s = time.perf_counter() - started
            zero_counters()
            cls().main(output=str(tmp / "fused.rgb"), device="cuda", **options)
            launches = read_counters()
            expected = ({**fused, "k3": frames - graph_launches()} if name == "Mandelbrot"
                        else fused)
            if launches != expected:
                raise AssertionError(f"{name} fused: counters {launches}, expected {expected}")
            exported = np.memmap(tmp / "fused.rgb", np.uint8, "r").reshape(frames, HEIGHT,
                                                                           WIDTH, 3)
            diffs = [u8_diff(exported[index], want) for index, want in zip(indices, reference)]
            del exported
        _, null_s, null_fps = null_export(cls(), options)
        err = max(worst for worst, _ in diffs)
        share = max(differing for _, differing in diffs)
        if err > 1 or share >= bar:
            raise AssertionError(f"{name}: the card's frames {indices} against the reference "
                                 f"route's: {diffs}")
        figures[name] = dict(refused=True, refused_launches=refused_launches,
                             fused_launches=launches, frames_checked=indices,
                             max_u8_diff=err, differing_share=share,
                             cpu_reference_seconds=cpu_s, null_seconds=null_s,
                             null_fps=null_fps)
        say("switch_no_tailfuse", scene=name, **{
            key: (f"{value:.3e}" if key == "differing_share" else
                  f"{value:.4f}" if isinstance(value, float) else value)
            for key, value in figures[name].items()}, card=repr(card))
    return figures


def skip_path(counters, card: str, reference: dict) -> dict:
    """Phase 47 (d): SKIP_TPU=1, the host loop alone. The visualizer at
    1920x1080, 60 fps, 2x SSAA: after a short warm-up export, SKIP_RUNS
    null exports of SKIP_SECONDS traced (SHADERFLOW_BATCH_TRACE=1): the
    ceiling read from inside the loop, capture, dispatch (the flush's
    return) and drain ms a frame summed from the trace, beside frames over
    main()'s wall (set-up included); a .rgb export of SECONDS: every frame
    zero, the right count; K1 == K2 == K3 == 0 throughout; a flush of 8
    frames watched (tools/watch.py): no CUDA kernel and no copy in its
    profile, no torch op on a CUDA tensor, no launch counted; `reference`
    beside it (the null exports of phases 6 and 10, with the device); the
    realtime loop headless, unpaced (fps=1000, no frameskip) for
    CEILING_FRAMES frames."""
    import numpy as np
    import io
    import torch_demo
    from shaderflow_tpu_torch.scene import WindowBackend
    from shaderflow_tpu_torch.tools import watch
    zero_counters, read_counters = counters
    frames = round(SECONDS * FPS)
    options = dict(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, time=SECONDS)
    zeros = {key: 0 for key in read_counters()}
    runs = []
    with switched(SKIP_TPU="1"):
        zero_counters()
        null_export(torch_demo.Visualizer(), {**options, "time": 0.25})
        long_frames = round(SKIP_SECONDS * FPS)
        for _ in range(SKIP_RUNS):
            err = io.StringIO()
            with switched(SHADERFLOW_BATCH_TRACE="1"), contextlib.redirect_stderr(err):
                _, null_s, null_fps = null_export(torch_demo.Visualizer(),
                                                  {**options, "time": SKIP_SECONDS})
            batches = traced_batches(err.getvalue(), long_frames)
            runs.append(dict(seconds=null_s, fps=null_fps, **{
                f"{part}_ms_per_frame": sum(b[i] for b in batches) / long_frames
                for i, part in ((2, "capture"), (3, "dispatch"), (4, "drain"))}))
        with tempfile.TemporaryDirectory() as tmp:
            output = Path(tmp) / "skip.rgb"
            torch_demo.Visualizer().main(output=str(output), device="cuda", **options)
            data = np.fromfile(output, np.uint8)
        launches = read_counters()
        if data.size != frames * HEIGHT * WIDTH * 3 or data.any() or launches != zeros:
            raise AssertionError(f"SKIP_TPU export: {data.size} bytes, any nonzero "
                                 f"{bool(data.any())}, counters {launches}")
        del data
        scene = torch_demo.Visualizer(backend=WindowBackend.Headless)
        scene._setup_run(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=SSAA, device="cuda")
        scene.engine.begin_batch()
        for _ in range(8):
            scene.next(dt=1.0 / FPS)
        out = []
        zero_counters()
        activities = watch.profiled_activities(lambda: out.append(scene.engine.flush(8)))
        ops = watch.cuda_ops(lambda: out.append(scene.engine.flush(8)))
        if activities or ops or read_counters() != zeros or any(
                frames.device.type != "cpu" or frames.any()
                or tuple(frames.shape) != (8, HEIGHT, WIDTH, 3) for frames in out):
            raise AssertionError(f"SKIP_TPU flush: CUDA activities {activities}, torch ops "
                                 f"on the card {ops}, counters {read_counters()}, frames "
                                 f"{[(f.device, tuple(f.shape)) for f in out]}")
        with switched(SHADERFLOW_AUDIO_BACKEND="none"):
            live = realtime_run(torch_demo.Visualizer, counters, fps=1000.0,
                                frames=CEILING_FRAMES, frameskip=False)
        if live["launches"] != zeros:
            raise AssertionError(f"SKIP_TPU realtime counters {live['launches']}")
    loop_ms = [sum(run[f"{part}_ms_per_frame"] for part in ("capture", "dispatch", "drain"))
               for run in runs]
    figures = dict(frames=long_frames, runs=runs,
                   loop_ms_per_frame_median=statistics.median(loop_ms),
                   loop_fps_median=1e3 / statistics.median(loop_ms),
                   null_fps_median=statistics.median(run["fps"] for run in runs),
                   capture_ms_per_frame_median=statistics.median(
                       run["capture_ms_per_frame"] for run in runs),
                   dispatch_ms_per_frame_median=statistics.median(
                       run["dispatch_ms_per_frame"] for run in runs),
                   flush_cuda_activities=0, realtime_ceiling_fps=live["fps"],
                   realtime_capture_ms=live["capture_ms"], realtime_flush_ms=live["flush_ms"],
                   **{f"{name}_fps": fps for name, fps in reference.items()})
    say("switch_skip_tpu", **{key: (f"{value:.4f}" if isinstance(value, float) else
                                    [{k: round(v, 4) for k, v in run.items()} for run in value]
                                    if key == "runs" else value)
                              for key, value in figures.items()}, card=repr(card))
    return figures


def slot0_path(counters, card: str) -> dict:
    """Phase 47 (e): SHADERFLOW_REF_SLOT0=1. MotionBlur (a temporal main
    program) at 1920x1080, 60 fps, ssaa 1, frames 0..TEMPORAL_CHECK_FRAME,
    on the card and with device="cpu" under the switch: within 1 u8 step
    on < 1 % of values; and the card's default export differing from it."""
    import torch_demo
    zero_counters, read_counters = counters
    frames = TEMPORAL_CHECK_FRAME + 1
    options = dict(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=1, time=frames / FPS)
    frame_bytes = WIDTH * HEIGHT * 3
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        with switched(SHADERFLOW_REF_SLOT0="1"):
            zero_counters()
            started = time.perf_counter()
            torch_demo.MotionBlur().main(output=str(tmp / "card.rgb"), device="cuda", **options)
            card_s = time.perf_counter() - started
            launches = read_counters()
            torch_demo.MotionBlur().main(output=str(tmp / "cpu.rgb"), device="cpu", **options)
        torch_demo.MotionBlur().main(output=str(tmp / "default.rgb"), device="cuda", **options)
        err, share = rgb_diff(tmp / "card.rgb", tmp / "cpu.rgb", frame_bytes)
        _, default_share = rgb_diff(tmp / "card.rgb", tmp / "default.rgb", frame_bytes)
    if err > 1 or share >= 0.01 or default_share < 0.1 or any(launches.values()):
        raise AssertionError(f"SHADERFLOW_REF_SLOT0=1: card vs cpu max {err} u8 steps on "
                             f"{share:.4%}; against the default {default_share:.4%} "
                             f"differ; counters {launches}")
    figures = dict(frames=frames, seconds=card_s, fps=frames / card_s, max_u8_diff_vs_cpu=err,
                   differing_share_vs_cpu=share, differing_share_vs_default=default_share,
                   launches=launches)
    say("switch_ref_slot0", **{key: (f"{value:.4e}" if "share" in key else
                                     f"{value:.4f}" if isinstance(value, float) else value)
                               for key, value in figures.items()}, card=repr(card))
    return figures


TOOLS = REPO / "examples" / "torch"


def run_tool(script: str, *arguments: str) -> tuple[list[str], float]:
    """python3 examples/torch/<script> with `arguments`, in a process of its
    own -> (its standard output's lines, wall seconds); raises with its
    error output when it exits with another code than 0. This process's
    cached card memory is released first: the tool's process needs it."""
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    started = time.perf_counter()
    process = subprocess.run([sys.executable, str(TOOLS / script), *arguments],
                             capture_output=True, text=True, timeout=900)
    seconds = time.perf_counter() - started
    if process.returncode != 0:
        print(process.stdout[-6000:], flush=True)
        raise AssertionError(f"{script} {' '.join(arguments)} exited {process.returncode} "
                             f"(this process reserves {torch.cuda.memory_reserved() / 2**30:.1f} "
                             f"GiB of the card):\n{process.stderr[-4000:]}")
    return process.stdout.strip().splitlines(), seconds


def gate_path(card: str) -> dict:
    """Phase 48: the PSNR gate (examples/torch/psnr_gate.py) on the card:
    its table on the lines before, every row at its bar (the tool exits 1
    otherwise, which raises here); the kernels its frames went through
    (K1, K1 bf16, K2, K3 lines and planes each launched)."""
    with tempfile.TemporaryDirectory() as tmp:
        lines, seconds = run_tool("psnr_gate.py", "--out", str(Path(tmp) / "psnr_gate.md"))
    for line in lines[:-1]:
        print(line)
    result = json.loads(lines[-1])
    launches = result["launches"]
    if result["failed"] or not all(launches[key] for key in ("k1", "k1h", "k2", "k3", "k3p")):
        raise AssertionError(f"psnr_gate: failed {result['failed']}, launches {launches}")
    figures = dict(rows=len(result["psnr_gate"]), seconds=seconds, render_s=result["render_s"],
                   gate_wall_s=result["wall_s"], launches=launches,
                   rows_by_config={row["config"] if row["check"].startswith("oracle")
                                   else f"{row['check']} {row['config']}":
                                   row["value"] if row["value"] != float("inf") else "inf"
                                   for row in result["psnr_gate"]})
    say("psnr_gate", rows=figures["rows"], failed=0, seconds=f"{seconds:.1f}",
        render_s=f"{result['render_s']:.1f}", gate_wall_s=f"{result['wall_s']:.1f}",
        launches=launches, card=repr(card))
    return figures


def roofline_path(card: str) -> dict:
    """Phase 49: the roofline (examples/torch/roofline.py) of the six graded
    configs, each in its own process: the table on the lines before; each
    row's ms a frame, count, bound, bounding unit and share (the tool
    raises over 100 %); Mandelbrot's useful and executed escape steps."""
    lines, seconds = run_tool("roofline.py")
    rows = [json.loads(line) for line in lines if line.startswith("{")]
    for line in lines:
        if not line.startswith("{"):
            print(line)
    if len(rows) != 6 or any(not 0 < row["share"] <= 1 for row in rows):
        raise AssertionError(f"roofline: {len(rows)} rows, shares "
                             f"{[row['share'] for row in rows]}")
    mandelbrot = next(row for row in rows if row["config"] == "mandelbrot")
    if not 0 < mandelbrot["useful_steps_px"] <= mandelbrot["executed_steps_px"]:
        raise AssertionError(f"roofline: Mandelbrot's steps {mandelbrot}")
    for row in rows:
        say("roofline", config=row["config"], ms_per_frame=f"{row['ms_per_frame']:.4f}",
            bound_ms=f"{row['bound_ms']:.5f}", bound_by=row["bound_by"],
            share=f"{row['share']:.4f}", card=repr(card))
    return {"seconds": seconds, "rows": rows}


def coldstart_path(card: str) -> dict:
    """Phase 50: the cold start (examples/torch/coldstart.py) of the 10 s
    visualizer export, from an empty build directory and Triton cache (at
    least one nvcc build), then with the checkout's (no nvcc build): both
    JSON lines on the lines before."""
    fresh_lines, fresh_s = run_tool("coldstart.py")
    kept_lines, kept_s = run_tool("coldstart.py", "--keep-cache")
    print(fresh_lines[-1])
    print(kept_lines[-1])
    fresh, kept = json.loads(fresh_lines[-1]), json.loads(kept_lines[-1])
    nvcc = [[e["tool"] for e in run["build_events"]].count("nvcc") for run in (fresh, kept)]
    if nvcc[0] < 1 or nvcc[1] != 0:
        raise AssertionError(f"coldstart: nvcc builds {nvcc[0]} fresh, {nvcc[1]} with the "
                             "checkout's build")
    for run, seconds in ((fresh, fresh_s), (kept, kept_s)):
        say("coldstart", cache=run["cache"], seconds=f"{seconds:.1f}",
            builds=len(run["build_events"]),
            cold_export_s=f"{run['phases']['cold_export_total']:.3f}",
            warm_export_s=f"{run['phases']['warm_export_total']:.3f}", card=repr(card))
    return {"fresh": fresh, "checkout": kept, "seconds": fresh_s + kept_s}


def zero_counters() -> None:
    """Every kernel wrapper's launch count, and the fragment graphs'
    counters, set to 0."""
    from shaderflow_tpu_torch.fraggraph import FragmentGraph
    from shaderflow_tpu_torch.ops import fractal, sampling, tailfuse
    FragmentGraph.calls = FragmentGraph.replays = FragmentGraph.captures = 0
    FragmentGraph.refusals = 0
    fractal.escape_iterations_sep.launches = 0
    fractal.escape_iterations.launches = 0
    sampling.expand_tables.launches = 0
    tailfuse.fused_tail_final.launches = 0
    tailfuse.fused_tail_final.ratio_launches = 0
    tailfuse.fused_tail_final.planes_launches = 0
    tailfuse.fused_tail_final.bf16_launches = 0


def graph_launches() -> int:
    """Launches of the fragments' CUDA graphs since zero_counters (each
    capture replays once). The launch counters count eager launches: a
    recorded fragment's K3 launches eagerly on its recording's first
    frame and from the graph after it (one K3 a graph launch:
    tests/test_torch_cuda.py::test_fragment_graph_captures_under_the_profiler),
    so K3's count on a recorded export is frames - graph_launches()."""
    from shaderflow_tpu_torch.fraggraph import FragmentGraph
    return FragmentGraph.captures + FragmentGraph.replays


def read_counters() -> dict:
    from shaderflow_tpu_torch.ops import fractal, sampling, tailfuse
    return {"k3": fractal.escape_iterations_sep.launches,
            "k3p": fractal.escape_iterations.launches,
            "k2": sampling.expand_tables.launches,
            "k1": tailfuse.fused_tail_final.launches,
            "k1d": tailfuse.fused_tail_final.planes_launches,
            "k1h": tailfuse.fused_tail_final.bf16_launches}


def mesh_configs(shards_of_one_card: bool = True) -> list:
    """(label, mesh_devices, devices) of phases 43-44: one device, N
    shards of card 0, and one shard on each of N cards where the machine
    has N."""
    import torch
    configs = [("single", None, None)]
    if shards_of_one_card:
        configs += [(f"{n}x cuda:0", ["cuda:0"] * n, n) for n in MESH_SHARDS]
    configs += [(f"{n} cards", [f"cuda:{k}" for k in range(n)], n) for n in MESH_SHARDS
                if n <= torch.cuda.device_count()]
    return configs


def mesh_export(cls, label: str, pool, devices, counters, options: dict) -> dict:
    """One configuration of phases 43-44: a .rgb export through
    Scene.main(devices=...) (sha256, counters, the shards' frames and row
    windows), then a null export (seconds, peak memory) and the device
    profile of one flush of its last batch's first MESH_PROFILE_FRAMES."""
    import gc

    import torch
    zero_counters, read_counters = counters
    gc.collect()   # earlier scenes' rings (module <-> scene cycles)
    with tempfile.TemporaryDirectory() as tmp:
        output = Path(tmp) / "out.rgb"
        scene = cls()
        scene.mesh_devices = pool
        zero_counters()
        scene.main(output=str(output), devices=devices, device="cuda", **options)
        launches, graphed = read_counters(), graph_launches()
        sha = digest(output)
    engine = scene.engine
    shards = engine._shards
    figures = dict(config=label, sha256=sha, launches=launches, graph=graphed,
                   shards=len(shards) or 1, frames_per_shard=[len(s.frames) for s in shards],
                   windows=[dict(s.windows) for s in shards])
    if shards and shards[0].carry:
        engine.join_shards()
        rings = [shard.carry for shard in shards]
        figures["rings_split"] = all(
            len({ring[name].data.data_ptr() for ring in rings}) == len(shards)
            and all(torch.equal(ring[name].data.to(rings[0][name].data.device),
                                rings[0][name].data) for ring in rings)
            for name in rings[0])
    del scene, engine, shards
    gc.collect()
    scene = cls()
    scene.mesh_devices = pool
    cards = range(torch.cuda.device_count())
    for card in cards:
        torch.cuda.synchronize(card)
        torch.cuda.reset_peak_memory_stats(card)
    held = [torch.cuda.memory_allocated(card) for card in cards]   # earlier phases'
    started = time.perf_counter()
    scene.main(output="null", devices=devices, device="cuda", **options)
    for card in cards:
        torch.cuda.synchronize(card)
    seconds = time.perf_counter() - started
    frames = round(options["time"] * options["fps"])
    peaks = [torch.cuda.max_memory_allocated(card) - before
             for card, before in zip(cards, held)]
    count = min(MESH_PROFILE_FRAMES, len(scene.engine.frame_indices()))

    def flush():
        scene.engine.flush(count)
        for card in cards:   # device_profile synchronizes the current card only
            torch.cuda.synchronize(card)
    flush_ms, flush_launches = device_profile(flush, 2)
    figures.update(frames=frames, seconds=seconds, fps=frames / seconds,
                   device_ms_per_frame=flush_ms / count,
                   launches_per_frame=(flush_launches / count if flush_launches else None),
                   busy=frames * flush_ms / count / 1e3 / seconds, peak_bytes=peaks[0],
                   peak_bytes_per_card=peaks)
    return figures


def mesh_paths(counters, card: str, shards_of_one_card: bool = True) -> dict:
    """Phases 43-44: every scene and configuration of mesh_configs(); the
    counters and sha256 of each against the single export's (see the
    module docstring). A warm-up export of each scene builds its kernels
    first."""
    import torch
    import torch_demo
    import torch_fractals
    from shaderflow_tpu_torch.parallel.mesh import frame_parts
    frames = round(MESH_SECONDS * FPS)
    paths = {}
    for phase, ssaa, classes in (
            ("mesh_frames", SSAA, (torch_demo.Visualizer, torch_fractals.Mandelbrot,
                                   torch_fractals.Tetration)),
            ("mesh_rows", 1, (torch_demo.MotionBlur, torch_demo.Life))):
        options = dict(width=WIDTH, height=HEIGHT, fps=FPS, ssaa=ssaa, time=MESH_SECONDS)
        for cls in classes:
            name = cls.__name__
            cls().main(output="null", device="cuda", **{**options, "time": 2 / FPS})
            runs = []
            for label, pool, devices in mesh_configs(shards_of_one_card):
                run = mesh_export(cls, label, pool, devices, counters, options)
                n = run["shards"]
                expected = {key: 0 for key in run["launches"]}
                if phase == "mesh_frames":
                    expected["k1"] = frames
                    if name == "Mandelbrot":
                        # eager, and in the graph on one device
                        expected["k3"] = frames - run["graph"]
                    if name == "Visualizer":
                        # one flush a batch of 128 frames, K2 once a shard
                        expected["k2"] = -(-frames // 128) * n
                    if n > 1 and run["frames_per_shard"] != [
                            end - first for first, end in frame_parts(frames, n)]:
                        raise AssertionError(f"{name} {label}: frames per shard "
                                             f"{run['frames_per_shard']}")
                elif n > 1:
                    rows = [window["iScreen"] for window in run["windows"]]
                    want = [(k * HEIGHT // n, (k + 1) * HEIGHT // n) for k in range(n)]
                    if rows != want or not run["rings_split"]:
                        raise AssertionError(f"{name} {label}: windows {rows}, rings split "
                                             f"{run['rings_split']}")
                if run["launches"] != expected:
                    raise AssertionError(f"{name} {label}: counters {run['launches']}, "
                                         f"expected {expected}")
                if runs and run["sha256"] != runs[0]["sha256"]:
                    raise AssertionError(f"{name} {label}: sha256 {run['sha256']} vs the "
                                         f"single export's {runs[0]['sha256']}")
                say(phase, scene=name, config=repr(label), shards=n, frames=frames,
                    sha256_equal=run["sha256"] == runs[0]["sha256"] if runs else "reference",
                    launches=run["launches"], frames_per_shard=run["frames_per_shard"],
                    seconds=f"{run['seconds']:.4f}", fps=f"{run['fps']:.3f}",
                    device_ms_per_frame=f"{run['device_ms_per_frame']:.4f}",
                    launches_per_frame=run["launches_per_frame"], busy=f"{run['busy']:.4f}",
                    peak_gib=[round(peak / 2 ** 30, 3) for peak in run["peak_bytes_per_card"]],
                    rings_split=run.get("rings_split", "-"), card=repr(card))
                runs.append(run)
            paths[name] = runs
    if torch.cuda.device_count() < 2:
        say("mesh_cards", cards="not measured: one card on this machine")
    return paths


def mesh_main(card: str) -> int:
    """`python3 chip_smoke.py --mesh`: phases 43-44 alone, on every card of
    the machine: on one card its shards, on several one shard a card (the
    path that exists only across cards, against one device)."""
    import torch
    from shaderflow_tpu_torch import build
    say("card", nvidia_smi=repr(card), count=torch.cuda.device_count(),
        built=",".join(build.build_cuda_libraries()) or "cached")
    mesh = mesh_paths((zero_counters, read_counters), card,
                      shards_of_one_card=torch.cuda.device_count() < 2)
    print(json.dumps({"mesh": mesh, "card": card}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main() -> int:
    script_started = time.perf_counter()
    import torch
    if sys.argv[1:] not in ([], ["--mesh"]):
        print("usage: chip_smoke.py [--mesh]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: this checks the "
              "port on a CUDA card", file=sys.stderr)
        return 2
    if not (REPO / "shaderflow_tpu_torch").is_dir():
        print(f"chip_smoke: no shaderflow_tpu_torch package next to {__file__}: "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))
    from shaderflow_tpu_torch import switches
    inherited = [name for name in switches.NAMES if name in os.environ]
    if inherited:
        print(f"chip_smoke: {', '.join(inherited)} set in the environment: the phases "
              "set each switch around their own calls only", file=sys.stderr)
        return 2
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
    if sys.argv[1:] == ["--mesh"]:
        return mesh_main(card)
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
    bench_dtype._chain_library()
    sources = {source.stem: source for source in build.cuda_sources()}
    say("build", libraries=",".join(built) or "cached",
        seconds=f"{time.perf_counter() - started:.3f}",
        ptxas=repr(" | ".join(build.ptxas_report(sources[n]).strip().replace("\n", " ; ")
                              for n in ("escape", "lookup", "fixture", "chain"))))
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
        graphed = graph_launches()
        if mandelbrot_launches != {"k3": frames - graphed, "k3p": 0, "k2": 0, "k1": frames,
                                   "k1d": 0, "k1h": 0}:
            raise AssertionError(f"Mandelbrot launch counters {mandelbrot_launches}, "
                                 f"{graphed} graph launches, expected K3 (eager and in the "
                                 f"graph) == K1 == {frames} frames, K2 == 0")
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
        null_fps = {"phase6_mandelbrot_null": frames / null_s}
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
    null_fps["phase10_visualizer_null"] = frames / null_s
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
            graphed = graph_launches()
            if launches != {"k3": 0, "k3p": frames - graphed, "k2": 0, "k1": frames, "k1d": 0,
                            "k1h": 0}:
                raise AssertionError(f"{name} launch counters {launches}, {graphed} graph "
                                     f"launches, expected K3 planes (eager and in the graph) "
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

    # 17. T3: the cost walker's fixture and the walker's counts (its own
    # path), at its own size, at a 64 MiB stream and at two odd sizes: one
    # launch a call, torch.equal to x * 2 + 1, the walker's count the hand
    # count (body x logical grid) whatever the launch grid
    # The floor of a launch: an empty kernel's device time, beside which the
    # bounds of T1's and T3's single tiny launches are read
    empty_ms = device_ms(lambda: flopcount.empty_launch(device))
    empty_call_ms = median_ms(lambda: flopcount.empty_launch(device), 20)
    say("empty_launch", ms=f"{empty_ms:.4f}", call_ms=f"{empty_call_ms:.4f}", card=repr(card))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    t3_compiled = sass.ptxas_figures(build.ptxas_report(sources["fixture"]), "fixture_kernel")
    if t3_compiled["spill_stores"] or t3_compiled["spill_loads"]:
        raise AssertionError(f"T3's kernel spills: {t3_compiled}")
    one, two = torch.ones((), device=device), torch.full((), 2.0, device=device)
    t3 = {}
    for label, rows in flopcount.FIXTURE_ROWS.items():
        x = flopcount.fixture_inputs(rows, device)
        flopcount.fixture.launches = 0
        with flopcount.Walker() as walker:
            fixture_out = flopcount.fixture(x)
        launches = flopcount.fixture.launches
        fixture_want = flopcount.fixture_plain(x)
        torch.cuda.synchronize()
        err = (fixture_out - fixture_want).abs().max().item()
        hand = (rows // 32 * 2 * 32 * 128, 2 * rows * 128 * 4)   # body x grid: ops, bytes
        if not torch.equal(fixture_out, fixture_want) or launches != 1:
            raise AssertionError(f"T3 fixture at {rows}x128 vs x * 2 + 1: max {err}, "
                                 f"launches {launches}")
        if (walker.cost.alu, walker.cost.kernel_bytes) != hand:
            raise AssertionError(f"walker counted {walker.cost}, hand count (ops, bytes) {hand}")
        ctas, threads = flopcount.fixture_geometry(x.numel() // 4, sms)
        entry = {"rows": rows, "launches": launches, "max_abs_err": err, "ctas": ctas,
                 "threads": threads, "n_regs": t3_compiled["n_regs"]}
        if label in ("fixture", "stream"):
            if not torch.equal(torch.addcmul(one, x, two), fixture_want):
                raise AssertionError("T3's library call differs from x * 2 + 1")
            bound_ms, bound_by = flopcount.roofline(walker.cost)
            ms = device_ms(lambda: flopcount.fixture(x))
            entry.update(ms=ms, call_ms=median_ms(lambda: flopcount.fixture(x), 20),
                         plain_ms=device_ms(lambda: flopcount.fixture_plain(x)),
                         library_ms=device_ms(lambda: torch.addcmul(one, x, two)),
                         bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms,
                         gap_ms=ms - empty_ms)
        del x, fixture_out, fixture_want
        t3[label] = entry
        say("t3", size=label, shape=f"{rows}x128", equal=True, walker_alu=int(walker.cost.alu),
            walker_bytes=int(walker.cost.kernel_bytes), sms=sms,
            **{key: (f"{value:.6f}" if isinstance(value, float) else value)
               for key, value in entry.items()}, card=repr(card))

    # 18. T1: the bf16 op probe through K1's compiler (its own path): one
    # launch an op over both input sets stacked, over every SM
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
    a16, b16 = probe_bf16_ops.stacked_inputs(device)
    mul = probe_bf16_ops.compile_op("mul")
    t1_err = (probe_bf16_ops.run_op(mul, a16, b16).float() - (a16 * b16).float()).abs().max().item()
    t1_ms = device_ms(lambda: probe_bf16_ops.run_op(mul, a16, b16))
    t1_call_ms = median_ms(lambda: probe_bf16_ops.run_op(mul, a16, b16), 20)
    t1_plain_ms = device_ms(lambda: a16 * b16)
    t1_bound_ms, t1_bound_by = walked_bound(lambda: probe_bf16_ops.run_op(mul, a16, b16))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    t1_block = probe_bf16_ops.block_size(a16.numel(), sms)
    say("t1_summary", ops=len(table), ok=sum(r == "ok" for r in table.values()),
        seconds=f"{t1_s:.3f}", launches=t1_launches, shape=tuple(a16.shape), sms=sms,
        programs=a16.numel() // t1_block, block=t1_block,
        mul_ms=f"{t1_ms:.4f}", mul_call_ms=f"{t1_call_ms:.4f}",
        mul_plain_ms=f"{t1_plain_ms:.4f}", bound_ms=f"{t1_bound_ms:.6f}",
        bound_by=t1_bound_by, empty_launch_ms=f"{empty_ms:.4f}", card=repr(card))

    # 19. T2: the tail-shaped chain (csrc/chain.cu) in float32 and bfloat16
    # (its own path): both dtypes checked against the plain chain and timed
    # in turns by CUDA-graph replay (bench: the kernel's ms and the one
    # verdict); the kernel's square root against torch.sqrt on every
    # float32 of its domain; registers, spills, SASS a round, and what a
    # round costs in issue slots
    bench_dtype.chain.launches = 0
    t2 = bench_dtype.bench()
    t2_launches = bench_dtype.chain.launches
    if not (t2["float32"]["equal"] and t2["bfloat16"]["equal"]):
        raise AssertionError(f"T2 chain vs plain: f32 max {t2['float32']['max_abs_err']}, "
                             f"bf16 max {t2['bfloat16']['max_abs_err']}")
    domain = bench_dtype.sqrt_domain(device)
    sqrt_differ = int((bench_dtype.chain_sqrt(domain) != torch.sqrt(domain)).sum())
    t2_sqrt = {"values": domain.numel(), "differ": sqrt_differ}
    del domain
    say("t2_sqrt", domain="[2^-10, 4)", **t2_sqrt)
    if sqrt_differ:
        raise AssertionError(f"T2's square root differs from torch.sqrt on {sqrt_differ} "
                             f"float32 values of [2^-10, 4)")
    t2_code = bench_dtype.compiled()
    t2_times = {}
    for label, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        inputs = bench_dtype.inputs(dtype)
        name = str(dtype).replace("torch.", "")
        bound_ms, bound_by = walked_bound(
            lambda: bench_dtype.chain(*inputs, check_domain=False))
        cost = bench_dtype.round_cost(dtype)
        times = dict(ms=t2[name]["ms"],
                     call_ms=median_ms(lambda: bench_dtype.chain(*inputs, check_domain=False), 20),
                     plain_ms=t2[name]["plain_ms"], max_abs_err=t2[name]["max_abs_err"],
                     round_ms=cost["round_ms"],
                     slots_per_element_round=cost["slots_per_element_round"])
        code = t2_code[name]
        issuing = code["instructions_per_element_round"] / cost["slots_per_element_round"]
        t2_times[label] = {**times, "bound_ms": bound_ms, "bound_by": bound_by,
                           "share": bound_ms / times["ms"], "issuing": issuing,
                           **{key: value for key, value in code.items() if key != "ops"}}
        say("t2", dtype=name, shape=f"{bench_dtype.H}x{bench_dtype.W}", reps=bench_dtype.REPS,
            **{key: f"{value:.6f}" for key, value in times.items()},
            bound_ms=f"{bound_ms:.6f}", bound_by=bound_by,
            share=f"{bound_ms / times['ms']:.3f}", tops=f"{t2[name]['tops']:.2f}",
            n_regs=code["n_regs"], spill_stores=code["spill_stores"],
            spill_loads=code["spill_loads"], rounds_a_trip=code["rounds_a_trip"],
            instructions_per_round=f"{code['instructions_per_round']:.2f}",
            instructions_per_element_round=f"{code['instructions_per_element_round']:.3f}",
            issuing=f"{issuing:.3f}", bf16x2_per_round=f"{code['bf16x2_per_round']:.2f}",
            ops=code["ops"])
        if code["spill_stores"] or code["spill_loads"]:
            raise AssertionError(f"T2's {name} kernel spills: {code}")
    if not t2_times["bf16"]["bf16x2_per_round"]:
        raise AssertionError(f"T2's bf16 kernel issues no packed bf16x2 arithmetic: "
                             f"{t2_code['bfloat16']['ops']}")
    say("t2_summary", launches=t2_launches,
        verdict=repr(bench_dtype.verdict(t2_times["f32"]["ms"], t2_times["bf16"]["ms"])),
        card=repr(card))

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

    # 26. GLSL Plasma through the command line (no kernel: the plain final pass)
    scenes["Plasma"] = glsl_plasma_path((zero_counters, read_counters), card)
    # 27. The GLSL front-end's masked loop: host reads every k trips
    scenes["Escape"] = glsl_loop_path(card)
    # 28. Mandelbrot through the command line: K3 and K1 once a frame
    scenes["Mandelbrot (cli.main)"] = cli_mandelbrot_path((zero_counters, read_counters))
    print(json.dumps({"scenes": scenes}))
    # 29.-31. The realtime preview
    realtime = realtime_paths((zero_counters, read_counters), card)
    print(json.dumps({"realtime": realtime["paths"], "card": card}))
    # 32.-34. Any supersampling factor (the general final pass, K1 at ratio
    # 4) and mipmaps
    any_ssaa = any_ssaa_paths((zero_counters, read_counters), card)
    print(json.dumps({"any_ssaa": any_ssaa["paths"], "card": card}))
    # 35. Video through the port's ffmpeg pipe into a streamed u8 texture
    print(json.dumps({"video": video_path((zero_counters, read_counters), card),
                      "card": card}))
    # 36. The visualizer from a non-WAV file, and the pipe and TCP outputs
    audio_export = audio_export_path((zero_counters, read_counters), card)
    # 37. The Audio scene in the realtime loop, from a stub recorder
    audio_scene = audio_scene_path((zero_counters, read_counters), card)
    print(json.dumps({"audio": {"export": audio_export, "scene": audio_scene}, "card": card}))
    # 38. The live PianoRoll at 4K60: K1 (d) once a frame from streamed textures
    piano_live = piano_live_path((zero_counters, read_counters), card)
    # 39. The HUD over the realtime visualizer through the display pump
    hud = hud_path((zero_counters, read_counters), card)
    # 40. The cv2 preview through a stub cv2, keys through waitKey
    cv2_preview = cv2_preview_path((zero_counters, read_counters), card)
    # 41. The FluidSynth hooks through a stub synth: the card's log == the CPU's
    fluid = fluid_path(card)
    # 42. Two processes on the card, each a segment of the visualizer, joined
    segments = segments_path((zero_counters, read_counters), card)
    print(json.dumps({"live": {"piano": piano_live["figures"], "hud": hud,
                               "cv2_preview": cv2_preview, "fluidsynth": fluid,
                               "segments": segments}, "card": card}))
    # 43.-44. Frame and row sharding over shards of the card
    mesh = mesh_paths((zero_counters, read_counters), card)
    print(json.dumps({"mesh": mesh, "card": card}))
    # 45. The frame pump: the visualizer to .mp4 through a paced stub
    # encoder, turbo against direct
    pump = framepump_path((zero_counters, read_counters), card)
    print(json.dumps({"framepump": pump, "card": card}))
    # 46. Config 5 with its mux: PianoRoll at 4K60 to .mp4 with its audio
    config5 = config5_mux_path((zero_counters, read_counters), card)
    print(json.dumps({"config5": config5, "card": card}))
    # 47. The JAX package's run-time switches, each set around its own calls
    switches = {"pipeline_depth": depth_path((zero_counters, read_counters), card),
                "batch_trace": trace_path((zero_counters, read_counters), card),
                "no_tailfuse": no_tailfuse_path((zero_counters, read_counters), card),
                "skip_tpu": skip_path((zero_counters, read_counters), card, null_fps),
                "ref_slot0": slot0_path((zero_counters, read_counters), card)}
    print(json.dumps({"switches": switches, "card": card}))
    # 48-50. The gate, the roofline and the cold start (examples/torch/),
    # each tool in processes of its own
    tools = {"psnr_gate": gate_path(card), "roofline": roofline_path(card),
             "coldstart": coldstart_path(card)}
    print(json.dumps({"tools": tools, "card": card}))

    def mesh_launches(name: str, key: str) -> dict:
        """A kernel's launches in each phase 43 configuration of a scene,
        and each shard's frames there."""
        return {run["config"]: {"launches": run["launches"][key],
                                "frames_per_shard": run["frames_per_shard"]}
                for run in mesh[name]}
    say("done", seconds=f"{time.perf_counter() - script_started:.1f}")

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
                       "bound_by": k1t_bound_by, **k1t_compiled,
                       "mesh": mesh_launches("Tetration", "k1")},
         "any_ssaa": any_ssaa["k1"], "mesh": mesh_launches("Mandelbrot", "k1")},
        {"name": "K1 (b)+(c) fused tail with Indexed and ColSampled inputs (visualizer tail)",
         "route": "triton", "source": "shaderflow_tpu_torch/ops/tailgen.py",
         "replaces": "shaderflow_tpu/ops/tailfuse.py:485",
         "launches": visualizer_launches["k1"], "max_abs_err": k1v_err,
         "ms": k1v_ms, "call_ms": k1v_call_ms, "plain_ms": k1v_plain_ms,
         "bound_ms": k1v_bound_ms, "bound_by": k1v_bound_by, "library_ms": None,
         **k1v_compiled, "realtime": realtime["k1"],
         "audio_export": {"launches": audio_export["launches"]["k1"]},
         "hud": {"launches": hud["launches"]["k1"]},
         "segments": {"launches": [r["k1"] for r in segments["segments"]]},
         "mesh": mesh_launches("Visualizer", "k1"),
         "framepump": {"launches": [r["launches"]["k1"] for r in pump["runs"]]},
         "no_tailfuse": {"refused_launches": switches["no_tailfuse"]["Visualizer"]
                         ["refused_launches"]["k1"]}},
        {"name": "K2 lookup_expand (bar-field table expand)",
         "route": "cuda", "source": "shaderflow_tpu_torch/csrc/lookup.cu",
         "replaces": "shaderflow_tpu/ops/sampling.py:851",
         "launches": visualizer_launches["k2"], "max_abs_err": k2_err,
         "ms": k2_ms, "call_ms": k2_call_ms, "plain_ms": k2_plain_ms, "bound_ms": k2_bound_ms,
         "bound_by": k2_bound_by, "library_ms": k2_library_ms, "realtime": realtime["k2"],
         "any_ssaa": any_ssaa["k2"], "audio_export": {"launches": audio_export["launches"]["k2"]},
         "hud": {"launches": hud["launches"]["k2"]},
         "segments": {"launches": [r["k2"] for r in segments["segments"]]},
         "mesh": mesh_launches("Visualizer", "k2"),
         "framepump": {"launches": [r["launches"]["k2"] for r in pump["runs"]]},
         "no_tailfuse": {"refused_launches": switches["no_tailfuse"]["Visualizer"]
                         ["refused_launches"]["k2"]}},
        {"name": "K1 (d) fused tail, quantize=False: bf16 planes at s = 1 (PianoRoll tail)",
         "route": "triton", "source": "shaderflow_tpu_torch/ops/tailgen.py",
         "replaces": "shaderflow_tpu/ops/tailfuse.py:485",
         "launches": piano_launches["k1d"], "max_abs_err": k1d_err,
         "ms": k1d_ms, "call_ms": k1d_call_ms, "plain_ms": k1d_plain_ms,
         "bound_ms": k1d_bound_ms, "bound_by": k1d_bound_by, "library_ms": None,
         **k1d_compiled, "realtime": piano_live["k1d"],
         "config5_mux": {"launches": config5["launches"]["k1d"]}},
        {"name": "K3 escape_lines (Mandelbrot escape counts, lines form)",
         "route": "cuda", "source": "shaderflow_tpu_torch/csrc/escape.cu",
         "replaces": "shaderflow_tpu/ops/fractal.py:66",
         "launches": mandelbrot_launches["k3"], "max_abs_err": k3_err,
         "ms": k3_ms, "call_ms": k3_call_ms, "plain_ms": k3_plain_ms, "bound_ms": k3_bound_ms,
         "bound_by": k3_bound_by, "library_ms": None, **k3_compiled["lines"],
         "any_ssaa": any_ssaa["k3"], "mesh": mesh_launches("Mandelbrot", "k3"),
         "no_tailfuse": {"refused_launches": switches["no_tailfuse"]["Mandelbrot"]
                         ["refused_launches"]["k3"]}},
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
        {"name": "T1 probe_bf16_ops (one bf16 kernel per op, one launch over both input "
                 "sets; timed: mul at 2x256x256)",
         "route": "triton", "source": "shaderflow_tpu_torch/tools/probe_bf16_ops.py",
         "replaces": "tools/probe_bf16_ops.py:45",
         "launches": t1_launches, "max_abs_err": t1_err,
         "ms": t1_ms, "call_ms": t1_call_ms, "plain_ms": t1_plain_ms, "bound_ms": t1_bound_ms,
         "bound_by": t1_bound_by, "library_ms": t1_plain_ms,
         "empty_launch_ms": empty_ms, "table": table},
        {"name": "T2 bench_dtype chain (timed by CUDA-graph replay: bf16; f32 beside it)",
         "route": "cuda", "source": "shaderflow_tpu_torch/csrc/chain.cu",
         "replaces": "tools/bench_vpu_dtype.py:35",
         "launches": t2_launches, **t2_times["bf16"], "library_ms": None,
         **{f"f32_{key}": value for key, value in t2_times["f32"].items()},
         "speedup": t2_times["f32"]["ms"] / t2_times["bf16"]["ms"], "sqrt_check": t2_sqrt},
        {"name": "T3 cost-walker fixture x * 2 + 1 (128x128, four (32, 128) blocks; "
                 "a 64 MiB stream and odd sizes beside it)",
         "route": "cuda", "source": "shaderflow_tpu_torch/csrc/fixture.cu",
         "replaces": "tests/test_flopcount.py:64",
         **t3["fixture"], "empty_launch_ms": empty_ms, "sms": sms,
         "spills": t3_compiled["spill_stores"] + t3_compiled["spill_loads"],
         **{label: t3[label] for label in ("stream", "one_block", "odd")}},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
