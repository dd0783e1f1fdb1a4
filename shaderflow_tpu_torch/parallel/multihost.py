"""
Segmented export: per-host content windows, then a lossless join.

Port of shaderflow_tpu/parallel/multihost.py. Freewheel time is exact
(frame k renders at t = k / fps, and Scene.main(start=) resumes there), so
hosts, or processes on one card, render disjoint frame-aligned windows of
the same export on their own and the segments join losslessly: .rgb
streams byte by byte with their .json frame counts summed, containers
through FFmpeg's concat demuxer (FFmpeg.concat_segments). No frame crosses
between them.

Only scenes without temporal feedback segment exactly: with a ring, frame
k reads frame k - 1, and a window's first frame would need the history
before it.

    from shaderflow_tpu_torch.parallel import export_segment, join_segments
    export_segment(MyScene(), "out.mp4", hosts=4, host=rank, time=30.0,
                   width=3840, height=2160, fps=60)   # on every host
    join_segments("out.mp4", hosts=4)                 # on one, after all
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

from shaderflow_tpu_torch import logger


def segment_plan(duration: float, fps: float, hosts: int) -> list:
    """[0, duration) split into `hosts` frame-aligned (start, end) windows
    in seconds: each an integral run of frames, together every frame of
    the single export exactly once."""
    if hosts < 1:
        raise ValueError(f"hosts must be >= 1, got {hosts}")
    total = round(duration * fps)
    plan = []
    for host in range(hosts):
        first = (total * host) // hosts
        last = (total * (host + 1)) // hosts
        plan.append((first / fps, last / fps))
    return plan


def segment_path(output, host: int) -> Path:
    """Host `host`'s segment file beside `output`: out.seg003.mp4."""
    output = Path(output)
    return output.with_stem(f"{output.stem}.seg{host:03d}")


def export_segment(scene, output, *, hosts: int, host: int,
                   time: float, fps: float = 60.0, **main_kwargs):
    """Render host `host`'s window of the export to its segment file
    through scene.main(start=, time=); the other keywords go to main().
    A scene with temporal feedback is refused."""
    for module in scene.modules:
        texture = getattr(module, "texture", None)
        if texture is not None and getattr(texture, "temporal", 1) > 1:
            raise ValueError(
                f"Scene has temporal feedback ({module.name}); a segmented export "
                f"needs frames that do not read the frame before")
    start, end = segment_plan(time, fps, hosts)[host]
    target = segment_path(output, host)
    logger.info(f"Host {host}/{hosts}: rendering [{start:.3f}, {end:.3f})s -> {target}")
    return scene.main(output=str(target), time=end, start=start, fps=fps, **main_kwargs)


def join_segments(output, *, hosts: int, remove: bool = True) -> Path:
    """Join every host's segment into `output` (on one host, after every
    export_segment returned). .rgb streams and their .json metadata join
    byte by byte, anything else through FFmpeg's concat demuxer. A missing
    segment raises."""
    output = Path(output)
    segments = [segment_path(output, host) for host in range(hosts)]
    missing = [s for s in segments if not s.exists()]
    if missing:
        raise FileNotFoundError(f"Missing segments: {missing}")

    if output.suffix == ".rgb":
        meta = None
        with open(output, "wb") as joined:
            for segment in segments:
                with open(segment, "rb") as handle:
                    shutil.copyfileobj(handle, joined)
                side = segment.with_suffix(".rgb.json")
                if side.exists():
                    part = json.loads(side.read_text())
                    if meta is None:
                        meta = part
                    else:
                        meta["frames"] += part["frames"]
        if meta is not None:
            output.with_suffix(".rgb.json").write_text(json.dumps(meta))
    else:
        from shaderflow_tpu_torch.io.ffmpeg import FFmpeg
        FFmpeg.concat_segments(segments, output)

    if remove:
        for segment in segments:
            segment.unlink(missing_ok=True)
            segment.with_suffix(".rgb.json").unlink(missing_ok=True)
    logger.info(f"Joined {hosts} segments -> {output}")
    return output
