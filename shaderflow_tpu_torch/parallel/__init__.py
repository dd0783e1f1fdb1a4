"""Exports split across devices (parallel/mesh.py) and across processes
or hosts (parallel/multihost.py)."""

from shaderflow_tpu_torch.parallel.mesh import (
    Mesh, available_devices, flush_frames, flush_rows, frame_mesh, supports_frame_sharding)
from shaderflow_tpu_torch.parallel.multihost import (
    export_segment, join_segments, segment_path, segment_plan)

__all__ = ["Mesh", "available_devices", "export_segment", "flush_frames", "flush_rows",
           "frame_mesh", "join_segments", "segment_path", "segment_plan",
           "supports_frame_sharding"]
