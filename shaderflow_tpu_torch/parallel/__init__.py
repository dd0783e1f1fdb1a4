"""Exports split across processes or hosts (parallel/multihost.py)."""

from shaderflow_tpu_torch.parallel.multihost import (
    export_segment, join_segments, segment_path, segment_plan)

__all__ = ["export_segment", "join_segments", "segment_path", "segment_plan"]
