"""Share of its least time that the tail and final pass take on the
device: the larger of the stage's bytes (inputs read once, the u8 frame
written once) over HBM's rate and the operations that the
configuration's tail formula needs over the float32 peak
(portbench/harness/counting.py),
against the device time of every kernel launched inside
tailfuse.run_tail_final, a frame each."""

from portbench.harness.counting import least_seconds, share_pct


# Spans this metric reads: label -> (module, owner, attribute)
SPANS = {"tail": ("shaderflow_tpu_torch.ops.tailfuse", None, "run_tail_final")}


def read(trace):
    if "tail_ops" not in trace.work or not trace.stretch_frames:
        return None
    least, _ = least_seconds(trace.work["tail_ops"], trace.work["tail_bytes"])
    return share_pct(least, trace.device_seconds(span="tail") / trace.stretch_frames)
