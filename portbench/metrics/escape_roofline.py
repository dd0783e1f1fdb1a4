"""Share of its least time that the escape-count kernel (K3) takes: the
useful escape steps of a frame's pixels (counted by the reference on the
same c grid) at ESCAPE_OPS_PER_STEP float32 operations each, over the
float32 peak, against K3's device time a frame."""

from portbench.harness.counting import ESCAPE_OPS_PER_STEP, least_seconds, share_pct


def read(trace):
    if "escape_steps" not in trace.work or not trace.stretch_frames:
        return None
    least, _ = least_seconds(trace.work["escape_steps"] * ESCAPE_OPS_PER_STEP, 0)
    measured = trace.device_seconds(kind="kernel", name="escape") / trace.stretch_frames
    return share_pct(least, measured)
