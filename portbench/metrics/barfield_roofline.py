"""Share of its least time that the batch prelude of the bar field takes:
the spectrogram table read and the bar field written, once, over HBM's
rate, against the device time of every kernel launched inside
RenderEngine._run_preludes, a frame each."""

from portbench.harness.counting import least_seconds, share_pct


# Spans this metric reads: label -> (module, owner, attribute)
SPANS = {"engine.preludes": ("shaderflow_tpu_torch.engine", "RenderEngine", "_run_preludes")}


def read(trace):
    if "barfield_bytes" not in trace.work or not trace.stretch_frames:
        return None
    least, _ = least_seconds(0, trace.work["barfield_bytes"])
    measured = trace.device_seconds(span="engine.preludes") / trace.stretch_frames
    return share_pct(least, measured)
