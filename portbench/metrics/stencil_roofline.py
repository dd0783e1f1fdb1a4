"""Share of its least time that the equal-resolution regime's stencil
and quantize take on the device: the larger of its bytes (three
bfloat16 planes read once, the u8 frame written once) over HBM's rate
and its operations over the float32 peak (the reference's stencil_ops
and stencil_bytes, portbench/harness/counting.py), against the device
time of the kernels, copies and fills launched inside the port's
`tail.stencil` spans (tailfuse.final_equal_resolution), a frame each.

The device stretch's Chrome trace shows each span as an "sf.tail.stencil"
range while the port's session is open; the launches inside a range are
found by their correlation ids when the harness reads that trace. A port
without the span reports nothing."""

import json
import sys

from portbench.harness.counting import least_seconds, share_pct
from portbench.harness.program import _traced_run, of, window_session

RANGE = "sf.tail.stencil"
DEVICE = ("kernel", "gpu_memcpy", "gpu_memset")


def launched_in(path, name: str) -> float:
    """Device seconds of the trace's kernels, copies and fills whose launch
    fell inside a range named `name` on the launching thread."""
    with open(path) as handle:
        events = [event for event in json.load(handle)["traceEvents"]
                  if event.get("ph") == "X" and "ts" in event]
    ranges: dict = {}
    for event in events:
        if event.get("cat") == "user_annotation" and event.get("name") == name:
            start = float(event["ts"])
            ranges.setdefault(event.get("tid"), []).append(
                (start, start + float(event.get("dur", 0))))
    inside = set()
    for event in events:
        correlation = (event.get("args") or {}).get("correlation")
        if event.get("cat") in ("cuda_runtime", "cuda_driver") and correlation is not None:
            ts = float(event["ts"])
            if any(start <= ts <= end for start, end in ranges.get(event.get("tid"), ())):
                inside.add(correlation)
    return 1e-6 * sum(float(event.get("dur", 0)) for event in events
                      if event.get("cat") in DEVICE
                      and (event.get("args") or {}).get("correlation") in inside)


def _hook() -> None:
    """While the harness gathers a traced run's spans: have the stretch's
    Chrome trace read for the stencil's device time as well (once)."""
    trace = _traced_run()
    if trace is None or "stencil_hook" in vars(trace):
        return
    module = sys.modules[type(trace).__module__]
    original = module.read_chrome_trace

    def read_chrome_trace(path):
        found = original(path)
        trace.stencil_seconds = launched_in(path, RANGE)
        if module.read_chrome_trace is read_chrome_trace:
            module.read_chrome_trace = original
        return found

    module.read_chrome_trace = read_chrome_trace
    trace.stencil_hook = (module, original, read_chrome_trace)


# The port's session over a traced run's window (harness/program.py), its
# spans profiled as "sf." ranges in the stretch
SPANS = window_session()
_hook()


def read(trace):
    of(trace)
    module, original, wrapper = vars(trace).pop("stencil_hook", (None, None, None))
    if module is not None and module.read_chrome_trace is wrapper:
        module.read_chrome_trace = original
    seconds = getattr(trace, "stencil_seconds", 0.0)
    if "stencil_ops" not in trace.work or not trace.stretch_frames or seconds <= 0:
        return None
    least, _ = least_seconds(trace.work["stencil_ops"], trace.work["stencil_bytes"])
    return share_pct(least, seconds / trace.stretch_frames)
