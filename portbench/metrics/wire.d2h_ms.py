"""Device milliseconds a frame of the device-to-host copies (the wire's
pinned copy of each batch), over the traced stretch; frames counted from
the bytes copied."""


def read(trace):
    seconds = trace.device_seconds(kind="memcpy", direction="DtoH")
    copied = sum(e.bytes for e in trace.device if e.kind == "memcpy" and e.direction == "DtoH")
    frames = copied / trace.frame_bytes if copied and trace.frame_bytes else 0
    if seconds <= 0 or frames < 1:
        return None
    return 1e3 * seconds / frames
