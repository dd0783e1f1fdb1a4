"""Share of the traced stretch in which no kernel, copy or memset runs on
the device (the union of the CUDA activity intervals), in percent."""


def read(trace):
    window = trace.window_seconds()
    if window <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_seconds() / window)
