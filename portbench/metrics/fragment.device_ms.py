"""Device milliseconds a frame of the kernels launched inside the
fragment (ShaderProgram.render_layer), over the traced stretch."""


# Spans this metric reads: label -> (module, owner, attribute)
SPANS = {"fragment": ("shaderflow_tpu_torch.shader", "ShaderProgram", "render_layer")}


def read(trace):
    seconds = trace.device_seconds(span="fragment")
    if not trace.stretch_frames or seconds <= 0:
        return None
    return 1e3 * seconds / trace.stretch_frames
