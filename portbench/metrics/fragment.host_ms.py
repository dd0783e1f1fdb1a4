"""Host milliseconds a frame in the port's own `fragment` spans
(ShaderProgram.render_layer: the fragment's ops enqueued), over the
frames the window's exports flushed (shaderflow_tpu_torch.tracing)."""

from portbench.harness.program import of, window_session

# The port's session over a traced run's window (harness/program.py)
SPANS = window_session()


def read(trace):
    program = of(trace)
    if program is None or not program.total("frames"):
        return None
    return 1e3 * program.seconds("fragment") / program.total("frames")
