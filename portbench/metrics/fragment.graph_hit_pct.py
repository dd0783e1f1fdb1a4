"""Share of the fragment's runs in the window that replayed its CUDA graph
(shaderflow_tpu_torch/fraggraph.py: the fragment.replays counter over
fragment.calls, every ShaderProgram.render_layer), in percent. A port
without the counters reports nothing."""

from portbench.harness.program import of, window_session

# The port's session over a traced run's window (harness/program.py)
SPANS = window_session()


def read(trace):
    program = of(trace)
    calls = program.total("fragment.calls") if program is not None else 0
    if not calls:
        return None
    return 100.0 * program.total("fragment.replays") / calls
