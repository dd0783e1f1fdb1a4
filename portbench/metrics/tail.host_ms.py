"""Host milliseconds a frame in the port's own `tail` spans
(tailfuse.run_tail_final or the plain final pass, K1's prepare
included), over the frames the window's exports flushed."""

from portbench.harness.program import of, window_session

# The port's session over a traced run's window (harness/program.py)
SPANS = window_session()


def read(trace):
    program = of(trace)
    if program is None or not program.total("frames"):
        return None
    return 1e3 * program.seconds("tail") / program.total("frames")
