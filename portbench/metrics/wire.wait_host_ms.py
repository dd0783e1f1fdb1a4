"""Host milliseconds a frame blocked on the card: the port's `wire.wait`
spans (WireBatch.wait, the D2H copy of a batch waited for) and
`staging.wait` spans (the staging pool waiting for its oldest upload),
over the frames the window's exports flushed."""

from portbench.harness.program import of, window_session

# The port's session over a traced run's window (harness/program.py)
SPANS = window_session()


def read(trace):
    program = of(trace)
    if program is None or not program.total("frames"):
        return None
    return 1e3 * program.seconds("wire.wait", "staging.wait") / program.total("frames")
