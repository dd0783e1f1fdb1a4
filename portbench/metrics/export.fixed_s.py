"""Host seconds an export spends on its fixed costs: the port's
`export.setup` (scene set-up, sink, bar), `prewarm`, `engine.build` and
`export.drain` spans, over the exports begun in the window."""

from portbench.harness.program import FIXED, of, window_session

# The port's session over a traced run's window (harness/program.py)
SPANS = window_session()


def read(trace):
    program = of(trace)
    if program is None or not program.exports():
        return None
    return program.seconds(*FIXED) / program.exports()
