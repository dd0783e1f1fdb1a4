"""Host seconds an export spends in ShaderPiano's whole-export note scan
(the port's `piano.scan` spans: every frame of the clip, every key in
the file's range, the notes in the 4 s lookahead, both smoothers), over
the exports begun in the window. A port without the span reports
nothing."""

from portbench.harness.program import of, window_session

# The port's session over a traced run's window (harness/program.py)
SPANS = window_session()


def read(trace):
    program = of(trace)
    if program is None or not program.exports() or \
            not any(span.name == "piano.scan" for span in program.spans):
        return None
    return program.seconds("piano.scan") / program.exports()
