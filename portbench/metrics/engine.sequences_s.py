"""Host seconds an export spends binding its per-frame device sequences
(the port's `engine.sequences` spans in RenderEngine._refresh_textures:
the piano's roll, keys and channel sequences copied to the card, the
spectrogram's bound where it lies), over the exports begun in the
window. A port without the span reports nothing."""

from portbench.harness.program import of, window_session

# The port's session over a traced run's window (harness/program.py)
SPANS = window_session()


def read(trace):
    program = of(trace)
    if program is None or not program.exports() or \
            not any(span.name == "engine.sequences" for span in program.spans):
        return None
    return program.seconds("engine.sequences") / program.exports()
