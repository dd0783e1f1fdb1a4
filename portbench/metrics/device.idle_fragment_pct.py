"""Share of the traced stretch's idle device time in which the host's
innermost span of the port is `fragment`, in percent (the port's spans
put on the device trace's clock, harness/program.py)."""

from portbench.harness.program import of, window_session

# The port's session over a traced run's window (harness/program.py)
SPANS = window_session()


def read(trace):
    program = of(trace)
    idle = sum(program.idle.values()) if program is not None else 0.0
    if idle <= 0:
        return None
    return 100.0 * program.idle.get("fragment", 0.0) / idle
