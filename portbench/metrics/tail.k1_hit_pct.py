"""Share of K1's prepares in the window that found their compiled kernel
in the cache (tailgen.compiled calls less its builds), in percent."""

from portbench.harness.program import of, window_session

# The port's session over a traced run's window (harness/program.py)
SPANS = window_session()


def read(trace):
    program = of(trace)
    prepares = program.total("k1.prepares") if program is not None else 0
    if not prepares:
        return None
    return 100.0 * (prepares - program.total("k1.misses")) / prepares
