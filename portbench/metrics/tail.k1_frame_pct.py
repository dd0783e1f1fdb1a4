"""Share of the window's frames whose tail and final pass ran in kernel K1
(the k1.launches counter of shaderflow_tpu_torch.tracing, K1's u8 and
planes forms, over the frames counter), in percent. A port without the
counters reports nothing."""

from portbench.harness.program import of, window_session

# The port's session over a traced run's window (harness/program.py)
SPANS = window_session()


def read(trace):
    program = of(trace)
    frames = program.total("frames") if program is not None else 0
    if not frames:
        return None
    return 100.0 * program.total("k1.launches") / frames
