"""Share of the traced stretch of the training window in which no operation
ran on the card (%): 100 minus the union of the device intervals over wall
time."""


def read(run):
    trace = run.tracer.trace if run.tracer is not None else None
    if trace is None or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
