"""The GAN-DES mel stage's share of its roofline (%): the least time of the
mel's work at the card's peaks (``portbench/flops.py::mel_bound_s``, the
function's inputs and outputs, not K2's algorithm) over the device time of
the operations inside the device-side spans of the ``portbench.mel.<samples>``
ranges that the traced run opens around ``melspectrogram_db_tensor``, summed
over the traced requests."""

from portbench import flops


def read(run):
    trace = run.tracer.trace if run.tracer is not None else None
    if trace is None:
        return None
    bound = device = 0.0
    for name, seconds in trace.range_device_s():
        if name.startswith("mel.") and seconds > 0:
            bound += flops.mel_bound_s(int(name.split(".")[1]))
            device += seconds
    return 100.0 * bound / device if device > 0 else None
