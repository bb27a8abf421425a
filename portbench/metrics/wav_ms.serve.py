"""Median WAV work of a served GAN-DES request (ms): each request's ``wav``
spans summed (the program's WAV file built from the audio, and its base64
text for the reply), over the requests whose ``request`` span lies inside
the traced stretch."""

import numpy as np

from portbench import spans


def read(run):
    requests = spans.in_window(run, "request")
    if not requests:
        return None
    per_request = dict.fromkeys((s.trace_id for s in requests), 0)
    for s in spans.in_window(run, "wav"):
        if s.trace_id in per_request:
            per_request[s.trace_id] += s.end_ns - s.start_ns
    found = [ns for ns in per_request.values() if ns]
    return float(np.median(found)) * 1e-6 if found else None
