"""Mean time a request spends outside ``GenerationService.generate`` (ms): the
client's latency minus the reply's own ``latency_s``, over the window's
requests that were answered."""

import numpy as np


def read(run):
    pairs = [(c, s) for c, s in zip(run.readings.get("latencies", []),
                                    run.readings.get("server_latencies", [])) if s is not None]
    return float(np.mean([c - s for c, s in pairs])) * 1e3 if pairs else None
