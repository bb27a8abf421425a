"""Median host stage of a training step (ms): the loop's own ``StepTimer``
phase ``host_des`` (G forward, the DES batch and the roll decode) over the
window's steps, in the traced run (``cfg.profile``)."""

import numpy as np


def read(run):
    samples = run.readings.get("host_des_s")
    return float(np.median(samples)) * 1e3 if samples else None
