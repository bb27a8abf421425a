"""Median train step (ms): the loop's ``StepTimer`` phase ``device_step``
(the captured D update and G loss, waited for under ``cfg.profile``) over the
window's steps, in the traced run."""

import numpy as np


def read(run):
    samples = run.readings.get("device_step_s")
    return float(np.median(samples)) * 1e3 if samples else None
