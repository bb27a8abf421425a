"""The whole training step's share of the card's float32 peak (%): the step's
operations, counted from its shapes (``portbench/flops.py``), times the
window's steps per second, over 67 TFLOP/s (the steps run without TF32)."""

from portbench import flops


def read(run):
    r = run.readings
    if not r.get("steps") or not r.get("window_s"):
        return None
    return 100.0 * r["step_flops"] * r["steps"] / r["window_s"] / flops.F32_PEAK_FLOPS
