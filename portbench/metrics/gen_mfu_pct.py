"""A request's share of the card's float32 peak (%): the operations of G's
forward and, for GAN-DES, of the mel (counted from shapes,
``portbench/flops.py``), summed over the window's requests, over the
window's time and 67 TFLOP/s."""

from portbench import flops


def read(run):
    r = run.readings
    if not r.get("latencies") or not r.get("window_s"):
        return None
    if r["model"] == "mmgan":
        total = flops.mmgan_generators(r["n"]) * len(r["latencies"])
    else:
        total = sum(flops.dcgan_generator(r["n"]) + r["n"] * flops.mel_work(b)[0]
                    for b in r["buckets"])
    return 100.0 * total / r["window_s"] / flops.F32_PEAK_FLOPS
