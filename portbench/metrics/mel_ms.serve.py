"""Median mel of a served GAN-DES sample (ms): the program's ``mel`` spans
(the int16 round trip of the sample's audio and ``melspectrogram_db_tensor``
on it: K2's power mel and the dB scale, host wall) inside the traced
stretch."""

from portbench import spans


def read(run):
    return spans.median_ms(run, "mel")
