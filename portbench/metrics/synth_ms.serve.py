"""Median synth of a served GAN-DES sample (ms): the program's ``synth`` spans
(the additive synth's render of the sample's MIDI on the card, host wall)
inside the traced stretch."""

from portbench import spans


def read(run):
    return spans.median_ms(run, "synth")
