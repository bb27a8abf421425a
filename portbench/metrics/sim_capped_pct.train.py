"""Share of the training sims that stopped at the batch call's record limit
(%): the sums of the ``capped`` and ``sims`` attributes of the program's
``des.batch`` spans inside the traced stretch. A program whose spans carry
no ``capped`` reads None."""

from portbench import spans


def read(run):
    found = [s for s in spans.in_window(run, "des.batch") or () if "capped" in s.attrs]
    sims = sum(s.attrs.get("sims", 0) for s in found)
    if not sims:
        return None
    return 100.0 * sum(s.attrs["capped"] for s in found) / sims
