"""Share of the served sims that their wall budget cut (%): the sum of the
``budget_cut`` attributes of the program's ``des`` spans (one sim's run,
the increment of its counter ``sims_budget_cut``) over those spans, inside
the traced stretch. A program whose spans carry no ``budget_cut`` reads
None."""

from portbench import spans


def read(run):
    found = [s for s in spans.in_window(run, "des") or () if "budget_cut" in s.attrs]
    if not found:
        return None
    return 100.0 * sum(s.attrs["budget_cut"] for s in found) / len(found)
