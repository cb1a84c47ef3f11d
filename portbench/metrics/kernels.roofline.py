"""The seven hand kernels' share of their roofline in the traced stretch:
the sum over their launches of the least time the card could take (work.py,
from each launch's own arguments) over the sum of their device time in the
trace, in percent."""


def read(run):
    t = run.trace
    if not t or not t["kernel_s"] or not t["bound_s"]:
        return None
    return 100.0 * t["bound_s"] / t["kernel_s"]
