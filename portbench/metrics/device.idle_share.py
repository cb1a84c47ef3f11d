"""Share of the traced stretch in which no operation ran on the card: one
minus the union of kernel, copy and fill intervals over the stretch's
wall, in percent."""


def read(run):
    t = run.trace
    if not t or not t["window_s"]:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
