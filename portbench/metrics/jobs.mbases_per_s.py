"""The rate of the window's untraced jobs: their input bases over their
walls on the host clock, in Mbases/s.  It stands where the cell's rate
spreads too widely from run to run for an end-to-end bound: the host's
CPU speed drifts between runs, and the cell's work is the host's."""


def read(run):
    jobs = run.timed_jobs()
    wall = sum(j.wall for j in jobs)
    return sum(j.bases for j in jobs) / wall / 1e6 if wall > 0 else None
