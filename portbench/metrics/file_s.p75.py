"""Wall seconds of one file's job (main() in process), the 75th percentile
over the window's untraced jobs: the highest percentile with about ten jobs
beyond it at 30 to 50 jobs a window."""

import statistics


def read(run):
    walls = [j.wall for j in run.timed_jobs()]
    if len(walls) < 4:
        return None
    return statistics.quantiles(walls, n=4)[2]
