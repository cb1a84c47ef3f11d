"""Seconds a file spends in the runner's statistics drain (stage
`stats_finish`: the device states to the host, the host partials added,
the summaries and length histograms), mean over the window's untraced
jobs."""


def read(run):
    v = [j.stages["stats_finish"] for j in run.timed_jobs()
         if "stats_finish" in j.stages]
    return sum(v) / len(v) if v else None
