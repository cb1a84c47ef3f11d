"""Seconds a file spends in the reports (processor phase `reports`: the
summaries, JSON and HTML), mean over the window's untraced jobs."""


def read(run):
    v = [j.phases["reports"] for j in run.timed_jobs() if "reports" in j.phases]
    return sum(v) / len(v) if v else None
