"""Host seconds spent issuing the step's device work (runner stage
`dispatch`) per gigabase, over the window's untraced jobs."""


def read(run):
    jobs = run.timed_jobs()
    bases = sum(j.bases for j in jobs)
    if not bases or not any("dispatch" in j.stages for j in jobs):
        return None
    return sum(j.stages.get("dispatch", 0.0) for j in jobs) / (bases / 1e9)
