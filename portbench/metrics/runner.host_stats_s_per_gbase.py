"""Host seconds of the statistics of reads over the device's cap (runner
stage `host_stats`, inside `accumulate`) per gigabase of input, summed
over the window's untraced jobs over their input bases; nothing to read
where no job's dump has the stage."""


def read(run):
    jobs = run.timed_jobs()
    bases = sum(j.bases for j in jobs)
    if not bases or not any("host_stats" in j.stages for j in jobs):
        return None
    return sum(j.stages.get("host_stats", 0.0) for j in jobs) / (
        bases / 1e9)
