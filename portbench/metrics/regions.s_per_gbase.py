"""Host seconds of the step's region stage (span `step.regions`: the
quality cumsum, both region scans, break_slots and mask_slots) per
gigabase, over the window's untraced jobs; None where no job has the
span (neither -b nor -N)."""


def read(run):
    jobs = run.timed_jobs()
    bases = sum(j.bases for j in jobs)
    if not bases or not any("step.regions" in j.stages for j in jobs):
        return None
    return sum(j.stages.get("step.regions", 0.0) for j in jobs) / (
        bases / 1e9)
