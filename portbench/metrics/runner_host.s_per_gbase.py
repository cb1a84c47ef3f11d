"""Host seconds of the runner per gigabase: its stages read_parse, pack,
accumulate, emit, writer_close and stats_finish, summed over the window's
untraced jobs, over their input bases."""

STAGES = ("read_parse", "pack", "accumulate", "emit", "writer_close",
          "stats_finish")


def read(run):
    jobs = run.timed_jobs()
    bases = sum(j.bases for j in jobs)
    if not bases:
        return None
    return sum(j.stages.get(s, 0.0) for j in jobs for s in STAGES) / (
        bases / 1e9)
