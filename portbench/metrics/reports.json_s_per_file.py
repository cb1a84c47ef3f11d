"""Seconds a file spends writing the JSON report (processor span
`report_json`, inside `reports`), mean over the window's untraced jobs."""


def read(run):
    v = [j.phases["report_json"] for j in run.timed_jobs()
         if "report_json" in j.phases]
    return sum(v) / len(v) if v else None
