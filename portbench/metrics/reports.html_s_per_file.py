"""Seconds a file spends writing the HTML report (processor span
`report_html`, inside `reports`), mean over the window's untraced jobs."""


def read(run):
    v = [j.phases["report_html"] for j in run.timed_jobs()
         if "report_html" in j.phases]
    return sum(v) / len(v) if v else None
