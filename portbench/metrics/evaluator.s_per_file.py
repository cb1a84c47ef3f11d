"""Seconds a file spends in the evaluator's pre-passes (processor phase
`evaluator`: the prefix read, auto-detection's k-mer fill, top key and
extension), mean over the window's untraced jobs of a configuration that
auto-detects."""


def read(run):
    if not any(j.evaluator for j in run.timed_jobs()):
        return None
    v = [j.phases["evaluator"] for j in run.timed_jobs()]
    return sum(v) / len(v) if v else None
