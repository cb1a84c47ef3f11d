"""The comparison that decides `correct`: what the program produced in the
window against the plain reference, job by job.

Each number compared has its limit (LIMITS): the guarantee is exact output,
so every limit is 0.  A job's numbers:

* stream_records_differing: records of the passing-read stream that differ
  from the reference's, position by position, plus the difference in their
  counts;
* report_fields_differing: fields of the JSON report (summary before and
  after filtering, total cycles, filtering result, adapter cutting, polyX
  trimming) that differ from the reference's;
* adapters_differing: read_start_adapter and read_end_adapter in the report
  that differ from the adapters the reference detects (or was given);
* jobs_failed: jobs that raised or returned another code than 0;
* jobs_unchecked: jobs whose input the reference does not model (it raises
  NotModelled), so that nothing was compared.
"""

import json

from portbench.reference import NotModelled

LIMITS = {"stream_records_differing": 0, "report_fields_differing": 0,
          "adapters_differing": 0, "jobs_failed": 0, "jobs_unchecked": 0}


def records(stream):
    lines = stream.split(b"\n")
    return [b"\n".join(lines[i:i + 4]) for i in range(0, len(lines) - 1, 4)]


def records_differing(got, want):
    if got == want:
        return 0, None
    a, b = records(got), records(want)
    bad = [i for i in range(min(len(a), len(b))) if a[i] != b[i]]
    first = None
    if bad:
        i = bad[0]
        first = "record %d: program %r, reference %r" % (
            i, a[i][:160], b[i][:160])
    elif len(a) != len(b):
        first = "program %d records, reference %d" % (len(a), len(b))
    return len(bad) + abs(len(a) - len(b)), first


def _node(js, dotted):
    node = js
    for part in dotted.split("."):
        node = node[part]
    return node


def report_differing(text, want):
    """(fields differing, first difference) of a JSON report's text against
    the reference's fields."""
    try:
        js = json.loads(text)
    except (TypeError, ValueError) as e:
        return sum(len(v) if isinstance(v, dict) else 1
                   for v in want.values()), "report unreadable: %s" % e
    n, first = 0, None
    for key, value in want.items():
        if key == "adapter_cutting":
            value = {k: v for k, v in value.items()
                     if k not in ("read_start_adapter", "read_end_adapter")}
        items = value.items() if isinstance(value, dict) else [(None, value)]
        for sub, v in items:
            try:
                got = _node(js, key)
                if sub is not None:
                    got = got[sub]
            except (KeyError, TypeError):
                got = "<absent>"
            if got != v:
                n += 1
                if first is None:
                    first = "%s%s: program %r, reference %r" % (
                        key, "" if sub is None else "." + sub, got, v)
    return n, first


def adapters_differing(text, want):
    try:
        ac = json.loads(text)["adapter_cutting"]
        got = (ac["read_start_adapter"], ac["read_end_adapter"])
    except (TypeError, ValueError, KeyError):
        got = (None, None)
    n = sum(g != w for g, w in zip(got, want))
    return n, (None if not n else "program %r, reference %r" % (got, want))


def compare(jobs, expected_of):
    """Sum each number over the jobs; expected_of(job) is the reference's
    result for the job's input file.  Returns (numbers, notes)."""
    numbers = dict.fromkeys(LIMITS, 0)
    notes = []
    for j in jobs:
        if j.failed:
            numbers["jobs_failed"] += 1
            notes.append("job %d (%s) failed: %s" % (j.index, j.name,
                                                     j.error))
            continue
        try:
            want = expected_of(j)
        except NotModelled as e:
            numbers["jobs_unchecked"] += 1
            notes.append("job %d (%s) not checked: %s" % (j.index, j.name, e))
            continue
        for key, (n, first) in (
                ("stream_records_differing",
                 records_differing(j.stream, want["stream"])),
                ("report_fields_differing",
                 report_differing(j.report, want["report"])),
                ("adapters_differing",
                 adapters_differing(j.report, want["adapters"])
                 if "adapter_cutting" in want["report"] else (0, None))):
            numbers[key] += n
            if first and len(notes) < 12:
                notes.append("job %d (%s) %s: %s" % (j.index, j.name, key,
                                                     first))
    return numbers, notes


def is_correct(numbers):
    return all(numbers[k] <= LIMITS[k] for k in LIMITS)
