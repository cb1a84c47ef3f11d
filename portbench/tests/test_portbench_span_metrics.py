"""The arithmetic of the metrics that read the port's spans (the report
and statistics-drain spans of a job's TIMER_DUMP) on recorded dumps, and
what each reads where a dump lacks its span."""

import pytest

from portbench import harness

# a job's TIMER_DUMP as the port writes it, with its spans inside the
# phases and stages (reports holds the summaries, JSON and HTML;
# stats_finish its fetch and summaries)
DUMP = {"phase_seconds": {"job": 1.6, "evaluator": 0.35,
                          "runner_init": 0.01, "runner_run": 0.8,
                          "reports": 0.4, "report_summary": 0.01,
                          "report_json": 0.15, "report_html": 0.22},
        "stage_seconds": {"read_parse": 0.1, "pack": 0.05, "dispatch": 0.2,
                          "step": 0.18, "device_wait": 0.01,
                          "accumulate": 0.02,
                          "emit": 0.08, "writer_close": 0.01,
                          "stats_finish": 0.04, "stats_fetch": 0.003,
                          "stats_summarize": 0.03, "total_loop": 0.5}}

NAMES = ("reports.json_s_per_file", "reports.html_s_per_file",
         "runner.stats_finish_s_per_file")


def job(i, bases, scale=1.0, traced=False, failed=False, drop=()):
    j = harness.Job(i, "in%02d.fq" % i, bases)
    j.wall = 1.0
    j.phases = {k: v * scale for k, v in DUMP["phase_seconds"].items()
                if k not in drop}
    j.stages = {k: v * scale for k, v in DUMP["stage_seconds"].items()
                if k not in drop}
    j.traced = traced
    j.failed = failed
    return j


@pytest.fixture
def cell(tiny_root):
    return harness.Cell("headline_3h.tiny", root=tiny_root)


def read(cell, name, run):
    return cell.metric_reader(name)(run)


def test_span_metrics(cell):
    """Means per file over the untraced jobs that ran."""
    jobs = [job(0, 30_000_000), job(1, 30_000_000, scale=2.0),
            job(2, 30_000_000, scale=50.0, traced=True),
            job(3, 40_000_000, scale=3.0, failed=True),
            job(4, 20_000_000, scale=0.5)]
    run = harness.RunData(jobs, None)
    assert {m["name"] for m in cell.per_layer} >= set(NAMES)
    assert read(cell, "reports.json_s_per_file", run) == pytest.approx(
        0.15 * 3.5 / 3)
    assert read(cell, "reports.html_s_per_file", run) == pytest.approx(
        0.22 * 3.5 / 3)
    assert read(cell, "runner.stats_finish_s_per_file",
                run) == pytest.approx(0.04 * 3.5 / 3)


def test_span_metrics_where_a_job_lacks_the_span(cell):
    """A job whose dump lacks a span is left out of a per-file mean."""
    jobs = [job(0, 30_000_000),
            job(1, 50_000_000, drop=("report_json", "report_html",
                                     "stats_finish"))]
    run = harness.RunData(jobs, None)
    assert read(cell, "reports.json_s_per_file", run) == pytest.approx(0.15)
    assert read(cell, "reports.html_s_per_file", run) == pytest.approx(0.22)
    assert read(cell, "runner.stats_finish_s_per_file",
                run) == pytest.approx(0.04)


@pytest.mark.parametrize("name,key", [
    ("reports.json_s_per_file", "report_json"),
    ("reports.html_s_per_file", "report_html"),
    ("runner.stats_finish_s_per_file", "stats_finish")])
def test_span_metric_without_its_span_reads_none(cell, name, key):
    """Dumps without the metric's span (a version of the port that lacks
    it) read as None, and so does a window with no untraced job."""
    jobs = [job(0, 30_000_000, drop=(key,)), job(1, 30_000_000, drop=(key,))]
    assert read(cell, name, harness.RunData(jobs, None)) is None
    traced = [job(0, 30_000_000, traced=True)]
    assert read(cell, name, harness.RunData(traced, None)) is None
