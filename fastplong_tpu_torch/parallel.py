"""Folder runner of the PyTorch/CUDA port: preprocess every FASTQ in a
folder, aggregate a summary.

    python -m fastplong_tpu_torch.parallel -i IN_DIR -o OUT_DIR -a "FLAGS"

A copy of fastplong_tpu/parallel.py that runs the port's CLI.  Capability
equivalent of the reference parallel.py (438-line batch script): scans a
directory for .fq/.fastq[.gz] files (skipping Undetermined*), runs the
pipeline per file, and writes an aggregate `overall.html` from the
per-file JSON reports.

Differences from the reference:
  * files are processed in-process and sequentially by default — one
    process owns the card, and every file reuses the one built kernel
    library and the one CUDA context (the reference instead spawns one
    process per file, parallel.py:122); --parallel N restores subprocess
    fan-out (`python -m fastplong_tpu_torch.main` per file).
  * multi-host scale-out shards the FILE LIST across hosts with
    --num_hosts/--host_index (each host produces its own outputs; run the
    aggregation once over the shared report dir afterwards).

The device follows the port's rule: CUDA unless FASTPLONG_TORCH_DEVICE=cpu.
"""

import argparse
import json
import os
import subprocess
import sys

FQ_EXTS = (".fq.gz", ".fastq.gz", ".fq", ".fastq")


def get_base_name(filename):
    for ext in FQ_EXTS:
        if filename.endswith(ext):
            return filename[:-len(ext)]
    return filename


def find_fastqs(folder):
    if not os.path.isdir(folder):
        return []
    out = []
    for f in sorted(os.listdir(folder)):
        path = os.path.join(folder, f)
        if os.path.isdir(path):
            continue
        if not f.endswith(FQ_EXTS):
            continue
        if f.startswith("Undetermined"):
            continue
        out.append(path)
    return out


def build_file_args(path, opts, extra_args):
    argv = ["fastplong", "-i", path]
    if opts.out_dir:
        os.makedirs(opts.out_dir, exist_ok=True)
        prefix = os.path.join(opts.out_dir,
                              os.path.basename(get_base_name(path)))
        argv += ["-o", prefix + ".clean.fastq.gz"]
    report_dir = opts.report_dir or opts.out_dir or opts.input_dir
    os.makedirs(report_dir, exist_ok=True)
    report = os.path.join(report_dir, os.path.basename(path))
    argv += ["--html", report + ".html", "--json", report + ".json"]
    argv += extra_args
    return argv


def process_in_process(argvs):
    from .main import main
    for argv in argvs:
        print("Processing: " + " ".join(argv[1:]))
        main(argv)


def process_subprocesses(argvs, workers):
    from concurrent.futures import ThreadPoolExecutor

    def run_one(argv):
        cmd = [sys.executable, "-m", "fastplong_tpu_torch.main"] + argv[1:]
        print("Running command: " + " ".join(cmd))
        r = subprocess.run(cmd, capture_output=True, text=True)
        return r.stdout

    with ThreadPoolExecutor(max_workers=workers) as ex:
        for fut in [ex.submit(run_one, a) for a in argvs]:
            print(fut.result())


def human_format(num):
    if num >= 1e9:
        return "%.2fG" % (num / 1e9)
    if num >= 1e6:
        return "%.2fM" % (num / 1e6)
    if num >= 1e3:
        return "%.2fK" % (num / 1e3)
    return str(num)


def generate_summary_html(report_dir):
    try:
        json_files = sorted(f for f in os.listdir(report_dir)
                            if f.endswith(".json"))
    except OSError:
        return None
    version = "fastplong-tpu"
    stats = []
    qual_curves = []
    gc_curves = []
    for jf in json_files:
        try:
            with open(os.path.join(report_dir, jf)) as f:
                data = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(data, dict) or not data.get("summary"):
            continue  # unrelated .json in the dir, not a fastplong report
        summary = data.get("summary", {})
        version = "fastplong-tpu " + summary.get("fastplong_version", "")
        before = summary.get("before_filtering", {})
        after = summary.get("after_filtering", {})
        rb = data.get("read_before_filtering", {})
        ra = data.get("read_after_filtering", {})
        name = jf[:-len(".json")]
        qual_curves.append({
            "file": name,
            "before": rb.get("quality_curves", {}).get("mean", []),
            "after": ra.get("quality_curves", {}).get("mean", [])})
        gc_curves.append({
            "file": name,
            "before": rb.get("content_curves", {}).get("GC", []),
            "after": ra.get("content_curves", {}).get("GC", [])})
        stats.append({
            "file": name,
            "total_reads_before": before.get("total_reads", 0),
            "total_reads_after": after.get("total_reads", 0),
            "total_bases_before": before.get("total_bases", 0),
            "total_bases_after": after.get("total_bases", 0),
            "q20_rate_before": before.get("q20_rate", 0) * 100,
            "q20_rate_after": after.get("q20_rate", 0) * 100,
            "q30_rate_before": before.get("q30_rate", 0) * 100,
            "q30_rate_after": after.get("q30_rate", 0) * 100,
            "gc_content_before": before.get("gc_content", 0) * 100,
            "gc_content_after": after.get("gc_content", 0) * 100,
            "html_report": name + ".html"})
    if not stats:
        return None

    rows = []
    for s in stats:
        rows.append(
            "<tr><td>%s</td><td>%s</td><td>%s</td><td>%s</td><td>%s</td>"
            "<td>%.2f%%</td><td>%.2f%%</td><td>%.2f%%</td><td>%.2f%%</td>"
            "<td>%.2f%%</td><td>%.2f%%</td>"
            "<td><a href='%s'>report</a></td></tr>" % (
                s["file"],
                human_format(s["total_reads_before"]),
                human_format(s["total_reads_after"]),
                human_format(s["total_bases_before"]),
                human_format(s["total_bases_after"]),
                s["q20_rate_before"], s["q20_rate_after"],
                s["q30_rate_before"], s["q30_rate_after"],
                s["gc_content_before"], s["gc_content_after"],
                s["html_report"]))

    def curve_traces(curves, key):
        traces = []
        for c in curves:
            traces.append("{y:%s,name:'%s',mode:'lines'}"
                          % (json.dumps(c[key]), c["file"]))
        return "[" + ",".join(traces) + "]"

    html = """<!DOCTYPE html>
<html lang="en"><head><meta charset="UTF-8">
<title>FASTQ Summary Report</title>
<style>
body { font-family: 'Segoe UI', Arial, sans-serif; background: #f8f9fa; padding: 2em; }
table { border-collapse: collapse; width: 100%%; margin-bottom: 2em; background: #fff; }
th, td { border: 1px solid #e1e4e8; padding: 0.6em 1em; text-align: center; }
th { background: #f3f6fa; color: #34495e; }
tr:nth-child(even) { background: #f9fafb; }
.figure { width: 100%%; height: 360px; }
</style>
<script src="https://cdn.plot.ly/plotly-2.32.0.min.js"></script>
</head><body>
<h2>FASTQ Aggregate Summary (%s)</h2>
<table><thead><tr>
<th>File</th><th>Total Reads (Before)</th><th>Total Reads (After)</th>
<th>Total Bases (Before)</th><th>Total Bases (After)</th>
<th>Q20 Rate (Before)</th><th>Q20 Rate (After)</th>
<th>Q30 Rate (Before)</th><th>Q30 Rate (After)</th>
<th>GC Content (Before)</th><th>GC Content (After)</th><th>HTML Report</th>
</tr></thead><tbody>%s</tbody></table>
<h3>Mean quality curves (before filtering)</h3>
<div class='figure' id='qual_before'></div>
<h3>Mean quality curves (after filtering)</h3>
<div class='figure' id='qual_after'></div>
<h3>GC curves (before filtering)</h3>
<div class='figure' id='gc_before'></div>
<h3>GC curves (after filtering)</h3>
<div class='figure' id='gc_after'></div>
<script>
Plotly.newPlot('qual_before', %s, {xaxis:{title:'position',type:'log'},yaxis:{title:'quality'}});
Plotly.newPlot('qual_after', %s, {xaxis:{title:'position',type:'log'},yaxis:{title:'quality'}});
Plotly.newPlot('gc_before', %s, {xaxis:{title:'position',type:'log'},yaxis:{title:'GC ratio'}});
Plotly.newPlot('gc_after', %s, {xaxis:{title:'position',type:'log'},yaxis:{title:'GC ratio'}});
</script>
</body></html>""" % (
        version, "".join(rows),
        curve_traces(qual_curves, "before"), curve_traces(qual_curves, "after"),
        curve_traces(gc_curves, "before"), curve_traces(gc_curves, "after"))

    out_path = os.path.join(report_dir, "overall.html")
    with open(out_path, "w") as f:
        f.write(html)
    print("Summary report: " + out_path)
    return out_path


def main(argv=None):
    p = argparse.ArgumentParser(
        description="use fastplong-tpu to preprocess all FASTQ files within"
                    " a folder")
    p.add_argument("-i", "--input_dir", default=".")
    p.add_argument("-o", "--out_dir", default=None)
    p.add_argument("-r", "--report_dir", default=None)
    p.add_argument("-a", "--args", default=None,
                   help="extra arguments passed to fastplong, quoted")
    p.add_argument("-p", "--parallel", type=int, default=None,
                   help="subprocess fan-out (default: in-process sequential,"
                        " which reuses the built kernel library)")
    p.add_argument("--num_hosts", type=int, default=1)
    p.add_argument("--host_index", type=int, default=0)
    p.add_argument("--no_summary", action="store_true")
    p.add_argument("--summary_only", action="store_true",
                   help="skip processing; (re)generate overall.html from the"
                        " report dir — run once after all hosts finish")
    opts = p.parse_args(argv)

    if opts.summary_only:
        report_dir = opts.report_dir or opts.out_dir or opts.input_dir
        if generate_summary_html(report_dir) is None:
            print("No JSON report found in " + report_dir)
            return 1
        return 0

    files = find_fastqs(opts.input_dir)
    if not files:
        print("No FASTQ file found, do you call the program correctly?")
        print("See -h for help")
        return 1
    files = [f for i, f in enumerate(files)
             if i % opts.num_hosts == opts.host_index]

    extra = opts.args.split() if opts.args else []
    argvs = [build_file_args(f, opts, extra) for f in files]

    if opts.parallel and opts.parallel > 1:
        process_subprocesses(argvs, opts.parallel)
    else:
        process_in_process(argvs)

    if not opts.no_summary and opts.host_index == 0:
        report_dir = opts.report_dir or opts.out_dir or opts.input_dir
        generate_summary_html(report_dir)
        if opts.num_hosts > 1:
            print("Note: with --num_hosts > 1 other hosts may still be "
                  "running; re-run with --summary_only over the shared "
                  "report dir once all hosts finish.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
