"""Readings that the check's limits are set from, for one cell.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3,...

For each seed, in one process: the cell's input files at the cell's own
size; one job of the program per file, through the same entry and flags as
the window, judged by the check against the cell's reference (the sound
readings); then the control, that plain reference with one guarantee of the
configuration broken put in the program's place and judged the same way
(the control's readings).  The control leaves out the middle-adapter
split, the step that a faster program would be tempted to skip; it breaks
the guarantee of exact output.

Prints one JSON line a seed, then one with each number's lower reading
(the largest over the sound runs) and upper reading (the smallest over the
control's runs); --controls N runs the control on the first N seeds only.  Needs a CUDA card, as the benchmark does.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def report_text(report):
    """A JSON report's text holding the reference's compared fields."""
    js = {}
    for key, value in report.items():
        node = js
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return json.dumps(js)


def readings(cell, seed, device, tmp, with_control=True):
    """(sound numbers, control numbers or None, notes) of one seed."""
    from portbench import check, gen, harness
    files, _ = gen.write_files(cell.mix, seed, tmp)
    prog = harness.Program(device, tmp, cell.config["flags"])
    jobs, want, ctl = [], {}, []
    for i, (path, bases) in enumerate(files):
        job = harness.Job(i, os.path.basename(path), bases)
        jobs.append(prog.run(job, path))
    for i, (path, bases) in enumerate(files):
        with open(path, "rb") as f:
            raw = f.read()
        want[jobs[i].name] = cell.expected(raw, device)
        if not with_control:
            continue
        c = cell.expected(raw, device, control="no_middle")
        stand_in = harness.Job(i, jobs[i].name, bases)
        stand_in.stream = c["stream"]
        stand_in.report = report_text(dict(c["report"], **{
            "adapter_cutting": dict(c["report"]["adapter_cutting"],
                                    read_start_adapter=c["adapters"][0],
                                    read_end_adapter=c["adapters"][1])}))
        ctl.append(stand_in)
    sound, notes = check.compare(jobs, lambda j: want[j.name])
    control = (check.compare(ctl, lambda j: want[j.name])[0]
               if with_control else None)
    for f in os.listdir(tmp):
        os.remove(os.path.join(tmp, f))
    return sound, control, notes


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--controls", type=int, default=None,
                    help="run the control on the first N seeds only")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness
    cell = harness.Cell(args.workload)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        harness.log("no CUDA card")
        return 2
    tmp = tempfile.mkdtemp(prefix="portbench-control-")
    lower, upper = {}, {}
    try:
        seeds = [int(s) for s in args.seeds.split(",")]
        for i, seed in enumerate(seeds):
            t0 = time.perf_counter()
            sound, control, notes = readings(
                cell, seed, args.device, tmp,
                args.controls is None or i < args.controls)
            for note in notes:
                harness.log(note)
            for k, v in sound.items():
                lower[k] = max(lower.get(k, v), v)
            for k, v in (control or {}).items():
                upper[k] = min(upper.get(k, v), v)
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "sound": sound, "control": control,
                              "seconds": time.perf_counter() - t0}),
                  flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"workload": cell.name, "lower": lower,
                      "upper": upper}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
