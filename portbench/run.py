"""Run one cell of the benchmark of fastplong_tpu_torch.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: `correct`,
`attempted` and `failed` (jobs), `metrics` (the cell's end-to-end metrics,
or with --trace 1 its per-layer metrics), `device`, with --trace 1
`breakdown`, and last `checks` (each number compared, with its limit; also
the last lines of standard error).  Exits with another code than 0, and
prints no result, where there is no CUDA card or fewer cards than the cell
asks for, where the port cannot be imported from this checkout, and where
JAX or the JAX package has been loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from portbench import harness
    try:
        cell = harness.Cell(args.workload)
    except (OSError, KeyError, ValueError) as e:
        harness.log("cannot load the cell: %s" % e)
        return 2
    import torch
    if not torch.cuda.is_available():
        harness.log("no CUDA card (torch.cuda.is_available() is false)")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.log("the cell asks for %d cards, %d visible"
                    % (cell.chips, torch.cuda.device_count()))
        return 2
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda", T_START)
    except ImportError as e:
        harness.log("cannot import the port from this checkout: %s" % e)
        return 3
    bad = harness.forbidden_modules()
    if bad:
        harness.log("JAX or the JAX package was loaded: %s" % ", ".join(bad))
        return 4
    for name, c in result["checks"].items():
        harness.log("check %s = %s (limit %s)" % (name, c["value"],
                                                   c["limit"]))
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
