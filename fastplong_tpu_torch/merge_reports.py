"""Offline multi-host report merge of the PyTorch/CUDA port.

    python -m fastplong_tpu_torch.merge_reports out.json.part0 out.json.part1 ...

Loads the stats partials written by the port's --num_hosts runs (in host
order), merges them (Stats::merge analog, src/stats.cpp:1013-1082) and
writes the final JSON/HTML report to the unprefixed paths of the original
command.  Use when the hosts share (or copied their partials to) a
filesystem and no FASTPLONG_COORDINATOR was configured.  A partial holds
the port's pickled Options, so only this module merges it, not
fastplong_tpu.merge_reports.  Runs on the host alone: it touches no card.
"""

import sys

from .multihost import merge_partial_blobs, write_merged_reports


def main(argv=None):
    argv = sys.argv if argv is None else argv
    parts = argv[1:]
    if not parts:
        sys.stderr.write(__doc__)
        return 1
    blobs = []
    for p in parts:
        with open(p, "rb") as f:
            blobs.append(f.read())
    opt, pre, post, fr = merge_partial_blobs(blobs)
    opt.json_file = opt.json_file_base or opt.json_file
    opt.html_file = opt.html_file_base or opt.html_file
    write_merged_reports(opt, pre, post, fr)
    sys.stderr.write("JSON report: %s\nHTML report: %s\n"
                     % (opt.json_file, opt.html_file))
    return 0


if __name__ == "__main__":
    sys.exit(main())
