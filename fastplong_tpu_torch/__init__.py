"""fastplong_tpu_torch: the PyTorch/CUDA port of fastplong_tpu.

The headline trim-and-filter path, with break and N-mask (-b, -N),
adapter auto-detection, split output and adapters of any length, runs on
an NVIDIA GPU through seven hand-written CUDA kernels (csrc/: the adapter
mismatch scan, the Myers verify, the seed scan, the statistics reduction,
the low-quality region scan, the k-mer histogram of auto-detection and
the block-scan Myers form for adapters longer than 640 bp); the host
layer (FASTQ I/O, batching, reports) is the same as the JAX package's.
Public entry points:

    from fastplong_tpu_torch.main import main          # CLI (also --profile,
                                                       # --prewarm, --num_hosts)
    from fastplong_tpu_torch.config import Options     # programmatic config
    from fastplong_tpu_torch.processor import process  # run a configured job
    from fastplong_tpu_torch.parallel import main      # every FASTQ of a folder
    from fastplong_tpu_torch.merge_reports import main # offline --num_hosts merge
    from fastplong_tpu_torch.models import Read, ReadPair, Sequence
    from fastplong_tpu_torch.daemon import serve       # warm daemon
                                                       # (FASTPLONG_DAEMON=1)
    from fastplong_tpu_torch.edbench import main       # Myers self-benchmark

Every CLI flag of fastplong_tpu.main is served, --devices N among them
(pipeline/sharding.py: the step data-parallel over N cards' row slices,
or N slices on the host with the CPU).

Device rule: every entry point runs on CUDA unless the caller asks for the
CPU (`device="cpu"`, or FASTPLONG_TORCH_DEVICE=cpu for the CLI).  There is
no silent move to the CPU: asking for CUDA without a card is an error.
"""

import os

from .common import VERSION
from .models import Read, ReadPair, Sequence

__version__ = VERSION

DEVICE_ENV = "FASTPLONG_TORCH_DEVICE"


def resolve_device(device=None):
    """The torch.device a run uses: `device` when given, else the
    FASTPLONG_TORCH_DEVICE environment variable, else "cuda".  Raises
    RuntimeError when CUDA is asked for and no card is available."""
    import torch
    name = device if device is not None else os.environ.get(DEVICE_ENV,
                                                            "cuda")
    dev = torch.device(name)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("unsupported device %r: use cuda or cpu" % name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is false; "
            "set %s=cpu (or pass device='cpu') to run on the CPU"
            % DEVICE_ENV)
    return dev
