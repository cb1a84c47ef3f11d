"""The port's edit-distance micro-benchmark (fastplong_tpu_torch/edbench.py)
against fastplong_tpu/edbench.py on the CPU: the same lines once the
timing is taken out, the same exit code on a pass and on a failed vector,
and distances equal to the JAX package's host DP oracle."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from fastplong_tpu import edbench as jax_edbench
from fastplong_tpu.ops.myers import edit_distance_host
from fastplong_tpu_torch import edbench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMING = re.compile(r"^test \d+ edit_distance calls, takes \d+ ms "
                    r"\(\d+\.\d M calls/s\)$")


def _lines(out):
    """stdout with each timing line reduced to its form."""
    lines = out.splitlines()
    assert lines, "no output"
    return ["TIMING" if TIMING.match(ln) else ln for ln in lines]


# (name, index of EXPECTED to falsify or None)
CASES = [("all_pass", None), ("second_vector_fails", 1)]


@pytest.mark.parametrize("name,wrong", CASES, ids=[c[0] for c in CASES])
def test_lines_and_exit_code_match_jax(name, wrong, capsys, monkeypatch):
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
    if wrong is not None:
        for mod in (jax_edbench, edbench):
            expected = list(mod.EXPECTED)
            expected[wrong] += 1
            monkeypatch.setattr(mod, "EXPECTED", expected)
    rc_jax = jax_edbench.main()
    out_jax = capsys.readouterr().out
    # the plain Myers takes about a second a call on the CPU: one timed
    # launch per vector
    rc_port = edbench.main(n_calls=1)
    out_port = capsys.readouterr().out
    assert rc_port == rc_jax == (0 if wrong is None else 1)
    assert _lines(out_port) == _lines(out_jax)
    assert _lines(out_port).count("TIMING") == (3 if wrong is None
                                                else wrong + 1)


def test_distances_equal_host_dp():
    from fastplong_tpu_torch.ops.myers import myers_verify, pattern_table
    for a, b, want in zip(edbench.STR1, edbench.STR2, edbench.EXPECTED):
        text = torch.from_numpy(
            np.frombuffer(b.encode(), np.uint8).copy()).expand(4, -1)
        d = myers_verify(pattern_table(a.encode()),
                         torch.full((4,), len(a), dtype=torch.int32),
                         text.contiguous(),
                         torch.full((4,), len(b), dtype=torch.int32))
        assert d.tolist() == [edit_distance_host(a.encode(), b.encode())] * 4
        assert d[0] == want


def test_without_card_stops_like_the_cli():
    """Asking for CUDA where there is none stops with the CLI's message
    and exit code; the run never moves to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: edbench runs on it")
    env = dict(os.environ, FASTPLONG_TORCH_DEVICE="cuda")
    r = subprocess.run([sys.executable, "-m", "fastplong_tpu_torch.edbench"],
                       capture_output=True, text=True, timeout=120, env=env,
                       cwd=REPO)
    assert r.returncode == 255
    assert r.stderr.startswith("ERROR: CUDA was requested")
    assert r.stdout == ""
