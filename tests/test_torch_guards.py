"""Guards of the port: it imports no JAX and nothing of fastplong_tpu, it
runs on CUDA unless the CPU is asked for, and flags whose code is not
ported yet stop with an error naming their ROADMAP item."""

import ast
import glob
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "fastplong_tpu_torch")


def _sources():
    return sorted(glob.glob(os.path.join(PKG, "**", "*.py"), recursive=True)
                  + [os.path.join(REPO, "chip_smoke.py")])


def _forbidden(name):
    return (name == "jax" or name.startswith("jax.") or name == "jaxlib"
            or name == "fastplong_tpu" or name.startswith("fastplong_tpu."))


def test_sources_import_no_jax():
    bad = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += ["%s: %s" % (os.path.relpath(path, REPO), n)
                    for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_everything_loads_no_jax():
    code = """
import glob, importlib, importlib.util, os, sys
for path in glob.glob("fastplong_tpu_torch/**/*.py", recursive=True):
    name = path[:-3].replace(os.sep, ".").replace(".__init__", "")
    if not name.endswith("__main__"):
        importlib.import_module(name)
spec = importlib.util.spec_from_file_location("chip_smoke", sys.argv[1])
spec.loader.exec_module(importlib.util.module_from_spec(spec))
bad = [n for n in sys.modules if n.split(".")[0] in ("jax", "jaxlib",
                                                      "fastplong_tpu")]
print(len([n for n in sys.modules if n.startswith("fastplong_tpu_torch")]))
assert not bad, bad
"""
    r = subprocess.run([sys.executable, "-c", code,
                        os.path.join(REPO, "chip_smoke.py")],
                       capture_output=True, text=True, timeout=300,
                       cwd=REPO)
    assert r.returncode == 0, r.stderr[-3000:]
    assert int(r.stdout.split()[-1]) > 30     # every module was imported


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.delenv("FASTPLONG_TORCH_DEVICE", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _fq(tmp_path):
    fq = tmp_path / "in.fq"
    fq.write_bytes(b"@r1\n" + b"ACGT" * 20 + b"\n+\n" + b"I" * 80 + b"\n")
    return str(fq)


def _argv(tmp_path, *extra):
    return ["fastplong", "-i", _fq(tmp_path), "-o", str(tmp_path / "o.fq"),
            "-j", str(tmp_path / "r.json"), "-h", str(tmp_path / "r.html")
            ] + list(extra)


def test_cli_without_card_fails(tmp_path, no_card, capsys):
    from fastplong_tpu_torch.main import main
    with pytest.raises(SystemExit) as e:
        main(_argv(tmp_path, "-A"))
    assert e.value.code != 0
    assert "CUDA" in capsys.readouterr().err
    assert not (tmp_path / "o.fq").exists()


def test_step_without_card_fails(tmp_path, no_card):
    from fastplong_tpu_torch import resolve_device
    from fastplong_tpu_torch.main import build_parser, options_from_args
    from fastplong_tpu_torch.pipeline.device import (build_fast_step,
                                                     kernel_params)
    from fastplong_tpu_torch.pipeline.runner import SingleEndRunner
    with pytest.raises(RuntimeError):
        resolve_device()
    argv = _argv(tmp_path, "-A")
    opt = options_from_args(build_parser().parse_args(argv[1:]), argv)
    with pytest.raises(RuntimeError):
        SingleEndRunner(opt)
    for device in (None, "cuda"):
        with pytest.raises(RuntimeError):
            build_fast_step(kernel_params(opt), device)
    assert resolve_device("cpu").type == "cpu"
