"""The port's single-file multi-host mode (--num_hosts/--host_index,
fastplong_tpu_torch.multihost and merge_reports) against the JAX
package's, on the CPU: record alignment, shard outputs, the offline merge,
the refusals, and a two-process torch.distributed (gloo) merge."""

import gzip
import io
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np
import pytest

from fastplong_tpu import multihost as jax_mh
from fastplong_tpu_torch import multihost as torch_mh
from golden_util import norm_html, strip_command, write_random_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = "AATGTACTTCGTTCAGTTACGTATTGCT"
ARGS = ["-s", START, "-x", "--cut_front", "--cut_tail"]


def _read(path, mode="rb"):
    with open(path, mode) as f:
        return f.read()


# ------------------------------------------------------------ record ranges

def _ambiguous_file(path):
    """tests/test_multihost.py's file of quality lines made of '@'."""
    recs = []
    for i in range(50):
        seq = "ACGTACGTACGTACGTACGT"
        recs.append("@r%d\n%s\n+\n%s\n" % (i, seq, "@" * len(seq)))
    with open(path, "w") as f:
        f.write("".join(recs))


def _fuzz_file(path):
    """tests/test_multihost.py's adversarial file: quality lines that start
    with '@' or '+' and collide in length, comments on the '+' line."""
    rng = np.random.default_rng(123)
    recs = []
    for i in range(300):
        n = int(rng.integers(5, 80))
        seq = "".join(rng.choice(list("ACGTN"), size=n))
        first = rng.choice(["@", "+", "A"])
        qual = first + "".join(
            chr(int(q)) for q in rng.integers(33, 74, size=n - 1))
        strand = "+" if rng.random() < 0.7 else "+comment here"
        recs.append("@r%d x\n%s\n%s\n%s\n" % (i, seq, strand, qual))
    with open(path, "w") as f:
        f.write("".join(recs))


@pytest.mark.parametrize("make", [_ambiguous_file, _fuzz_file],
                         ids=["ambiguous_at", "fuzz"])
def test_ranges_match_jax(make, tmp_path):
    p = str(tmp_path / "f.fq")
    make(p)
    size = os.path.getsize(p)
    for pos in range(-1, size + 2, 3):
        assert (torch_mh.align_to_record(p, pos)
                == jax_mh.align_to_record(p, pos)), pos
    for n in range(1, 7):
        got = [torch_mh.compute_range(p, n, i) for i in range(n)]
        assert got == [jax_mh.compute_range(p, n, i) for i in range(n)]
        assert got[0][0] == 0 and got[-1][1] == size
        assert all(a[1] == b[0] for a, b in zip(got, got[1:]))


def test_host_prefixed_matches_jax():
    for path in ("", "out.fq", "/a/b/out.fq.gz", "rel/dir/r.json"):
        for i in (0, 1, 11):
            assert (torch_mh.host_prefixed(path, i)
                    == jax_mh.host_prefixed(path, i))


# ------------------------------------------------------------ shard runs

def _jax_main(argv):
    from fastplong_tpu.main import main
    main(["fastplong"] + argv)


def _torch_main(argv):
    from fastplong_tpu_torch.main import main
    assert main(["fastplong"] + argv) == 0


def _io(d, tag):
    return ["-o", os.path.join(d, tag + ".fq"),
            "--failed_out", os.path.join(d, tag + "_failed.fq"),
            "-j", os.path.join(d, tag + ".json"),
            "-h", os.path.join(d, tag + ".html")]


def _hosts(n, i):
    return ["--num_hosts", str(n), "--host_index", str(i)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The input; the JAX single run ("s"); JAX two-host shards ("j") with
    the JAX offline merge; the port's two-host shards ("m") with the
    port's offline merge."""
    old = os.environ.get("FASTPLONG_TORCH_DEVICE")
    os.environ["FASTPLONG_TORCH_DEVICE"] = "cpu"
    try:
        d = str(tmp_path_factory.mktemp("mh"))
        fq = write_random_fastq(os.path.join(d, "in.fq"), n_reads=300,
                                min_len=30, max_len=700, seed=42,
                                adapter_start=START, adapter_prob=0.4,
                                polya_prob=0.3)
        _jax_main(["-i", fq] + _io(d, "s") + ARGS)
        for i in (0, 1):
            _jax_main(["-i", fq] + _io(d, "j") + _hosts(2, i) + ARGS)
            _torch_main(["-i", fq] + _io(d, "m") + _hosts(2, i) + ARGS)
        from fastplong_tpu.merge_reports import main as jax_merge
        from fastplong_tpu_torch.merge_reports import main as torch_merge
        assert jax_merge(["merge"] + [os.path.join(d, "j.json.part%d" % i)
                                      for i in (0, 1)]) == 0
        assert torch_merge(["merge"] + [os.path.join(d, "m.json.part%d" % i)
                                        for i in (0, 1)]) == 0
    finally:
        if old is None:
            os.environ.pop("FASTPLONG_TORCH_DEVICE", None)
        else:
            os.environ["FASTPLONG_TORCH_DEVICE"] = old
    return d, fq


def test_two_host_shards_equal_jax_single_run(runs):
    d, _ = runs
    for tag in ("", "_failed"):
        cat = b"".join(_read(os.path.join(d, "%04d.m%s.fq" % (i + 1, tag)))
                       for i in (0, 1))
        assert cat == _read(os.path.join(d, "s%s.fq" % tag)), tag
        # and each shard equals JAX's shard
        for i in (0, 1):
            assert (_read(os.path.join(d, "%04d.m%s.fq" % (i + 1, tag)))
                    == _read(os.path.join(d, "%04d.j%s.fq" % (i + 1, tag))))
    # both shards did work
    assert all(os.path.getsize(os.path.join(d, "%04d.m.fq" % (i + 1)))
               for i in (0, 1))


def test_shard_reports_match_jax(runs):
    d, _ = runs
    for i in (0, 1):
        p = "%04d." % (i + 1)
        assert (strip_command(_read(os.path.join(d, p + "m.json"), "r"))
                == strip_command(_read(os.path.join(d, p + "j.json"), "r")))
        assert (norm_html(_read(os.path.join(d, p + "m.html"), "r"))
                == norm_html(_read(os.path.join(d, p + "j.html"), "r")))


def test_offline_merge_equals_jax_single_run(runs):
    d, _ = runs
    assert (strip_command(_read(os.path.join(d, "m.json"), "r"))
            == strip_command(_read(os.path.join(d, "s.json"), "r")))


def test_offline_merged_html_equals_jax_merged_html(runs):
    d, _ = runs
    assert (norm_html(_read(os.path.join(d, "m.html"), "r"))
            == norm_html(_read(os.path.join(d, "j.html"), "r")))


class _Modules(pickle.Unpickler):
    def __init__(self, data):
        super().__init__(io.BytesIO(data))
        self.modules = set()

    def find_class(self, module, name):
        self.modules.add(module)
        return super().find_class(module, name)


def test_partial_holds_no_torch_object(runs):
    """A partial is merged on any host: it may reference numpy and the
    port's option classes, never a tensor or a torch.device."""
    d, _ = runs
    for i in (0, 1):
        u = _Modules(_read(os.path.join(d, "m.json.part%d" % i)))
        payload = u.load()
        assert not [m for m in u.modules
                    if m.split(".")[0] not in ("numpy", "fastplong_tpu_torch",
                                               "builtins", "collections")]
        assert payload["opt"].byte_range is not None


def test_merge_reports_usage(capsys):
    from fastplong_tpu_torch.merge_reports import main as torch_merge
    assert torch_merge(["merge"]) == 1
    assert "fastplong_tpu_torch.merge_reports" in capsys.readouterr().err


# ------------------------------------------------------------ refusals

def _refusals(tmp_path):
    fq = write_random_fastq(str(tmp_path / "in.fq"), n_reads=10,
                            min_len=30, max_len=60, seed=1)
    gz = str(tmp_path / "in.fq.gz")
    with open(fq, "rb") as f, gzip.open(gz, "wb") as g:
        g.write(f.read())
    disguised = str(tmp_path / "gz_inside.fq")
    with open(gz, "rb") as f, open(disguised, "wb") as g:
        g.write(f.read())
    out = ["-o", str(tmp_path / "o.fq")]
    return {
        "gzip": ["-i", gz] + out + _hosts(2, 0),
        "gzip_magic": ["-i", disguised] + out + _hosts(2, 1),
        "split": ["-i", fq] + out + _hosts(2, 0) + ["--split", "3"],
        "index_high": ["-i", fq] + out + _hosts(2, 5),
        "index_negative": ["-i", fq] + out + ["--num_hosts", "2",
                                              "--host_index=-1"],
        "stdin": ["--stdin"] + out + _hosts(2, 0),
    }


@pytest.mark.parametrize("case", ["gzip", "gzip_magic", "split",
                                  "index_high", "index_negative", "stdin"])
def test_refusals_match_jax(case, tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
    monkeypatch.delenv("FASTPLONG_COORDINATOR", raising=False)
    argv = _refusals(tmp_path)[case]
    got = []
    for run in (_jax_main, _torch_main):
        with pytest.raises(SystemExit) as e:
            run(argv)
        got.append((e.value.code, capsys.readouterr().err))
    assert got[0] == got[1]
    assert got[1][0] != 0 and got[1][1].startswith("ERROR: "), got[1]
    assert not os.path.exists(tmp_path / "0001.o.fq")


# ------------------------------------------------------ torch.distributed

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _host_env(**extra):
    # one CPU thread a host, so that the hosts do not crowd the other
    # test workers' cores
    env = dict(os.environ, FASTPLONG_TORCH_DEVICE="cpu", PYTHONPATH=REPO,
               OMP_NUM_THREADS="1",
               FASTPLONG_COORDINATOR="127.0.0.1:%d" % _free_port())
    env.update(extra)
    return env


def _host_cmd(fq, d, i):
    return ([sys.executable, "-m", "fastplong_tpu_torch.main", "-i", fq]
            + _io(d, "g") + _hosts(2, i) + ARGS)


def test_gloo_two_processes_write_merged_report(runs, tmp_path):
    """Two host processes joined by FASTPLONG_COORDINATOR: host 0 writes
    the merged JSON and HTML to the unprefixed paths."""
    d, fq = runs
    out = str(tmp_path)
    env = _host_env()
    procs = [subprocess.Popen(_host_cmd(fq, out, i), env=env, cwd=out,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for i in (0, 1)]
    try:
        outs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err.decode()[-3000:]
    assert (strip_command(_read(os.path.join(out, "g.json"), "r"))
            == strip_command(_read(os.path.join(d, "s.json"), "r")))
    assert (norm_html(_read(os.path.join(out, "g.html"), "r"))
            == norm_html(_read(os.path.join(d, "m.html"), "r")))
    cat = b"".join(_read(os.path.join(out, "%04d.g.fq" % (i + 1)))
                   for i in (0, 1))
    assert cat == _read(os.path.join(d, "s.fq"))


def test_gloo_lost_peer_fails_the_run(runs, tmp_path):
    """Host 1 alone: it cannot meet host 0, so it fails within the
    configured timeout instead of hanging, and writes no shard."""
    _, fq = runs
    out = str(tmp_path)
    env = _host_env(FASTPLONG_COORDINATOR_TIMEOUT="3")
    t0 = time.monotonic()
    r = subprocess.run(_host_cmd(fq, out, 1), env=env, cwd=out,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert "did not meet" in r.stderr, r.stderr[-3000:]
    assert time.monotonic() - t0 < 100
    assert not os.path.exists(os.path.join(out, "0002.g.fq"))
