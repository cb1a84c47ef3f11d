"""The port's warm daemon (fastplong_tpu_torch/daemon.py, FASTPLONG_DAEMON=1)
on the CPU (FASTPLONG_TORCH_DEVICE=cpu): jobs handed to the resident
process give the JAX CLI's bytes, cold and warm; the client imports no
torch; a stale daemon is replaced; an environment that differs falls back
with "daemon unavailable"; concurrent clients queue; build outputs do not
change the code token, an edited source does; the JAX package's daemon
and the port's share a socket directory and both stay up; with no card a
job's error is the in-process run's; a failing job leaves nothing running
and the next job's outputs are exact; a lost reply is never rerun."""

import gzip
import json
import os
import re
import shutil
import socket
import subprocess
import sys
import threading
import time

import pytest

from fastplong_tpu_torch import daemon
from golden_util import run_ours, strip_command, write_random_fastq

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
START = "AATGTACTTCGTTCAGTTACGTATTGCT"
# `python -m fastplong_tpu_torch.main` that reports, as it exits, whether
# anything imported torch in the client
PROBE = ("import atexit, runpy, sys\n"
         "atexit.register(lambda: sys.stderr.write(\n"
         "    'client imported torch: %s\\n' % ('torch' in sys.modules)))\n"
         "runpy.run_module('fastplong_tpu_torch.main', run_name='__main__',\n"
         "                 alter_sys=True)\n")


def _read(p):
    with open(p, "rb") as f:
        return f.read()


@pytest.fixture()
def daemon_env(tmp_path, monkeypatch):
    """An isolated socket directory, jobs on the CPU; every daemon in it
    (the port's and the JAX package's) is shut down after the test."""
    d = tmp_path / "daemon"
    d.mkdir()
    monkeypatch.setenv("FASTPLONG_DAEMON_DIR", str(d))
    monkeypatch.setenv("FASTPLONG_DAEMON", "1")
    monkeypatch.setenv("FASTPLONG_DAEMON_IDLE", "120")
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
    yield str(d)
    daemon.shutdown_daemon()
    if os.path.exists(os.path.join(str(d), "daemon.sock")):
        from fastplong_tpu import daemon as jax_daemon
        jax_daemon.shutdown_daemon()


def _cli(args, env=None, probe=False, module="fastplong_tpu_torch.main"):
    """One client process from the repo root; with probe, the last line
    of its stderr (whether it imported torch) is taken off and returned."""
    cmd = ([sys.executable, "-c", PROBE] if probe
           else [sys.executable, "-m", module])
    r = subprocess.run(cmd + args, capture_output=True, timeout=300,
                       env=dict(os.environ, **(env or {})), cwd=REPO)
    if not probe:
        return r
    head, _, last = r.stderr.rstrip(b"\n").rpartition(b"\n")
    assert last.startswith(b"client imported torch: "), r.stderr[-2000:]
    r.stderr = head + b"\n"
    return r, last.endswith(b"True")


def _io(d):
    d.mkdir()
    return ["-o", str(d / "out.fq"), "--failed_out", str(d / "failed.fq"),
            "-j", str(d / "r.json"), "-h", str(d / "r.html")]


def _same_as(d, jax_outs):
    out_a, failed_a, json_a = jax_outs
    assert _read(str(d / "out.fq")) == _read(out_a)
    assert _read(str(d / "failed.fq")) == _read(failed_a)
    assert (strip_command(_read(str(d / "r.json")).decode())
            == strip_command(_read(json_a).decode()))


def _hello():
    conn, hello = daemon._connect()
    conn.close()
    return hello


def _alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except OSError:
        return False


def _gone(pid, seconds=15):
    deadline = time.time() + seconds
    while time.time() < deadline and _alive(pid):
        time.sleep(0.2)
    return not _alive(pid)


def _jobs(d):
    """The job lines of the daemon's log."""
    with open(os.path.join(d, "torch_daemon.log")) as f:
        return [json.loads(ln) for ln in f if ln.startswith('{"job"')]


def test_cold_and_warm_jobs_match_jax(tmp_path, daemon_env):
    fq = write_random_fastq(str(tmp_path / "in.fq"), n_reads=250,
                            min_len=30, max_len=700, seed=71,
                            adapter_start=START, adapter_prob=0.4)
    a = tmp_path / "a"
    a.mkdir()
    flags = ["-s", START, "-x"]
    jax_outs = run_ours(fq, str(a), flags)
    # the first client spawns the daemon (cold), the second reuses it
    runs = []
    for tag in ("cold", "warm"):
        io_args = _io(tmp_path / tag)
        r, torch_loaded = _cli(["-i", fq] + io_args + flags, probe=True)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        assert b"daemon unavailable" not in r.stderr
        assert not torch_loaded
        _same_as(tmp_path / tag, jax_outs)
        runs.append(r)
    # the run summary is relayed from the daemon's job
    assert b"JSON report:" in runs[1].stderr
    jobs = _jobs(daemon_env)
    assert [j["rc"] for j in jobs] == [0, 0], jobs


def test_client_imports_no_torch(tmp_path, daemon_env):
    """The daemon saves the client `import torch`: a warm client's process
    ends with no torch module loaded, and so does a client whose job the
    daemon refused to parse."""
    fq = write_random_fastq(str(tmp_path / "in.fq"), n_reads=30, seed=5)
    for tag in ("spawn", "warm"):
        r, torch_loaded = _cli(["-i", fq, "-A"] + _io(tmp_path / tag),
                               probe=True)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        assert not torch_loaded, tag
    r, torch_loaded = _cli(["-i", fq, "--no_such_flag"], probe=True)
    assert r.returncode == 2 and b"unrecognized arguments" in r.stderr
    assert not torch_loaded


def test_stale_code_token_shuts_daemon_down(tmp_path, daemon_env,
                                            monkeypatch):
    fq = write_random_fastq(str(tmp_path / "in.fq"), n_reads=50,
                            min_len=30, max_len=200, seed=73)
    b = tmp_path / "b"
    args = ["-i", fq] + _io(b) + ["-A"]
    r = _cli(args)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    pid1 = _hello()["pid"]
    # a client of other code: it must shut the live daemon down; each
    # daemon it respawns has the real token, so it keeps shutting them
    # down until spawn_wait runs out and then reports "unavailable"
    real = daemon.code_token()
    monkeypatch.setattr(daemon, "code_token", lambda: "stale" + real)
    rc = daemon.run_via_daemon(["fastplong"] + args, spawn_wait=10.0)
    assert rc is None or rc == 0
    assert _gone(pid1), "stale daemon was not shut down"


def test_eligible():
    assert not daemon.eligible(["fastplong", "--stdin", "-o", "x"])
    assert not daemon.eligible(["fastplong", "-i", "a", "--stdout"])
    assert not daemon.eligible(["fastplong", "--num_hosts", "2"])
    assert not daemon.eligible(["fastplong", "--num_hosts=2"])
    assert not daemon.eligible(["fastplong", "--help"])
    assert not daemon.eligible(["fastplong", "-i", "-", "-o", "b"])
    assert not daemon.eligible(["fastplong", "-i", "a", "-o", "/dev/stdout"])
    assert not daemon.eligible(["fastplong", "--in=/dev/fd/0", "-o", "b"])
    assert daemon.eligible(["fastplong", "-i", "a", "-o", "b"])
    # -h is the HTML report here, not help
    assert daemon.eligible(["fastplong", "-i", "a", "-h", "r.html"])


ENV_MISMATCH = [
    ("tokens_per_batch", {"FASTPLONG_TOKENS_PER_BATCH": "131072"}),
    ("visible_cards", {"CUDA_VISIBLE_DEVICES": "0"}),
]


@pytest.mark.parametrize("name,env", ENV_MISMATCH,
                         ids=[e[0] for e in ENV_MISMATCH])
def test_env_mismatch_falls_back(name, env, tmp_path, daemon_env):
    """An import-time or device variable that differs from the daemon's is
    refused ("env differs"), and the client runs in process, on the CPU
    it asked for."""
    fq = write_random_fastq(str(tmp_path / "in.fq"), n_reads=40,
                            min_len=30, max_len=200, seed=79)
    a = tmp_path / "a"
    a.mkdir()
    jax_outs = run_ours(fq, str(a), ["-A"])
    r = _cli(["-i", fq] + _io(tmp_path / "b") + ["-A"])
    assert r.returncode == 0 and b"daemon unavailable" not in r.stderr
    r2 = _cli(["-i", fq] + _io(tmp_path / "c") + ["-A"], env=env)
    assert r2.returncode == 0, r2.stderr.decode()[-2000:]
    assert b"daemon unavailable" in r2.stderr
    _same_as(tmp_path / "c", jax_outs)
    assert len(_jobs(daemon_env)) == 1


def test_env_conflicts_compare_the_device():
    env0 = daemon._env_snapshot()
    env0.update(FASTPLONG_TORCH_DEVICE="cuda", CUDA_VISIBLE_DEVICES=None,
                FASTPLONG_TOKENS_PER_BATCH="32768")
    same = dict(env0)
    assert daemon._env_conflicts(same, env0) == []
    # an import-time variable the client leaves unset is no conflict ...
    assert daemon._env_conflicts(
        dict(same, FASTPLONG_TOKENS_PER_BATCH=""), env0) == []
    # ... but the device and the visible cards must be the client's
    assert daemon._env_conflicts(
        dict(same, FASTPLONG_TORCH_DEVICE="cpu"), env0) == [
            "FASTPLONG_TORCH_DEVICE"]
    assert daemon._env_conflicts(
        dict(same, CUDA_VISIBLE_DEVICES="1"), env0) == [
            "CUDA_VISIBLE_DEVICES"]
    assert daemon._env_conflicts(
        same, dict(env0, CUDA_VISIBLE_DEVICES="")) == ["CUDA_VISIBLE_DEVICES"]


def test_concurrent_clients(tmp_path, daemon_env):
    """Two clients racing one daemon: the second queues at the hello and
    both jobs complete with the JAX CLI's outputs."""
    fq = write_random_fastq(str(tmp_path / "in.fq"), n_reads=120,
                            min_len=30, max_len=400, seed=101,
                            adapter_start=START, adapter_prob=0.3)
    a = tmp_path / "a"
    a.mkdir()
    jax_outs = run_ours(fq, str(a), ["-s", START])
    r = _cli(["-i", fq] + _io(tmp_path / "w") + ["-s", START])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    results = {}

    def run_one(tag):
        results[tag] = _cli(["-i", fq] + _io(tmp_path / tag) + ["-s", START])

    ts = [threading.Thread(target=run_one, args=("c%d" % i,))
          for i in range(2)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
    assert not any(t.is_alive() for t in ts)
    for tag, r in results.items():
        assert r.returncode == 0, (tag, r.stderr.decode()[-2000:])
        assert b"daemon unavailable" not in r.stderr
        _same_as(tmp_path / tag, jax_outs)
    assert len(_jobs(daemon_env)) == 3


def test_code_token_counts_sources_not_build_outputs(tmp_path):
    pkg = str(tmp_path / "fastplong_tpu_torch")
    shutil.copytree(os.path.dirname(os.path.abspath(daemon.__file__)), pkg,
                    ignore=shutil.ignore_patterns("_kernels", "*.so",
                                                  "__pycache__"))
    t0 = daemon.code_token(pkg)
    # what a daemon's first job may build: the kernel library, the native
    # host library, bytecode
    os.makedirs(os.path.join(pkg, "_kernels"))
    for p in ("_kernels/libfplcuda-0123456789abcdef.so",
              "_kernels/libfplcuda-0123456789abcdef.so.ptxas.txt",
              "_kernels/mismatch_scan.cu.o", "_kernels/build.lock",
              "native/libfplhost.so"):
        with open(os.path.join(pkg, p), "w") as f:
            f.write("built")
    os.makedirs(os.path.join(pkg, "ops", "__pycache__"))
    with open(os.path.join(pkg, "ops", "__pycache__", "x.pyc"), "w") as f:
        f.write("x")
    assert daemon.code_token(pkg) == t0
    # an edited kernel source, or an edited module, is other code
    for src in ("csrc/myers_verify.cu", "native/host_io.cpp", "main.py"):
        p = os.path.join(pkg, src)
        st = os.stat(p)
        os.utime(p, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
        t1 = daemon.code_token(pkg)
        assert t1 != t0, src
        t0 = t1


def test_jax_and_port_daemons_side_by_side(tmp_path, daemon_env,
                                           monkeypatch):
    """Both packages' daemons in one FASTPLONG_DAEMON_DIR: each client
    finds its own (socket names differ), and alternating jobs replace
    neither."""
    from fastplong_tpu import daemon as jax_daemon
    monkeypatch.setenv("FASTPLONG_DAEMON_MODE", "resident")
    fq = write_random_fastq(str(tmp_path / "in.fq"), n_reads=40,
                            min_len=30, max_len=200, seed=83)
    pids = []
    for k, module in enumerate(["fastplong_tpu.main",
                                "fastplong_tpu_torch.main"] * 2):
        r = _cli(["-i", fq] + _io(tmp_path / ("r%d" % k)) + ["-A"],
                 module=module)
        assert r.returncode == 0, (module, r.stderr.decode()[-2000:])
        assert b"daemon unavailable" not in r.stderr, module
        conn, hello = (jax_daemon if module.startswith("fastplong_tpu.")
                       else daemon)._connect()
        conn.close()
        pids.append(hello["pid"])
    assert pids[0] == pids[2] and pids[1] == pids[3] != pids[0]
    assert all(_alive(p) for p in pids)
    assert _read(str(tmp_path / "r0" / "out.fq")) == \
        _read(str(tmp_path / "r1" / "out.fq"))


class _FakeDaemon:
    """A server on the port's socket path that answers every connection
    with `hello`, records the one message it then receives, and closes the
    connection without a reply."""

    def __init__(self, hello):
        self.got = []
        self.hello = hello
        self.stop = False
        self.srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self.srv.bind(daemon.sock_path())
        self.srv.listen(4)
        self.srv.settimeout(0.2)
        self.t = threading.Thread(target=self._serve, daemon=True)
        self.t.start()

    def _serve(self):
        while not self.stop:
            try:
                conn, _ = self.srv.accept()
            except socket.timeout:
                continue
            with conn:
                conn.settimeout(10)
                daemon._send_msg(conn, self.hello)
                self.got.append(daemon._recv_msg(conn))

    def close(self):
        self.stop = True
        self.t.join(timeout=20)
        assert not self.t.is_alive()
        self.srv.close()
        os.unlink(daemon.sock_path())


def test_other_package_daemon_is_unavailable(daemon_env):
    """A hello without the port's package name (the JAX daemon's) is no
    daemon of ours: no job and no shutdown go to it."""
    fake = _FakeDaemon({"proto": daemon.PROTO, "token": daemon.code_token(),
                        "pid": 1})
    try:
        assert daemon.run_via_daemon(["fastplong", "-A"], spawn_wait=5) \
            is None
        assert not daemon.shutdown_daemon()
    finally:
        fake.close()
    assert fake.got == [None, None]


def test_lost_reply_is_not_rerun(daemon_env, capsys):
    """A daemon that takes the job and ends without a reply: the client
    reports rc 70 and does not run the job again in process."""
    fake = _FakeDaemon({"proto": daemon.PROTO, "package": daemon.PACKAGE,
                        "token": daemon.code_token(), "pid": 12345})
    try:
        rc = daemon.run_via_daemon(["fastplong", "-A"], spawn_wait=5)
    finally:
        fake.close()
    assert rc == daemon.RC_CRASH
    assert fake.got[0]["argv"] == ["fastplong", "-A"]
    assert "ended without answering" in capsys.readouterr().err


def test_cuda_fault_classification():
    import torch
    assert daemon._cuda_fault(RuntimeError("CUDA error: an illegal memory "
                                           "access was encountered"))
    assert daemon._cuda_fault(RuntimeError(
        "CUDA kernel myers_verify failed to launch: cudaError 700"))
    if hasattr(torch, "AcceleratorError"):
        assert daemon._cuda_fault(torch.AcceleratorError("x"))
    assert not daemon._cuda_fault(RuntimeError("incomplete blocks"))
    assert not daemon._cuda_fault(ValueError("CUDA"))


def _norm(b):
    return re.sub(rb"time used: \d+ seconds", b"time used: T seconds", b)


def test_job_without_card_fails_as_in_process(tmp_path, daemon_env,
                                              monkeypatch):
    """FASTPLONG_TORCH_DEVICE=cuda: the daemon runs the job on the card or
    fails it with the in-process run's message and rc (on a host without
    one); it never reports itself incompatible and never moves the job to
    the CPU."""
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cuda")
    fq = write_random_fastq(str(tmp_path / "in.fq"), n_reads=20, seed=3)
    r = _cli(["-i", fq] + _io(tmp_path / "d") + ["-A"])
    r0 = _cli(["-i", fq] + _io(tmp_path / "p") + ["-A"],
              env={"FASTPLONG_DAEMON": "0"})
    assert r.returncode == r0.returncode
    assert _norm(r.stderr).replace(b"/d/", b"/p/") == _norm(r0.stderr)
    assert b"daemon unavailable" not in r.stderr
    import torch
    if not torch.cuda.is_available():
        assert r.returncode == 255 and b"ERROR: CUDA was requested" in \
            r.stderr
    assert len(_jobs(daemon_env)) == 1


def test_failing_job_then_exact_job(tmp_path, daemon_env, monkeypatch):
    """A job with a missing input fails with the JAX CLI's error and the
    JAX daemon's rc for a job that raised; a job over a truncated gzip
    fails mid-run as the in-process run does; the next job through the
    same daemon is byte-exact."""
    from fastplong_tpu.main import main as jax_main
    missing = str(tmp_path / "absent.fq")
    args = ["-i", missing, "-o", str(tmp_path / "m.fq"),
            "-j", str(tmp_path / "m.json"), "-h", str(tmp_path / "m.html")]
    monkeypatch.delenv("FASTPLONG_DAEMON")
    with pytest.raises(OSError) as e:
        jax_main(["fastplong"] + args)
    monkeypatch.setenv("FASTPLONG_DAEMON", "1")
    r = _cli(args)
    assert r.returncode == daemon.RC_CRASH
    assert r.stderr.decode().splitlines()[-1] == "%s: %s" % (
        type(e.value).__name__, e.value)

    fq = write_random_fastq(str(tmp_path / "in.fq"), n_reads=200,
                            min_len=30, max_len=600, seed=97,
                            adapter_start=START, adapter_prob=0.4)
    gz = str(tmp_path / "cut.fq.gz")
    with open(fq, "rb") as f:
        data = gzip.compress(f.read())
    with open(gz, "wb") as f:
        f.write(data[:len(data) // 2])
    cut = _cli(["-i", gz] + _io(tmp_path / "cut") + ["-s", START])
    cut0 = _cli(["-i", gz] + _io(tmp_path / "cut0") + ["-s", START],
                env={"FASTPLONG_DAEMON": "0"})
    assert cut.returncode == cut0.returncode != 0
    assert cut.stderr.replace(b"/cut/", b"/cut0/") == cut0.stderr

    a = tmp_path / "a"
    a.mkdir()
    jax_outs = run_ours(fq, str(a), ["-s", START, "-x"])
    r = _cli(["-i", fq] + _io(tmp_path / "good") + ["-s", START, "-x"])
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    _same_as(tmp_path / "good", jax_outs)
    assert [j["rc"] for j in _jobs(daemon_env)] == [daemon.RC_CRASH, -1, 0]


def test_failed_run_leaves_no_thread(tmp_path, monkeypatch):
    """The daemon's job function over a run that fails with a writer
    thread running (--failed_out opens, then -o names a directory that
    does not exist): rc 70 with the error, not fatal, and no writer thread
    left behind in the serving process."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
    write_random_fastq(str(tmp_path / "in.fq"), n_reads=60, seed=98)
    before = set(threading.enumerate())
    job = {"argv": ["fastplong", "-i", "in.fq", "--failed_out", "failed.fq",
                    "-o", "absent/out.fq.gz", "-A"],
           "cwd": str(tmp_path), "env": {}}
    baseline = {k: v for k, v in os.environ.items()
                if k.startswith("FASTPLONG_")}
    reply, fatal = daemon._run_job(job, baseline)
    assert reply["rc"] == daemon.RC_CRASH and not fatal
    assert reply["stderr"].splitlines()[-1].startswith("FileNotFoundError")
    assert os.path.exists("failed.fq")    # its writer was running
    deadline = time.time() + 10
    while time.time() < deadline and set(threading.enumerate()) - before:
        time.sleep(0.1)
    assert not set(threading.enumerate()) - before
    assert os.environ["FASTPLONG_TORCH_DEVICE"] == "cpu"


def test_runtime_vars_stay_with_their_job(tmp_path, daemon_env):
    """A runtime variable of the client that spawned the daemon (here
    FASTPLONG_TIMER_DUMP) applies to that client's job alone: a later
    client without it writes no dump, one with its own path writes
    there."""
    fq = write_random_fastq(str(tmp_path / "in.fq"), n_reads=30, seed=7)
    dumps = [str(tmp_path / "dump0.json"), str(tmp_path / "dump2.json")]
    for k, env in enumerate(({"FASTPLONG_TIMER_DUMP": dumps[0]}, {},
                             {"FASTPLONG_TIMER_DUMP": dumps[1]})):
        r = _cli(["-i", fq, "-A"] + _io(tmp_path / ("r%d" % k)), env=env)
        assert r.returncode == 0, r.stderr.decode()[-2000:]
        if k == 0:
            with open(dumps[0]) as f:
                assert json.load(f)["step_calls"] > 0
            os.unlink(dumps[0])
    assert not os.path.exists(dumps[0])
    assert os.path.exists(dumps[1])
    assert len(_jobs(daemon_env)) == 3


def test_prewarm_runs_in_the_daemon(tmp_path, daemon_env):
    """--prewarm under FASTPLONG_DAEMON=1 starts and warms the daemon: both
    of its passes are daemon jobs, and the client imports no torch."""
    r, torch_loaded = _cli(["--prewarm", "-A"], probe=True)
    assert r.returncode == 0, r.stderr.decode()[-2000:]
    assert re.search(rb"^prewarm: cold pass [0-9.]+s, warm pass [0-9.]+s "
                     rb"\(rc=0\)$", r.stderr, re.M), r.stderr[-2000:]
    assert b"daemon unavailable" not in r.stderr
    assert not torch_loaded
    assert [j["rc"] for j in _jobs(daemon_env)] == [0, 0]
