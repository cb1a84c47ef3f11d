"""The port's --devices N (pipeline/sharding.py) against the JAX package's,
on the CPU.

The port runs N row slices on the one CPU device; the JAX package runs its
sharded step on the eight virtual CPU devices that tests/conftest.py
provides.  At the step level, the rows must be equal and the port's summed
per-slice partials must equal the JAX state summed over its device axis;
end to end, the port's CLI at --devices 8 must write the same FASTQ,
failed reads, JSON (without its command line) and normalised HTML as the
JAX CLI at --devices 8 and as the port at --devices 1.  Tolerance 0.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastplong_tpu.main import build_parser, options_from_args
from fastplong_tpu.pipeline import device as jdev
from fastplong_tpu.pipeline import sharding as jsh
from fastplong_tpu_torch.pipeline import device as tdev
from fastplong_tpu_torch.pipeline import sharding as tsh
from golden_util import norm_html, strip_command, write_random_fastq
from test_sharding import _batch, _opts, _write_input
from test_torch_step import END, HEADLINE, START, _rand_batch

N_DEV = 8
BREAK_MASK = HEADLINE + ["-b", "-N"]


def _jopt(extra):
    argv = ["fastplong", "-i", "in.fq", "-o", "out.fq"] + list(extra)
    return options_from_args(build_parser().parse_args(argv[1:]), argv)


def _cpu_placement():
    return tsh.Placement(["cpu"] * N_DEV)


def _port_rows(step, placement, packed, L, states):
    _, parts = placement.split_rows(packed)
    rows, events = step(states, parts, L)
    assert events == []          # the CPU steps finish before they return
    return rows.numpy()


# ------------------------------------------------------------ step level


@pytest.mark.parametrize("name,extra", [("headline", HEADLINE),
                                        ("break_mask", BREAK_MASK)])
def test_fast_sharded_step_matches_jax(name, extra):
    """The port's sharded fast step over 8 CPU slices against JAX's on 8
    virtual devices (B = 64; base5 rows at L = 128, wide at 1024): equal
    rows, and summed partials equal to the JAX state summed over its
    device axis.  Then 61 rows (slices of 8 and 7) against JAX's
    one-device step."""
    jopt = _jopt(extra)
    p = jdev.kernel_params(jopt)
    F = jdev.out_fields(jopt)
    SL = jdev.global_stat_len()
    mesh = jsh.make_mesh(jax.devices()[:N_DEV])
    jplace = jsh.MeshPlacement(mesh)
    jstep, _ = jsh.build_fast_sharded_step(jopt, mesh)
    jstate = jplace.init_state(SL)
    jone, _ = jdev.get_fast_step(jopt)
    jone_state = jdev.init_stats_state(SL)
    place = _cpu_placement()
    tstep, stages = tsh.build_fast_sharded_step(p, place)
    assert stages == jdev.adapter_stages(p)
    tstates = place.init_state(SL)
    uneven = place.init_state(SL)
    rng = np.random.default_rng(sum(map(ord, name)))
    for L, packer in ((128, jdev.pack_input_b5), (1024, jdev.pack_input)):
        packed = packer(*_rand_batch(rng, 64, L, plant=(START, END),
                                     lowq=p["break_enabled"]))
        outbuf = jplace.put_outbuf(np.zeros((1, 64, F), np.int32))
        jstate, jout = jstep(jstate, outbuf, np.int32(0),
                             jplace.put_input(packed), L)
        rows = _port_rows(tstep, place, packed, L, tstates)
        np.testing.assert_array_equal(rows, np.asarray(jout)[0])
        cut = packed[:61]
        jone_state, jout1 = jone(jone_state, jnp.zeros((1, 61, F), jnp.int32),
                                 np.int32(0), jnp.asarray(cut), L)
        rows = _port_rows(tstep, place, cut, L, uneven)
        np.testing.assert_array_equal(rows, np.asarray(jout1)[0])
    want = np.asarray(jstate).astype(np.int64).sum(axis=0)
    np.testing.assert_array_equal(tdev.stats_state_to_numpy(tstates)[0],
                                  want)
    np.testing.assert_array_equal(tdev.stats_state_to_numpy(uneven)[0],
                                  np.asarray(jone_state).astype(np.int64))
    if p["break_enabled"]:
        # the batches found regions: some slot carries a region number
        slot = rows[:, 5:5 + 6 * 4].reshape(len(rows), 4, 6)
        assert (slot[..., 5] > 0).any()


def test_sharded_dict_step_matches_jax():
    """tests/test_sharding.py:35's batch through the port's dict step over
    8 CPU slices and JAX's over 8 virtual devices: per-read fields and
    medians equal, and the summed partials equal JAX's psum-merged
    statistics in the flat layout."""
    jopt = _opts()
    p = jdev.kernel_params(jopt)
    mesh = jsh.make_mesh(jax.devices()[:N_DEV])
    jstep, _ = jsh.build_sharded_step(jopt, mesh)
    tstep, _ = tsh.build_sharded_step(p, _cpu_placement())
    B, L = 64, 256
    bases, quals, lens, mask = _batch(B, L)
    sh = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("data"))
    ref = jax.tree.map(np.asarray, jstep(*(
        jax.device_put(jnp.asarray(a), sh)
        for a in (bases, quals, lens, mask))))
    got = tstep(*(torch.from_numpy(a) for a in (bases, quals, lens, mask)))
    for k in ("lo", "hi", "null", "code", "passed", "out_lo", "out_hi",
              "poly", "poly_trim", "adapter_trimmed", "adapter_recs"):
        np.testing.assert_array_equal(got[k].numpy(), ref[k], err_msg=k)
    np.testing.assert_array_equal(got["pre_median"].numpy(),
                                  ref["pre"]["median"])
    for c, post in enumerate(ref["posts"]):
        np.testing.assert_array_equal(got["post_median"][c].numpy(),
                                      post["median"])
    flat = np.stack([
        np.asarray(jdev._flat_partial(ref["pre"], L)),
        sum(np.asarray(jdev._flat_partial(post, L)).astype(np.int64)
            for post in ref["posts"])]).astype(np.int64)
    np.testing.assert_array_equal(got["stats"], flat)


# -------------------------------------------------------------- the CLI


def _monster_input(path):
    """Short reads with both headline adapters and one read of 70,000
    bases, over the stat cap (65,536): its bucket bypasses the slices."""
    write_random_fastq(path, n_reads=60, min_len=40, max_len=900, seed=21,
                       adapter_start=START, adapter_end=END,
                       adapter_prob=0.6)
    rng = np.random.default_rng(22)
    seq = START + "".join(rng.choice(list("ACGT"), 70000)) + END
    qual = "".join(map(chr, rng.integers(33 + 8, 33 + 41, len(seq))))
    with open(path, "a") as f:
        f.write("@monster\n%s\n+\n%s\n" % (seq, qual))


def _three_reads(path):
    write_random_fastq(path, n_reads=3, min_len=300, max_len=900, seed=23,
                       adapter_start=START, adapter_end=END,
                       adapter_prob=1.0)


# (name, flags, input): tests/test_sharding.py's three flag sets on its
# inputs (:83, :114, :144), --split 2, and a monster read
CLI_CASES = [
    ("trim_cut_polyx", ["-s", START, "-5", "-3", "-x"], (500, 3)),
    ("break", ["-e", END, "-b", "-x"], (400, 9)),
    ("stats_backend_host", ["-s", START, "-5", "-3", "-x",
                            "--stats_backend", "host"], (300, 17)),
    ("split_2", ["-s", START, "-e", END, "--split", "2"], (500, 3)),
    ("monster", HEADLINE, "monster"),
]


def _run(main, in_fq, d, flags, devices):
    """One CLI run into directory d; returns its files by name."""
    os.makedirs(d)
    args = ["-i", in_fq, "-o", os.path.join(d, "out.fq"),
            "-j", os.path.join(d, "r.json"), "-h", os.path.join(d, "r.html")]
    if "--split" not in flags:
        args += ["--failed_out", os.path.join(d, "failed.fq")]
    assert main(["fastplong"] + args + flags
                + ["--devices", str(devices)]) in (0, None)
    return sorted(os.listdir(d))


def _content(path):
    with open(path, "rb") as f:
        data = f.read()
    if path.endswith(".json"):
        return strip_command(data.decode())
    if path.endswith(".html"):
        return norm_html(data.decode())
    return data


def _same_dirs(a, b, names, what):
    for n in names:
        assert _content(os.path.join(a, n)) == _content(os.path.join(b, n)), \
            "%s differs: %s" % (n, what)


def _three_way(in_fq, tmp_path, flags, monkeypatch):
    """The port at --devices 8 against the JAX CLI at --devices 8 and the
    port at --devices 1; returns the file names and the port's step calls
    at 8 and at 1 device."""
    from fastplong_tpu.main import main as jax_main
    from fastplong_tpu_torch.main import main as port_main
    names = _run(jax_main, in_fq, str(tmp_path / "jax8"), flags, N_DEV)
    assert "r.json" in names
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cpu")
    calls = {}
    for n in (N_DEV, 1):
        dump = str(tmp_path / ("timer%d.json" % n))
        monkeypatch.setenv("FASTPLONG_TIMER_DUMP", dump)
        assert _run(port_main, in_fq, str(tmp_path / ("port%d" % n)), flags,
                    n) == names
        with open(dump) as f:
            calls[n] = json.load(f)["step_calls"]
    _same_dirs(tmp_path / "port8", tmp_path / "jax8", names,
               "port --devices 8 against JAX --devices 8")
    _same_dirs(tmp_path / "port8", tmp_path / "port1", names,
               "port --devices 8 against port --devices 1")
    return names, calls


@pytest.mark.parametrize("name,flags,which", CLI_CASES,
                         ids=[c[0] for c in CLI_CASES])
def test_devices_cli_matches_jax(name, flags, which, tmp_path, monkeypatch):
    in_fq = str(tmp_path / "in.fq")
    if which == "monster":
        _monster_input(in_fq)
    else:
        _write_input(in_fq, n=which[0], seed=which[1])
    names, calls = _three_way(in_fq, tmp_path, flags, monkeypatch)
    if "--split" in flags:
        assert [n for n in names if n.endswith(".out.fq")] == [
            "0001.out.fq", "0002.out.fq"]
    # one launch per non-empty slice: the batches were sliced
    assert calls[N_DEV] > calls[1]


def test_devices_empty_slices(tmp_path, monkeypatch):
    """3 reads at --devices 8: every batch leaves slices empty, which
    launch nothing; outputs as above."""
    in_fq = str(tmp_path / "in.fq")
    _three_reads(in_fq)
    _, calls = _three_way(in_fq, tmp_path, HEADLINE, monkeypatch)
    assert calls[1] <= calls[N_DEV] <= 3


def test_devices_more_than_visible_cards(tmp_path, monkeypatch, capsys):
    """--devices 2 on CUDA with one visible card stops with exit -1 and the
    JAX package's message (JAX: --devices 9 on its 8 virtual devices)."""
    from fastplong_tpu.main import main as jax_main
    from fastplong_tpu_torch.main import main as port_main
    in_fq = str(tmp_path / "in.fq")
    _three_reads(in_fq)
    argv = ["fastplong", "-i", in_fq, "-o", str(tmp_path / "o.fq"),
            "-j", str(tmp_path / "r.json"), "-h", str(tmp_path / "r.html")]
    with pytest.raises(SystemExit) as e:
        jax_main(argv + HEADLINE + ["--devices", "9"])
    assert e.value.code == -1
    jerr = capsys.readouterr().err.splitlines()[-1]
    assert jerr == ("ERROR: --devices 9 requested but only 8 device(s) "
                    "available")
    monkeypatch.setenv("FASTPLONG_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as e:
        port_main(argv + HEADLINE + ["--devices", "2"])
    assert e.value.code == -1
    err = capsys.readouterr().err.splitlines()[-1]
    assert err == re.sub(r"9 requested but only 8", "2 requested but only 1",
                         jerr)
