"""The statistics of monster buckets (over stat_device_cap()) in the
port's runner: a [2, F] accumulator on the first device, made at the first
monster bucket's length and grown on the device, against the host route
(pipeline/host_stats.py) that a bucket beyond the accumulator's memory
ceiling takes.  The ceiling is forced low by replacing
runner.stats_state_budget.

The CPU cases lower the cap to the first bucket (1,024); the card case
(marker `cuda`, skipped without a card) keeps the default cap and plants
reads of 70, 140 and 300 kb.  Imports neither JAX nor the test
configuration's JAX set-up:

    python -m pytest --noconftest -o addopts="" tests/test_torch_monster_stats.py
"""

import json
import os

import numpy as np
import pytest
import torch

from fastplong_tpu_torch import main as tmain
from fastplong_tpu_torch.ops.stats_kernels import (side_stat_len,
                                                   stat_batch_into)
from fastplong_tpu_torch.pipeline import device as tdev
from fastplong_tpu_torch.pipeline import runner as trunner
from fastplong_tpu_torch.pipeline.batches import bucket_len
from fastplong_tpu_torch.processor import process
from golden_util import norm_html, strip_command

START = "AATGTACTTCGTTCAGTTACGTATTGCT"
END = "AGCAATACGTAACTGAACGAAGT"
HEADLINE = ["-s", START, "-e", END, "-5", "-3", "-x"]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _add(state, rng, B, L):
    """One batch of random reads (lengths up to L) added into both sides
    of state: whole reads into pre, random spans into post."""
    dev = state.device
    bases = torch.from_numpy(rng.choice(np.frombuffer(b"ACGTN", np.uint8),
                                        size=(B, L))).to(dev)
    quals = torch.from_numpy(rng.integers(33, 80, (B, L), dtype=np.uint8)
                             ).to(dev)
    lens = rng.integers(1, L + 1, B)
    lo = rng.integers(0, lens)
    hi = rng.integers(lo, lens + 1)
    mask = torch.from_numpy(rng.random(B) < 0.9).to(dev)

    def t(x):
        return torch.from_numpy(np.asarray(x, np.int32))[None].to(dev)

    stat_batch_into(state[0], bases, quals, torch.zeros_like(t(lens)),
                    t(lens), mask[None], zero_lo=True)
    stat_batch_into(state[1], bases, quals, t(lo), t(hi), mask[None])
    return int(lens.max())


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_grown_state_drains_as_one_made_long(device):
    """A state made short and grown twice, a batch added at each length,
    holds and drains bit for bit what one made at the longest length holds
    after the same batches."""
    dev = _card() if device == "cuda" else torch.device("cpu")
    lengths = (200, 700, 1600)
    grown = tdev.zero_stats_state(lengths[0], dev)
    longest = tdev.zero_stats_state(lengths[-1], dev)
    seen = 0
    for k, L in enumerate(lengths):
        if k:
            grown = tdev.grow_stats_state(grown, L)
        assert side_stat_len(grown) == L
        _add(grown, np.random.default_rng(k), 24, L)
        seen = max(seen, _add(longest, np.random.default_rng(k), 24, L))
    assert torch.equal(grown, longest)
    for max_seen in (None, seen):
        a, m = tdev.stats_state_to_numpy([grown], max_seen)
        b, n = tdev.stats_state_to_numpy([longest], max_seen)
        assert m == n
        np.testing.assert_array_equal(a, b)


def _write(path, rng, lens):
    """Reads of the given lengths, each with the headline adapters, polyA
    tails and stretches of low quality, in this order."""
    acgt = np.frombuffer(b"ACGT", np.uint8)
    with open(path, "wb") as f:
        for i, n in enumerate(lens):
            seq = acgt[rng.integers(0, 4, n)].tobytes()
            if rng.random() < 0.6:
                seq = START.encode() + seq
            if rng.random() < 0.3:
                seq += b"A" * int(rng.integers(5, 40))
            if rng.random() < 0.6:
                seq += END.encode()
            qual = np.concatenate([
                rng.integers(*((35, 45) if rng.random() < 0.3 else (48, 74)),
                             int(rng.integers(40, 3000)), dtype=np.uint8)
                for _ in range(len(seq) // 40 + 1)])[:len(seq)]
            f.write(b"@r%d desc\n%s\n+\n%s\n" % (i, seq, qual.tobytes()))
    return path


def _longest(fq):
    with open(fq, "rb") as f:
        return max(len(s) for s in f.read().split(b"\n")[1::4])


def _job(d, fq, flags, device, monkeypatch):
    """One job in process: its output bytes (reads, failed reads, JSON
    without the command, HTML without the run's time and command), each
    side's per-read medians in input order, and its timer dump."""
    os.makedirs(d, exist_ok=True)
    p = {k: os.path.join(d, k) for k in ("o.fq", "f.fq", "r.json", "r.html")}
    argv = ["fastplong", "-i", fq, "-o", p["o.fq"], "--failed_out",
            p["f.fq"], "-j", p["r.json"], "-h", p["r.html"]] + flags
    opt = tmain.options_from_args(tmain.build_parser().parse_args(argv[1:]),
                                  argv)
    monkeypatch.setenv("FASTPLONG_TIMER_DUMP", os.path.join(d, "dump.json"))
    pre, post, _ = process(opt, device)
    with open(os.path.join(d, "dump.json")) as f:
        dump = json.load(f)
    out = {}
    for k, path in p.items():
        with open(path, "rb") as f:
            out[k] = f.read()
    out["r.json"] = strip_command(out["r.json"].decode())
    out["r.html"] = norm_html(out["r.html"].decode())
    for name, stats in (("pre", pre), ("post", post)):
        med, _, order = (np.concatenate(c) for c in
                         zip(*stats._qual_len_chunks))
        out[name + "_medians"] = med[np.argsort(order, kind="stable")]
        out[name + "_median_hist"] = stats.median_qual_hist
    return out, dump


def _routes(tmp, fq, flags, device, monkeypatch):
    """The job on the device route, then with the accumulator's ceiling
    forced to 0 bytes (the host route); asserts that the outputs and the
    medians are equal and returns both dumps."""
    dev_out, dev_dump = _job(os.path.join(tmp, "device"), fq, flags, device,
                             monkeypatch)
    with monkeypatch.context() as mp:
        mp.setattr(trunner, "stats_state_budget", lambda device: 0)
        host_out, host_dump = _job(os.path.join(tmp, "host"), fq, flags,
                                   device, mp)
    assert dev_out.keys() == host_out.keys()
    for k in dev_out:
        if isinstance(dev_out[k], np.ndarray):
            np.testing.assert_array_equal(dev_out[k], host_out[k], err_msg=k)
        else:
            assert dev_out[k] == host_out[k], k
    assert host_dump["monster_step_calls"] == 0
    assert host_dump["monster_stat_len"] == 0
    assert host_dump["host_stat_batches"] > 0
    assert host_dump["step_calls"] == dev_dump["step_calls"]
    assert "host_stats" in host_dump["stage_seconds"]
    assert "host_stats" not in dev_dump["stage_seconds"]
    assert dev_dump["host_stat_batches"] == 0
    return dev_dump


@pytest.mark.parametrize("flags", [HEADLINE, HEADLINE + ["-b", "-N"]],
                         ids=["headline", "break_mask"])
def test_monster_routes_agree(tmp_path, monkeypatch, flags):
    """With the cap at 1,024, the buckets over it (reads of 1-9 kb, shorter
    first) go into the grown accumulator; forced onto the host they give
    the same reads, failed reads, reports and medians."""
    monkeypatch.setenv("FASTPLONG_STAT_DEVICE_CAP", "1024")
    rng = np.random.default_rng(19)
    lens = list(rng.integers(40, 900, 60)) + [1500, 3000, 9000]
    fq = _write(str(tmp_path / "in.fq"), rng, lens)
    dump = _routes(str(tmp_path), fq, flags, torch.device("cpu"),
                   monkeypatch)
    assert dump["monster_step_calls"] == 3
    assert dump["monster_stat_len"] == bucket_len(_longest(fq))


@pytest.mark.cuda
def test_monster_routes_agree_on_card(tmp_path, monkeypatch):
    """At the default cap, reads of 70, 140 and 300 kb among short ones
    (each in a bucket of its own, shorter first, so the accumulator is
    made once and grown twice on the card) give the host route's reads,
    failed reads, reports and medians."""
    card = _card()
    rng = np.random.default_rng(20)
    lens = list(rng.integers(40, 20000, 200)) + [70000, 140000, 300000]
    fq = _write(str(tmp_path / "in.fq"), rng, lens)
    dump = _routes(str(tmp_path), fq, HEADLINE, card, monkeypatch)
    assert dump["monster_step_calls"] == 3
    assert dump["monster_stat_len"] == bucket_len(_longest(fq))
