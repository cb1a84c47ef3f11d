"""The port's fused step against fastplong_tpu's, on the CPU.

The JAX package's own kernel_params dict drives the port's step, and both
steps get the same packed batches (tests/test_host_step.py's recipe, both
row layouts, L in {128, 1024}, with low-quality stretches planted where
break or mask is on): the packed per-read rows and the drained [2, F]
statistics state must be identical (tolerance 0), with statistics on and
off.  The configurations with break or mask are in
tests/test_torch_step_break_mask.py, which uses the checks here, so that
the two halves run on two workers.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastplong_tpu.main import build_parser, options_from_args
from fastplong_tpu.pipeline import device as jdev
from fastplong_tpu_torch import main as tmain
from fastplong_tpu_torch.pipeline import device as tdev

START = "AATGTACTTCGTTCAGTTACGTATTGCT"
END = "AGCAATACGTAACTGAACGAAGT"

HEADLINE = ["-s", START, "-e", END, "-5", "-3", "-x"]

# tests/test_host_step.py's configurations (break (-b) and N-mask (-N)
# alone, together and on the headline are BREAK_MASK_CONFIGS)
CONFIGS = [
    ("filters_only", ["-A"]),
    ("adapters", ["-s", START, "-e", END]),
    ("headline", HEADLINE),
    ("everything", ["-s", START, "-e", END, "-5", "-3", "-x", "-y",
                    "-f", "2", "-t", "1", "-m", "8"]),
    ("cut_only", ["-A", "-5", "-3", "-W", "7", "-M", "25"]),
    ("start_only_polyx", ["-s", START, "-x", "--poly_x_min_len", "8",
                          "--trimming_extension", "3"]),
]
BREAK_MASK_CONFIGS = [
    ("break_mask", ["-s", START, "-b", "--break_window_size", "20",
                    "--break_mean_quality", "22", "-N",
                    "--mask_window_size", "15", "--mask_mean_quality",
                    "20"]),
    ("filters_break", ["-A", "-b"]),
    ("filters_mask", ["-A", "-N", "--mask_window_size", "20",
                      "--mask_mean_quality", "20"]),
    ("headline_break_mask", HEADLINE + ["-b", "--break_window_size", "20",
                                        "--break_mean_quality", "22",
                                        "-N"]),
    # break only at the planted stretches, and a mask strict enough to
    # find regions in the fragments that break leaves
    ("headline_break_mask_fragments", HEADLINE + [
        "-b", "--break_window_size", "20", "--break_mean_quality", "12",
        "-N", "--mask_window_size", "15", "--mask_mean_quality", "20"]),
]


def _argv(extra):
    return ["fastplong", "-i", "in.fq", "-o", "out.fq"] + list(extra)


def _jopt(extra):
    argv = _argv(extra)
    return options_from_args(build_parser().parse_args(argv[1:]), argv)


def _topt(extra):
    argv = _argv(extra)
    return tmain.options_from_args(
        tmain.build_parser().parse_args(argv[1:]), argv)


def _rand_batch(rng, B, L, plant=(), lowq=False):
    """tests/test_host_step.py's batches; lowq plants a stretch of Q2-Q8
    qualities in every other row, so that the default break and mask
    windows find regions."""
    bases = rng.choice(np.frombuffer(b"ACGTN", np.uint8), size=(B, L),
                       p=[.24, .24, .24, .24, .04])
    quals = rng.integers(33 + 2, 33 + 41, size=(B, L)).astype(np.uint8)
    lens = rng.integers(min(25, L), L + 1, size=B).astype(np.int32)
    mask = np.ones(B, bool)
    mask[rng.integers(0, B)] = False  # one padding row
    for i in range(B):
        for seq in plant:
            if rng.random() < 0.5:
                a = np.frombuffer(seq.encode(), np.uint8)
                if lens[i] > len(a) + 2:
                    p = int(rng.integers(0, lens[i] - len(a)))
                    bases[i, p:p + len(a)] = a
        if lowq and i % 2 == 0:
            n = int(rng.integers(30, max(31, lens[i] // 2)))
            p = int(rng.integers(0, max(1, lens[i] - n)))
            quals[i, p:p + n] = rng.integers(33 + 2, 33 + 9, size=n)[:L - p]
    return bases, quals, lens, mask


def _region_rows(rows, cap):
    """(active slots that carry a region number, mask spans) in rows."""
    slot = rows[:, 5:5 + 6 * cap].reshape(len(rows), cap, 6)
    active = (slot[..., 4] >> 10) & 1
    return (int(((slot[..., 5] > 0) & (active == 1)).sum()),
            int((slot[..., 3] > slot[..., 2]).sum()))


def check_kernel_params(extra):
    jopt, topt = _jopt(extra), _topt(extra)
    assert tdev.kernel_params(topt) == jdev.kernel_params(jopt)
    assert tdev.out_fields(topt) == jdev.out_fields(jopt)
    assert tdev.out_cap(topt) == jdev.out_cap(jopt)
    if "-b" in extra and "-A" not in extra:
        assert tdev.out_cap(topt) == 4
    assert tdev.adapter_stages(tdev.kernel_params(topt)) == \
        jdev.adapter_stages(jdev.kernel_params(jopt))


def check_step(name, extra, with_stats):
    jopt = _jopt(extra)
    p = jdev.kernel_params(jopt)          # the JAX dict drives both steps
    F = jdev.out_fields(jopt)
    jstep, _ = jdev.get_fast_step(jopt, with_stats=with_stats)
    tstep, _ = tdev.build_fast_step(p, "cpu", with_stats=with_stats)
    SL = jdev.global_stat_len()
    jstate = jdev.init_stats_state(SL)
    tstate = tdev.zero_stats_state(SL, "cpu")
    rng = np.random.default_rng(sum(map(ord, name)))
    regions = [0, 0]
    for L in (128, 1024):
        batch = _rand_batch(rng, 24, L, plant=(START, END),
                            lowq=p["break_enabled"] or p["mask_enabled"])
        for packer in (jdev.pack_input_b5, jdev.pack_input):
            packed = packer(*batch)
            outbuf = jnp.zeros((1, 24, F), jnp.int32)
            if with_stats:
                jstate, jout = jstep(jstate, outbuf, np.int32(0),
                                     jnp.asarray(packed), L)
                rows = tstep(tstate, torch.from_numpy(packed), L)
            else:
                jout = jstep(outbuf, np.int32(0), jnp.asarray(packed), L)
                rows = tstep(torch.from_numpy(packed), L)
            ref = np.asarray(jout)[0]
            assert np.array_equal(rows.numpy(), ref), (
                "%s L=%d %s: first diff %r" % (
                    name, L, packer.__name__,
                    np.argwhere(rows.numpy() != ref)[:5]))
            regions = [a + b for a, b in zip(
                regions, _region_rows(ref, jdev.out_cap(jopt)))]
    # a configuration that found no region tests nothing (on the headline,
    # break at Q22 keeps only the fragments before each read's first
    # region, where the default mask window finds none; the next
    # configuration masks inside such fragments)
    if p["break_enabled"]:
        assert regions[0] > 0
    if p["mask_enabled"] and name != "headline_break_mask":
        assert regions[1] > 0
    if not with_stats:
        return
    jflat = np.asarray(jstate).astype(np.int64)
    tflat, m = tdev.stats_state_to_numpy([tstate])
    assert m == SL
    np.testing.assert_array_equal(tflat, jflat)
    for side in range(2):
        got = tdev.unflatten_side(tflat[side], SL)
        ref = jdev.unflatten_side(jflat[side], SL)
        assert got.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


@pytest.mark.parametrize("name,extra", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_kernel_params_match_jax(name, extra):
    check_kernel_params(extra)


@pytest.mark.parametrize("with_stats", [True, False], ids=["stats",
                                                            "nostats"])
@pytest.mark.parametrize("name,extra", CONFIGS, ids=[c[0] for c in CONFIGS])
def test_step_matches_jax(name, extra, with_stats):
    check_step(name, extra, with_stats)


def test_stats_state_round_trip():
    rng = np.random.default_rng(5)
    SL = 64
    arr = rng.integers(0, 1 << 40, (2, tdev.flat_side_len(SL)))
    st = tdev.stats_state_from_numpy(arr, "cpu")
    back, m = tdev.stats_state_to_numpy([st])
    assert m == SL
    np.testing.assert_array_equal(back, arr)
    cut, m = tdev.stats_state_to_numpy([st], max_seen=20)
    assert m == 32
    np.testing.assert_array_equal(cut[:, :18 * 32], arr[:, :18 * 32])
    np.testing.assert_array_equal(cut[:, 18 * 32:], arr[:, 18 * SL:])
    # partials (one per row slice) are summed before the cut
    part = rng.integers(0, 1 << 40, arr.shape)
    two, m = tdev.stats_state_to_numpy(
        [tdev.stats_state_from_numpy(arr - part, "cpu"),
         tdev.stats_state_from_numpy(part, "cpu")], max_seen=20)
    assert m == 32
    np.testing.assert_array_equal(two, cut)
