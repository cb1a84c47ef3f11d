"""stat_batch_into, the step's statistics call, against the JAX package on
the CPU.

The JAX side is fastplong_tpu's stat_batch for each slot, laid out by its
step's _flat_partial, summed over the slots and added to the same random
non-zero starting accumulator; the port adds the slots of an [S, B] span
stack into that accumulator in one call.  Every value is an integer, so
the accumulators and the medians must be equal (tolerance 0).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fastplong_tpu.ops import stats_kernels as js
from fastplong_tpu.pipeline import device as jdev
from fastplong_tpu_torch.ops import stats_kernels as ts


def _slots(seed, S, B, L, zero_lo):
    """Every byte value in bases and quals, ACGTU-rich rows for the 5-mers,
    and per slot: spans from before the row to past its end, empty and
    inverted spans, and rows with read_mask off."""
    rng = np.random.default_rng(seed)
    bases = rng.integers(0, 256, (B, L)).astype(np.uint8)
    quals = rng.integers(0, 256, (B, L)).astype(np.uint8)
    for i in range(1, B, 2):
        bases[i] = rng.choice(np.frombuffer(b"ACGTUN", np.uint8), L,
                              p=[.22, .22, .22, .22, .06, .06])
        quals[i] = rng.integers(33, 75, L)
    lo = rng.integers(-2, L // 2, (S, B)).astype(np.int32)
    hi = (lo + rng.integers(-3, L, (S, B))).astype(np.int32)
    if zero_lo:
        lo[:] = 0
    mask = rng.random((S, B)) < 0.8
    mask[:, 0] = False
    lo[0, 1], hi[0, 1] = 0, L
    lo[-1, 2], hi[-1, 2] = L - 3, L + 4
    return bases, quals, lo, hi, mask


def _start(seed, SL):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << 40), 1 << 40, ts.flat_side_len(SL))


@pytest.mark.parametrize("zero_lo", [True, False], ids=["pre", "post"])
@pytest.mark.parametrize("S,B,L,SL", [(1, 24, 128, 128), (2, 24, 128, 256),
                                      (4, 16, 200, 200), (4, 9, 37, 64),
                                      (2, 30, 120, 1024)],
                         ids=["S1", "S2_L_below_SL", "S4", "S4_short",
                              "S2_SL1024"])
def test_stat_batch_into_matches_jax(S, B, L, SL, zero_lo):
    bases, quals, lo, hi, mask = _slots(S * 100 + L, S, B, L, zero_lo)
    start = _start(L, SL)
    ref = start.copy()
    ref_med = []
    for k in range(S):
        part = js.stat_batch(jnp.asarray(bases), jnp.asarray(quals),
                             jnp.asarray(lo[k]), jnp.asarray(hi[k]),
                             jnp.asarray(mask[k]), zero_lo=zero_lo)
        ref += np.asarray(jdev._flat_partial(part, SL)).astype(np.int64)
        ref_med.append(np.asarray(part["median"]))
    side = torch.from_numpy(start.copy())
    med = ts.stat_batch_into(side, *(torch.from_numpy(a) for a in
                                     (bases, quals, lo, hi, mask)),
                             zero_lo=zero_lo)
    np.testing.assert_array_equal(side.numpy(), ref)
    np.testing.assert_array_equal(med.numpy(), np.stack(ref_med))
    assert med.dtype == torch.uint8 and med.shape == (S, B)
    # the batch's statistics landed, and cycles past L kept their values
    assert (side.numpy() != start).any()
    np.testing.assert_array_equal(side.numpy()[18 * L:18 * SL],
                                  start[18 * L:18 * SL])


def test_stat_batch_into_refuses_a_short_accumulator():
    """A batch longer than the accumulator's cycle length is refused."""
    bases, quals, lo, hi, mask = _slots(1, 1, 4, 64, False)
    side = torch.zeros(ts.flat_side_len(32), dtype=torch.int64)
    with pytest.raises(ValueError):
        ts.stat_batch_into(side, *(torch.from_numpy(a) for a in
                                   (bases, quals, lo, hi, mask)))
