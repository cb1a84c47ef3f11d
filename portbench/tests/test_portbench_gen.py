"""The traffic generator: deterministic by seed, the same sizes for every
seed, and Badread's read model as the mix gives it."""

import json
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
from portbench import gen


def mix(**kw):
    with open(os.path.join(ROOT, "portbench", "traffic", "chunks.json")) as f:
        m = json.load(f)
    m.update(kw)
    return m


def parse(buf):
    lines = bytes(buf).split(b"\n")
    assert lines[-1] == b""
    recs = [lines[i:i + 4] for i in range(0, len(lines) - 1, 4)]
    return recs


def test_same_seed_same_bytes_and_other_seed_other_bytes():
    m = mix(reads_per_file=300)
    a = gen.file_bytes(m, 1, 2 ** 33 + 7)
    b = gen.file_bytes(m, 1, 2 ** 33 + 7)
    c = gen.file_bytes(m, 1, 5)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def test_every_seed_gives_the_same_sizes():
    m = mix(reads_per_file=400)
    lens = []
    for seed in (1, 2, 2 ** 31 + 3):
        recs = parse(gen.file_bytes(m, 0, seed))
        lens.append(sorted(len(r[1]) for r in recs))
    assert lens[0] == lens[1] == lens[2]


def test_the_plan_follows_the_mix():
    """Lengths, identities, adapter rates and amounts, chimeras, junk and
    glitches, on 4,000 reads against the mix's parameters."""
    m = mix()
    plan = gen.file_plan(m, 0)
    n = len(plan.lens)
    assert n == 4000
    frags = np.array([p for ps in plan.pieces for p in ps
                      if isinstance(p, int)])
    # gamma of mean 15,000 and standard deviation 13,000: 4 standard errors
    assert abs(frags.mean() - 15000) < 4 * 13000 / len(frags) ** 0.5
    assert abs(frags.std() - 13000) < 1500
    ident = 1 - plan.err
    assert abs(ident.mean() - 0.95) < 0.002
    assert abs(ident.std() - 0.025) < 0.002 and ident.max() <= 0.99
    single = [ps for ps in plan.pieces if len(ps) == 3]
    chimeras = n - len(single)
    assert 15 <= chimeras <= 70                       # 1% of 4,000
    assert 15 <= sum(k > 0 for k in plan.junk) <= 70  # 1%
    s_ad, e_ad = len(m["start_adapter"]), len(m["end_adapter"])
    heads = [ps[0] for ps in single]
    tails = [ps[2] for ps in single]
    # a piece can be empty where it is present but its share rounds to 0
    s_rate = np.mean([len(h) > 0 for h in heads])
    e_rate = np.mean([len(t) > 0 for t in tails])
    assert 0.85 < s_rate <= 0.9 + 0.03 and 0.4 < e_rate <= 0.5 + 0.03
    s_amount = np.mean([len(h) for h in heads if h]) / s_ad
    e_amount = np.mean([len(t) for t in tails if t]) / e_ad
    assert abs(s_amount - 0.6) < 0.05 and abs(e_amount - 0.2) < 0.06
    # the pieces are the start adapter's end and the end adapter's start,
    # with errors by the read's identity (about 5%)
    from portbench.reference import edit_distance
    s_seq, e_seq = m["start_adapter"].encode(), m["end_adapter"].encode()
    ed = [edit_distance(h, s_seq[s_ad - len(h):]) / len(h)
          for h in heads if len(h) >= 8]
    assert 0.02 < np.mean(ed) < 0.08
    ed = [edit_distance(t, e_seq[:len(t)]) / len(t)
          for t in tails if len(t) >= 8]
    assert 0.02 < np.mean(ed) < 0.08
    glitches = sum(len(g) for g in plan.glitches)
    expect = plan.lens.sum() / m["glitch_rate"]
    assert abs(glitches - expect) < 5 * expect ** 0.5


def test_records_and_qualities():
    m = mix(reads_per_file=1500)
    plan = gen.file_plan(m, 2)
    buf = gen.file_bytes(m, 2, 99, plan)
    recs = parse(buf)
    assert len(recs) == 1500
    for i, (name, seq, plus, qual) in enumerate(recs):
        assert name == b"@read%d" % i
        assert plus == b"+"
        assert len(seq) == len(qual)
    assert sorted(len(r[1]) for r in recs) == sorted(plan.lens.tolist())
    body = np.frombuffer(b"".join(r[1] for r in recs), np.uint8)
    assert set(np.unique(body).tolist()) == set(b"ACGT")
    q = np.frombuffer(b"".join(r[3] for r in recs), np.uint8) - 33
    assert q.min() >= 0 and q.max() <= m["assumed"]["qual_max"]
    # a base's error probability averages the read's error rate (1 -
    # identity), but for the glitches' random bases and the cap at Q0
    p = 10.0 ** (-q.astype(np.float64) / 10.0)
    assert abs(p.mean() - plan.err.mean()) < 0.15 * plan.err.mean()
    # junk reads repeat a k-mer of at most 5 bases
    assert gen.count_bases(buf) == len(body)


def test_warm_file_holds_the_longest_reads(tmp_path):
    m = mix(reads_per_file=600, files=3)
    files, (warm, _) = gen.write_files(m, 11, str(tmp_path))
    assert len(files) == 3
    longest = max(len(r[1]) for p, _ in files
                  for r in parse(np.fromfile(p, np.uint8)))
    wl = [len(r[1]) for r in parse(np.fromfile(warm, np.uint8))]
    assert max(wl) == longest
    assert len(wl) == len(range(0, 600, 16)) + 3 * 16
