"""The traffic generator repeats from a seed, gives every seed the same
work, and draws what the mix files say."""
import math
from collections import Counter
from statistics import NormalDist

import numpy as np
import pytest

from portbench.spec import HERE, load_json
from portbench.tests.tiny import tiny_mix
from portbench.traffic import Traffic, wave_lengths

MIXES = sorted(p.stem for p in (HERE / "mixes").glob("*.json"))
BATCH = {"rag": 32, "chat": 96}


def _waves(t, n=3):
    return [[(r.rid, tuple(r.items), r.max_new) for r in t.wave()]
            for _ in range(n)]


@pytest.mark.parametrize("mix", MIXES)
def test_a_seed_repeats_and_seeds_differ(mix):
    m = load_json(HERE / "mixes" / f"{mix}.json")
    a, b, c = (Traffic(m, 1000, BATCH[mix], s) for s in (2**33 + 1,
                                                         2**33 + 1, 5))
    assert _waves(a) == _waves(b)
    assert _waves(a) != _waves(c)
    small = tiny_mix(mix)
    pa, pb = (Traffic(small, 1000, 4, s).pool() for s in (9, 9))
    assert np.array_equal(pa, pb) and pa.dtype == np.int32
    assert pa.min() >= 0 and pa.max() < 1000


@pytest.mark.parametrize("mix", MIXES)
def test_every_wave_asks_for_the_same_lengths(mix):
    m = load_json(HERE / "mixes" / f"{mix}.json")
    want = Counter(wave_lengths(m["new_tokens"], BATCH[mix]))
    for seed in (1, 2, 2**40):
        t = Traffic(m, 1000, BATCH[mix], seed)
        for _ in range(4):
            assert Counter(r.max_new for r in t.wave()) == want


@pytest.mark.parametrize("mix", MIXES)
def test_requests_follow_the_mix_file(mix):
    m = load_json(HERE / "mixes" / f"{mix}.json")
    t = Traffic(m, 1000, BATCH[mix], 11)
    p = m["prompt"]
    assert t.prompt_len == p["items"] * p["item_tokens"]
    d = m["new_tokens"]
    lo, hi = d["min"], d["max"]
    for r in t.wave():
        assert len(r.items) == p["items"] == len(set(r.items.tolist()))
        assert 0 <= r.items.min() and r.items.max() < m["pool"]["items"]
        assert lo <= r.max_new <= hi
    q = wave_lengths(d, 4)
    for j, n in enumerate(q):
        u = (j + 0.5) / 4
        if d["dist"] == "log_uniform":
            want = math.exp(math.log(lo) + (math.log(hi) - math.log(lo)) * u)
        else:
            want = d["median"] * math.exp(d["sigma"]
                                          * NormalDist().inv_cdf(u))
        assert n == min(max(round(want), lo), hi)


def test_zipf_popularity_concentrates_reads():
    m = load_json(HERE / "mixes" / "rag.json")
    t = Traffic(m, 1000, 16, 3)
    reqs = [r for _ in range(20) for r in t.wave()]
    counts = Counter(int(i) for r in reqs for i in r.items)
    top = counts.most_common(1)[0][1]
    # Zipf 0.99 over 2,097,152 items: the first rank takes ~6.4% of draws,
    # so it is among most requests' 30 distinct passages (uniform: 0.0014%)
    assert top > 0.5 * len(reqs)


def test_prompt_is_the_items_tokens_in_order():
    t = Traffic(tiny_mix("rag"), 1000, 4, 1)
    pool = t.pool()
    r = t.wave()[0]
    got = t.prompt(pool, r.items)
    assert got.shape == (t.prompt_len,)
    assert np.array_equal(got[:t.item_tokens], pool[r.items[0]])
