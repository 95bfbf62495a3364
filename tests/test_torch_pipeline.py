"""The port's token loader and fault drills against the reference on the
CPU.

Both packages write the same corpus into their own store and stream it
back; the batches must be equal bit for bit and equal the corpus itself:
contiguous slices in the seeded sample order, labels shifted by one.
Every test builds its own clients and closes them (no module-scoped
fixture: the reference's own `corpus_client` pattern is a known source of
failures under its leak witness).
"""
import numpy as np
import pytest

from repro.core.client import ROS2Client as RefClient
from repro.data import pipeline as rpipe
from repro.distributed import fault as rfault
from repro_torch.core import ROS2Client
from repro_torch.data import pipeline
from repro_torch.distributed import fault


@pytest.fixture
def clients(request):
    mode = getattr(request, "param", "host")
    made = []

    def make():
        pair = (RefClient(mode=mode, transport="rdma"),
                ROS2Client(mode=mode, transport="rdma", device="cpu"))
        made.extend(pair)
        return pair
    yield make
    for c in made:
        c.close()


def _corpus(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 50_000, n,
                                                dtype=np.int32)


def _expected(tokens, asg: pipeline.Assignment, step: int, seq: int):
    rows = np.stack([tokens[i * (seq + 1):(i + 1) * (seq + 1)]
                     for i in asg.samples_for_step(step)])
    return rows[:, :-1], rows[:, 1:]


def _assert_batch(batch, tokens, asg, step, seq):
    want_t, want_l = _expected(tokens, asg, step, seq)
    assert batch["tokens"].dtype == np.int32
    np.testing.assert_array_equal(batch["tokens"], want_t)
    np.testing.assert_array_equal(batch["labels"], want_l)
    np.testing.assert_array_equal(batch["labels"][:, :-1],
                                  batch["tokens"][:, 1:])


@pytest.mark.parametrize("clients,dp_rank,dp_size,seed,seq", [
    ("host", 0, 1, 0, 33),
    ("dpu", 1, 2, 5, 100),
    ("host", 3, 4, 3, 40),
], indirect=["clients"])
def test_batches_match_reference_and_corpus(clients, dp_rank, dp_size, seed,
                                            seq):
    """Fourteen batches, across an epoch boundary and across shard files
    (512-token shards): equal to the reference's and to the corpus."""
    ref, port = clients()
    tokens = _corpus(3000, seed)
    for c, mod in ((ref, rpipe), (port, pipeline)):
        meta = mod.write_token_shards(c, "/data", tokens, shard_tokens=512)
        assert meta == mod.read_meta(c, "/data")
    kw = dict(global_batch=8, seq_len=seq, dp_rank=dp_rank, dp_size=dp_size,
              seed=seed, prefetch=2, hedge_timeout_s=0.5)
    rl = rpipe.ROS2TokenLoader(ref, "/data", **kw)
    pl = pipeline.ROS2TokenLoader(port, "/data", **kw)
    try:
        n_samples = tokens.size // (seq + 1)
        per_epoch = n_samples // 8
        assert per_epoch < 14
        for n in range(14):
            epoch, step = divmod(n, per_epoch)
            asg = pipeline.Assignment(n_samples, 8, dp_rank, dp_size, seed,
                                      epoch)
            got, want = pl.next_batch(), rl.next_batch()
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(got[key], want[key])
            _assert_batch(got, tokens, asg, step, seq)
        assert pl.metrics()["batches"] == rl.metrics()["batches"] == 14
    finally:
        rl.close()
        pl.close()


def test_reshard_reads_the_new_assignment(clients):
    """After reshard the local batch halves and every batch is a step of
    the new assignment, in both packages."""
    ref, port = clients()
    tokens = _corpus(40_000, 1)
    seq = 15
    n_samples = tokens.size // (seq + 1)
    for c, mod in ((ref, rpipe), (port, pipeline)):
        mod.write_token_shards(c, "/data", tokens, shard_tokens=4096)
    loaders = [mod.ROS2TokenLoader(c, "/data", global_batch=4, seq_len=seq)
               for c, mod in ((ref, rpipe), (port, pipeline))]
    try:
        first = [ld.next_batch() for ld in loaders]
        np.testing.assert_array_equal(first[0]["tokens"], first[1]["tokens"])
        _assert_batch(first[1], tokens,
                      pipeline.Assignment(n_samples, 4, 0, 1, 0, 0), 0, seq)
        new = pipeline.Assignment(n_samples, 4, 1, 2, 0, 0)
        for ld in loaders:
            ld.reshard(dp_rank=1, dp_size=2)
            for _ in range(3):
                b = ld.next_batch()
                assert b["tokens"].shape == (2, seq)
                # a prefetched batch of the old assignment is dropped, so
                # the step is known only to lie after the first
                steps = [s for s in range(1, 12) if np.array_equal(
                    b["tokens"], _expected(tokens, new, s, seq)[0])]
                assert len(steps) == 1, steps
                _assert_batch(b, tokens, new, steps[0], seq)
    finally:
        for ld in loaders:
            ld.close()


def test_assignment_and_coverage_match_reference():
    for n, gb, size, seed, epoch in ((64, 8, 4, 0, 0), (250, 10, 5, 7, 3)):
        for r in range(size):
            a = pipeline.Assignment(n, gb, r, size, seed, epoch)
            b = rpipe.Assignment(n, gb, r, size, seed, epoch)
            assert a.steps_per_epoch() == b.steps_per_epoch()
            for step in range(a.steps_per_epoch()):
                np.testing.assert_array_equal(a.samples_for_step(step),
                                              b.samples_for_step(step))
        assert pipeline.coverage_check(n, gb, size, seed, epoch) is True
        assert rpipe.coverage_check(n, gb, size, seed, epoch) is True


def test_drill_reads_from_replicas_and_hedges_fire(clients):
    """The drill of launch/train.py on the port's store: a killed device's
    extents come back from their replicas, and a stalled replica makes the
    loader's extent-level hedge fire, as in the reference."""
    _, port = clients()
    tokens = _corpus(4096, 2)
    pipeline.write_token_shards(port, "/data", tokens, shard_tokens=4096)
    inj = fault.FailureInjector(port.store)
    inj.kill(port.devices[0].name)
    assert inj.events == [f"kill:{port.devices[0].name}"]
    ld = pipeline.ROS2TokenLoader(port, "/data", global_batch=4, seq_len=31)
    try:
        _assert_batch(ld.next_batch(), tokens,
                      pipeline.Assignment(128, 4, 0, 1, 0, 0), 0, 31)
    finally:
        ld.close()
    pipeline.write_token_shards(port, "/hedge", tokens, shard_tokens=4096)
    oid = port.dfs.stat("/hedge/shard-00000")["oid"]
    ext = port.container.object(oid)._extents[("0", "data")][0]
    port.store.device(next(iter(ext.block_keys))).read_delay_s = 0.2
    ld = pipeline.ROS2TokenLoader(port, "/hedge", global_batch=1, seq_len=15,
                                  hedge_timeout_s=0.02)
    try:
        assert ld.next_batch()["tokens"].shape == (1, 15)
        assert ld.hedges_issued >= 1 and ld.hedges_won >= 1
    finally:
        ld.close()


def test_straggler_monitor_and_membership_match_reference():
    times = np.random.default_rng(4).uniform(0.5, 1.5, (3, 20))
    times[2] *= 3.0                       # rank 2 straggles
    mons = [fault.StragglerMonitor(window=8), rfault.StragglerMonitor(window=8)]
    for m in mons:
        for r in range(3):
            for t in times[r]:
                m.record(r, float(t))
    assert mons[0].medians() == mons[1].medians()
    assert mons[0].stragglers() == mons[1].stragglers() == [2]
    seen = [[], []]
    members = [fault.ElasticMembership(3), rfault.ElasticMembership(3)]
    for m, log in zip(members, seen):
        m.subscribe(lambda asg, size, log=log: log.append((asg, size)))
        m.join("host9")
        m.leave("host1")
        m.join("host0")                   # already a member: no event
    assert seen[0] == seen[1] and len(seen[0]) == 2
    assert members[0].generation == members[1].generation == 2
