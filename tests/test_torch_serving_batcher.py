"""The port's micro-batcher against the reference's, on the CPU.

The batcher is pure logic over a synthetic clock, so the port's copy must
form the reference's batches from the same enqueue/poll schedule, and
the three invariants the service relies on must hold: batches never mix
keys, FIFO holds within a key, and no request outlives its linger
deadline when `due()` is polled on time.  One deliberate difference:
`due()` breaks a tie between two keys' oldest deadlines on the enqueue
sequence number, where the reference sorts BatchKeys and raises
TypeError (ROADMAP.md, R1); the hypothesis counterexample that shows R1
passes here.
"""
import numpy as np
import pytest
import torch

from repro.serving import BatchKey as RefKey
from repro.serving import MicroBatcher as RefBatcher
from repro.serving import SolveRequest as RefRequest

from repro_torch.serving import Batch, BatchKey, MicroBatcher, SolveRequest
from _optional_deps import HAS_HYPOTHESIS, given, settings, st

torch.set_num_threads(1)

KA = BatchKey("patA", "v0")
KB = BatchKey("patB", "v0")
KA_V1 = BatchKey("patA", "v1")
_KEYS = [KA, KB, KA_V1, BatchKey("patC", "v0", dtype="float64")]


def req(key=KA, n=4, tenant="default"):
    return SolveRequest(key=key, b=np.zeros(n), tenant=tenant)


# -- the reference's unit cases ----------------------------------------------

def test_invalid_policy_params_raise():
    with pytest.raises(ValueError):
        MicroBatcher(max_width=0)
    with pytest.raises(ValueError):
        MicroBatcher(max_linger_s=-1.0)


def test_width_flush_returns_full_batch_in_fifo_order():
    mb = MicroBatcher(max_width=3, max_linger_s=1.0)
    r1, r2, r3 = req(), req(), req()
    assert mb.enqueue(r1, now=0.0) is None
    assert mb.enqueue(r2, now=0.1) is None
    batch = mb.enqueue(r3, now=0.2)
    assert batch.reason == "width" and batch.requests == [r1, r2, r3]
    assert mb.pending() == 0


def test_zero_linger_degenerates_to_immediate_width1():
    batch = MicroBatcher(max_width=8, max_linger_s=0.0).enqueue(req(), 0.0)
    assert batch is not None and batch.width == 1


def test_keys_never_mix_on_width_flush():
    mb = MicroBatcher(max_width=2, max_linger_s=1.0)
    mb.enqueue(req(KA), now=0.0)
    assert mb.enqueue(req(KB), now=0.1) is None
    assert mb.enqueue(req(KA_V1), now=0.2) is None
    batch = mb.enqueue(req(KA), now=0.3)
    assert batch.key == KA and batch.width == 2
    assert mb.pending() == 2


def test_linger_deadline_flushes_partial_batch():
    mb = MicroBatcher(max_width=8, max_linger_s=0.5)
    mb.enqueue(req(), now=10.0)
    mb.enqueue(req(), now=10.2)
    assert mb.due(10.4) == []
    assert mb.next_deadline() == pytest.approx(10.5)
    [batch] = mb.due(10.5)
    assert batch.reason == "linger" and batch.width == 2
    assert mb.due(10.5) == [] and mb.next_deadline() is None


def test_due_flushes_multiple_keys_in_deadline_order():
    mb = MicroBatcher(max_width=8, max_linger_s=0.5)
    mb.enqueue(req(KB), now=0.0)
    mb.enqueue(req(KA), now=0.2)
    assert [b.key for b in mb.due(1.0)] == [KB, KA]


def test_flush_all_drains_every_key_oldest_first():
    mb = MicroBatcher(max_width=8, max_linger_s=100.0)
    mb.enqueue(req(KB), now=0.0)
    mb.enqueue(req(KA), now=0.1)
    mb.enqueue(req(KB), now=0.2)
    batches = mb.flush_all()
    assert [b.key for b in batches] == [KB, KA]
    assert [b.width for b in batches] == [2, 1]
    assert all(b.reason == "drain" for b in batches)


def test_stack_and_column_round_trip():
    mb = MicroBatcher(max_width=3, max_linger_s=1.0)
    cols = [np.arange(4, dtype=float) + 10 * j for j in range(3)]
    for c in cols:
        last = mb.enqueue(SolveRequest(key=KA, b=c), now=0.0)
    B = last.stack()
    assert B.shape == (4, 3)
    for j, c in enumerate(cols):
        np.testing.assert_array_equal(last.column(B, j), c)
    one = Batch(key=KA, requests=[req()])
    assert one.stack().shape == (4,)


# -- R1: tied deadlines -------------------------------------------------------

def test_tied_deadlines_flush_in_enqueue_order():
    """Two keys enqueued at one instant tie on their deadline: the port
    flushes them in enqueue order, the reference raises TypeError."""
    mb = MicroBatcher(max_width=8, max_linger_s=0.25)
    mb.enqueue(req(KB), now=0.0)
    mb.enqueue(req(KA), now=0.0)
    assert [b.key for b in mb.due(0.25)] == [KB, KA]
    ref = RefBatcher(max_width=8, max_linger_s=0.25)
    ref.enqueue(RefRequest(key=RefKey("patB", "v0"), b=np.zeros(4)), 0.0)
    ref.enqueue(RefRequest(key=RefKey("patA", "v0"), b=np.zeros(4)), 0.0)
    with pytest.raises(TypeError):
        ref.due(0.25)


def _drive(events, max_width, max_linger_s, cls=MicroBatcher, keys=None,
           make=req):
    """Replay an event schedule, polling due() whenever the next deadline
    has passed; returns (batches, all_requests)."""
    keys = _KEYS if keys is None else keys
    mb = cls(max_width=max_width, max_linger_s=max_linger_s)
    batches, requests = [], []
    now = 0.0
    for key_i, gap, poll in events:
        nd = mb.next_deadline()
        if poll and nd is not None and nd <= now:
            batches.extend(mb.due(now))
        r = make(keys[key_i])
        requests.append(r)
        out = mb.enqueue(r, now)
        if out is not None:
            batches.append(out)
        now += gap
        while True:
            nd = mb.next_deadline()
            if nd is None or nd > now:
                break
            batches.extend(mb.due(nd))
    batches.extend(mb.flush_all(now))
    return batches, requests


def _check_invariants(batches, requests, max_width):
    served = [r for b in batches for r in b.requests]
    assert sorted(r.seq for r in served) == sorted(r.seq for r in requests)
    assert len(served) == len(requests)
    for b in batches:
        assert 1 <= b.width <= max_width
        assert all(r.key == b.key for r in b.requests)
        seqs = [r.seq for r in b.requests]
        assert seqs == sorted(seqs)
        if b.reason != "drain":
            for r in b.requests:
                assert b.t_flush <= r.deadline + 1e-12
    for key in _KEYS:
        seqs = [r.seq for b in batches for r in b.requests if r.key == key]
        assert seqs == sorted(seqs)


def test_r1_counterexample_passes_in_the_port():
    """The reference's failing hypothesis example (ROADMAP.md, R1)."""
    events = [(0, 0.0, False), (1, 0.25, False)]
    batches, requests = _drive(events, 2, 0.25)
    _check_invariants(batches, requests, 2)
    assert [b.key for b in batches] == [KA, KB]


# each event: (key_index, gap to next event, poll_before_enqueue)
_EVENTS = st.lists(
    st.tuples(st.integers(min_value=0, max_value=3),
              st.floats(min_value=0.0, max_value=0.3,
                        allow_nan=False, allow_infinity=False),
              st.booleans()),
    min_size=1, max_size=60) if HAS_HYPOTHESIS else None


@pytest.mark.skipif(not HAS_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=200, deadline=None)
@given(events=_EVENTS,
       max_width=st.integers(min_value=1, max_value=5),
       linger=st.floats(min_value=0.0, max_value=0.5,
                        allow_nan=False, allow_infinity=False))
def test_batcher_invariants(events, max_width, linger):
    batches, requests = _drive(events, max_width, linger)
    _check_invariants(batches, requests, max_width)


_REF_KEYS = [RefKey(k.pattern_fp, k.value_fp, dtype=k.dtype) for k in _KEYS]


@pytest.mark.skipif(not HAS_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=150, deadline=None)
@given(events=_EVENTS,
       max_width=st.integers(min_value=1, max_value=5),
       linger=st.floats(min_value=0.0, max_value=0.5,
                        allow_nan=False, allow_infinity=False))
def test_batches_match_the_reference(events, max_width, linger):
    """Where the reference forms its batches (no tied deadlines), the port
    forms the same: keys, widths, reasons, flush times and members."""
    try:
        ref, _ = _drive(events, max_width, linger, cls=RefBatcher,
                        keys=_REF_KEYS,
                        make=lambda k: RefRequest(key=k, b=np.zeros(4)))
    except TypeError:           # R1: the reference cannot order a tie
        return
    got, _ = _drive(events, max_width, linger)

    def shape(batches):
        return [((b.key.pattern_fp, b.key.value_fp, b.key.dtype), b.width,
                 b.reason, b.t_flush, [r.seq for r in b.requests])
                for b in batches]

    assert shape(got) == shape(ref)


@pytest.mark.skipif(not HAS_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=100, deadline=None)
@given(n=st.integers(min_value=1, max_value=40),
       max_width=st.integers(min_value=1, max_value=6))
def test_width_flush_exact_multiples(n, max_width):
    mb = MicroBatcher(max_width=max_width, max_linger_s=10.0)
    flushed = 0
    for _ in range(n):
        out = mb.enqueue(req(), now=0.0)
        if out is not None:
            assert out.width == max_width
            flushed += 1
    assert flushed == n // max_width
    assert mb.pending() == n % max_width
