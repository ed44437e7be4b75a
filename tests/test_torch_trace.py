"""The violation microscope on the port against the JAX package.

`run_traced` records come out of the same step a sweep runs; the same seed
and config through both faces on the CPU must give the same TraceRecord
stream leaf for leaf, the same final state (`key` included: the traced run
is a fixed number of ungated steps, as the JAX scan), and the same
`trace_seed` events, whose `str` is byte-equal (repro bundles carry those
strings). Covered: the shape of tests/test_trace.py (1 lane, 2 virtual s,
partitions), every chaos kind under the default and a suppressing ctl, the
device chaos stream against the pure schedule, and run_batch's trace leg.
Tolerance: exact.
"""

import dataclasses

import numpy as np
import pytest

from madsim_tpu import triage as jtri
from madsim_tpu.tpu import BatchedSim as JaxSim
from madsim_tpu.tpu import SimConfig as JaxConfig
from madsim_tpu.tpu import make_raft_spec as jax_raft_spec
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu.tpu import run_batch as jax_run_batch
from madsim_tpu.tpu import trace as jtrace
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch import triage
from madsim_tpu_torch.tpu import BatchedSim, SimConfig, make_raft_spec, run_batch
from madsim_tpu_torch.tpu import nemesis as ttn
from madsim_tpu_torch.tpu import trace
from madsim_tpu_torch.tpu.convert import state_to_numpy
from madsim_tpu_torch.tpu.engine import TraceRecord
from test_torch_batch import _faces
from test_torch_engine import assert_leaves_equal
from test_torch_triage import every_clause, every_clause_faces, jax_leaves

KIND_NAMES = ("REQUEST_VOTE", "VOTE_RESP", "APPEND", "APPEND_RESP", "SNAP")


def partition_config(m, **kw):
    """tests/test_trace.py's partition config on face `m`'s SimConfig."""
    defaults = dict(
        horizon_us=8_000_000, loss_rate=0.05,
        partition_interval_lo_us=300_000, partition_interval_hi_us=1_500_000,
        partition_heal_lo_us=500_000, partition_heal_hi_us=2_000_000,
    )
    defaults.update(kw)
    return m(**defaults)


def assert_records_equal(recs, jrecs, T):
    assert recs.clock.shape[:2] == (T, 1)
    for f in TraceRecord._fields:
        mine, theirs = getattr(recs, f), getattr(jrecs, f)
        if mine is None:
            assert theirs is None, f
            continue
        np.testing.assert_array_equal(
            mine.numpy().astype(np.int64),
            np.asarray(theirs).astype(np.int64), err_msg=f,
        )


def assert_events_equal(events, jevents):
    assert [str(e) for e in events] == [str(e) for e in jevents]
    assert [dataclasses.asdict(e) for e in events] == [
        dataclasses.asdict(e) for e in jevents]


def test_run_traced_equals_the_jax_scan_and_the_batch_lane():
    """tests/test_trace.py:63's shape: seed 7, 2 virtual s, partitions,
    20000 steps. The lane finishes after a few hundred steps; the rest are
    idle steps (the port runs them as lane blocks of one step), and the
    records, the final state and the events still equal the JAX scan's.
    The traced lane is the batch lane: seed 7 of a 17-lane run."""
    cfg = partition_config(SimConfig, horizon_us=2_000_000)
    jcfg = partition_config(JaxConfig, horizon_us=2_000_000)
    sim = BatchedSim(make_raft_spec(5), cfg, device="cpu")
    jsim = JaxSim(jax_raft_spec(5), jcfg)
    st, recs = sim.run_traced(7, max_steps=20_000)
    jst, jrecs = jsim.run_traced(7, max_steps=20_000)
    assert_records_equal(recs, jrecs, 20_000)
    final = state_to_numpy(st)
    assert_leaves_equal(jax_leaves(jst), final, "traced final state")
    assert final["done"].all() and final["steps"][0] < 1000
    events = trace.extract_trace(recs, kind_names=KIND_NAMES)
    assert_events_equal(
        events, jtrace.extract_trace(jrecs, kind_names=KIND_NAMES))
    assert {"split", "heal", "deliver", "timer"} <= {e.kind for e in events}
    batch = state_to_numpy(sim.run(range(17), max_steps=20_000))
    single = {k: v[0] for k, v in final.items() if k != "key"}
    lane = {k: v[7] for k, v in batch.items() if k != "key"}
    assert_leaves_equal(lane, single, "seed 7: traced lane vs batch lane")


SUPPRESS = {
    "default": None,
    "suppressed": dict(off_clauses=("wipe", "clog"),
                       occ_off={"crash": 0b11, "reconfig": 0b10,
                                "disk": 0b1, "partition": 0b100},
                       rate_scale={"dup": 0.5, "loss": 0.25}),
}


@pytest.mark.parametrize("name", list(SUPPRESS))
def test_trace_seed_with_every_chaos_kind_equals_the_jax_face(name):
    """Every clause kind, under the default ctl and under a ctl that
    suppresses occurrences, turns clauses off and scales rates: the
    traced events of seed 3 equal the JAX face's, suppressed faults
    absent from both."""
    cfg, jcfg = every_clause_faces(horizon_us=1_500_000)
    sim = BatchedSim(make_raft_spec(5), cfg, triage=True, device="cpu")
    jsim = JaxSim(jax_raft_spec(5), jcfg, triage=True)
    kw = SUPPRESS[name]
    ctl = jctl = None
    if kw is not None:
        ctl = triage.build_ctl(1, cfg.horizon_us, **kw)
        jctl = jtri.build_ctl(1, cfg.horizon_us, **kw)
    events = trace.trace_seed(sim, 3, max_steps=600, kind_names=KIND_NAMES,
                              ctl=ctl)
    jevents = jtrace.trace_seed(jsim, 3, max_steps=600, kind_names=KIND_NAMES,
                                ctl=jctl)
    assert_events_equal(events, jevents)
    kinds = {e.kind for e in events}
    assert {"crash", "split", "heal", "spike_on", "remove", "join",
            "disk_slow", "disk_crash", "disk_recover"} <= kinds
    if kw is None:
        assert {"restart", "clog", "unclog"} <= kinds
    else:
        assert not {"clog", "unclog"} & kinds


def test_device_chaos_stream_matches_the_filtered_schedule():
    """The twin check on the port: under a suppressing ctl the device's
    chaos stream equals the occurrence-filtered pure schedule, and equals
    the JAX face's device stream."""
    cfg, jcfg = every_clause_faces(horizon_us=1_500_000)
    occ_off = {"crash": 0b1, "reconfig": 0b10, "disk": 0b1}
    sim = BatchedSim(make_raft_spec(5), cfg, triage=True, device="cpu")
    jsim = JaxSim(jax_raft_spec(5), jcfg, triage=True)
    ctl = triage.build_ctl(1, cfg.horizon_us, occ_off=occ_off)
    jctl = jtri.build_ctl(1, cfg.horizon_us, occ_off=occ_off)
    n = ttn.assert_device_matches_schedule(
        sim, every_clause(tn), 11, horizon_us=cfg.horizon_us,
        max_steps=600, ctl=ctl, occ_off=occ_off)
    assert n > 20
    got = ttn.device_chaos_events(sim, 11, max_steps=600,
                                  horizon_us=cfg.horizon_us, ctl=ctl)
    want = jtn.device_chaos_events(jsim, 11, max_steps=600,
                                   horizon_us=cfg.horizon_us, ctl=jctl)
    assert got == want and len(got) == n
    # a schedule the device did not run is caught
    with pytest.raises(AssertionError, match="chaos stream"):
        ttn.assert_device_matches_schedule(
            sim, every_clause(tn), 11, horizon_us=cfg.horizon_us,
            max_steps=600, ctl=ctl, occ_off={})


def test_run_batch_trace_leg_equals_the_jax_face():
    """run_batch's max_traces leg traces the first violating seeds with the
    workload's max_steps, as the JAX face's run_batch does."""
    jwl, twl = _faces(True)
    jr = jax_run_batch(range(12), jwl, repro_on_host=False, chunk=6,
                       mesh=None, max_traces=2)
    tr = run_batch(range(12), twl, chunk=6, device="cpu", max_traces=2)
    assert list(tr.traces) == list(jr.traces) == tr.violating_seeds[:2]
    for seed, events in tr.traces.items():
        assert_events_equal(events, jr.traces[seed])
        assert events[-1].kind == "violation"


EVENTS = [
    dict(kind="deliver", node=2, src=4, msg_kind=2, msg_name="APPEND",
         payload=(7, 49, -1)),
    dict(kind="deliver", node=0, src=1, msg_kind=9, payload=()),
    dict(kind="timer", node=3),
    dict(kind="crash", node=1),
    dict(kind="restart", node=1),
    dict(kind="split", detail="[0, 2] | [1, 3, 4]"),
    dict(kind="heal"),
    dict(kind="clog", node=1, src=3, detail="1->3"),
    dict(kind="unclog"),
    dict(kind="spike_on"),
    dict(kind="spike_off"),
    dict(kind="remove", node=4),
    dict(kind="join", node=4),
    dict(kind="disk_slow", node=0),
    dict(kind="disk_crash", node=0, detail="torn"),
    dict(kind="disk_crash", node=0),
    dict(kind="disk_recover", node=0, detail="torn"),
    dict(kind="violation", detail="invariant check failed"),
    dict(kind="deadlock", detail="no runnable events"),
]


@pytest.mark.parametrize("i", range(len(EVENTS)),
                         ids=[f"{i}-{e['kind']}" for i, e in enumerate(EVENTS)])
def test_event_str_is_byte_equal_to_the_jax_face(i):
    for t_us, step in ((0, 0), (3_690_748, 452), (123_456_789_012, 99_999)):
        kw = dict(EVENTS[i], step=step, t_us=t_us)
        assert str(trace.TraceEvent(**kw)) == str(jtrace.TraceEvent(**kw))
    assert trace.format_trace([trace.TraceEvent(**kw)] * 2) == (
        jtrace.format_trace([jtrace.TraceEvent(**kw)] * 2))
