"""The causal-lineage plane on the port against the JAX package: the engine
(phase 3b's event ids and Lamport clocks, phase 6's send stamps in both
pools), the trace record, the state converter and the digests.

The same seeds and configs go through both faces on the CPU:
  * lineage leaves (`lin.lam`, `lin.eid`, `msgs.sent_eid`,
    `strag.sent_eid`) equal the JAX face's on the fused Raft bench config,
    a two-handler Raft at unequal ring depths and the 5% heavy-tail 2PC
    with stragglers, and on a refill sweep (re-admitted lanes included);
  * with lineage on and off every other leaf (and every refill row) is
    identical: the plane is observe-only;
  * the u32 event counter wraps and the epoch rebases alike on both faces
    from a JAX state loaded through `convert.state_from_numpy`;
  * the 16-lane, 1500-step Raft golden run with lineage on keeps digest
    `GOLDEN["raft"]`, and its lineage leaves hash to `PINNED_LINEAGE` on
    both faces;
  * the planted re-stamp seed's traced records (`lam`, `evt_eid`,
    `sent_eid`) and decoded events equal the JAX face's, and so do the
    happens-before graphs `graph_from_trace` builds from them, on the
    two-handler and straggler paths too.

Tolerances: exact everywhere (integer leaves widened to int64).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import bench
import chip_smoke
from madsim_tpu import causal as jcausal
from madsim_tpu import nemesis as jn
from madsim_tpu.tpu import BatchedSim as JaxSim
from madsim_tpu.tpu import SimConfig as JaxConfig
from madsim_tpu.tpu import make_raft_spec as jax_raft_spec
from madsim_tpu.tpu import make_twopc_spec as jax_twopc_spec
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu.tpu.engine import named_leaves
from madsim_tpu.tpu.engine import refill_results as jax_refill_results
from madsim_tpu.tpu.spec import replace_handlers as jax_replace_handlers
from madsim_tpu.tpu.trace import extract_trace as jax_extract_trace
from madsim_tpu_torch import causal
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch.tpu import (
    BatchedSim, SimConfig, make_raft_spec, make_twopc_spec, raft_bench_config,
)
from madsim_tpu_torch.tpu import nemesis as ttn
from madsim_tpu_torch.tpu.convert import state_from_numpy, state_to_numpy
from madsim_tpu_torch.tpu.digest import (
    GOLDEN, LINEAGE_LEAVES, PINNED_LINEAGE, canonical_digest, golden_run,
    lineage_digest,
)
from madsim_tpu_torch.tpu.engine import refill_results
from madsim_tpu_torch.tpu.raft import RaftState
from madsim_tpu_torch.tpu.spec import replace_handlers
from madsim_tpu_torch.tpu.trace import extract_trace
from test_buggify import quiet_config as jax_quiet_config
from test_state_layout import CHAOS_PLAN as JAX_CHAOS_PLAN
from test_state_layout import canonical_digest as jax_canonical_digest
from test_torch_engine import _shift_to_rebase, assert_leaves_equal, jax_leaves
from test_triage import _sched_workload

M32 = 0xFFFFFFFF


def _is_lineage(name):
    return name.startswith("lin.") or name.endswith(".sent_eid")


def _without_lineage(leaves):
    return {k: v for k, v in leaves.items() if not _is_lineage(k)}


def _two_handler(face):
    """Raft with its fused on_event cleared: the two-handler path."""
    if face == "jax":
        spec = jax_raft_spec(5)
        return jax_replace_handlers(spec, on_message=spec.on_message)
    spec = make_raft_spec(5)
    return replace_handlers(spec, on_message=spec.on_message)


TWO_HANDLER = dict(
    horizon_us=2_000_000, loss_rate=0.05, msg_depth_msg=1, msg_depth_timer=3,
    crash_interval_lo_us=300_000, crash_interval_hi_us=900_000,
    partition_interval_lo_us=300_000, partition_interval_hi_us=900_000,
)


def _case(name):
    """(JAX spec, JAX config, port spec, port config, lanes, steps)."""
    if name == "raft_bench":
        kw = dict(n_nodes=5, client_rate=0.1, log_capacity=16)
        return (jax_raft_spec(**kw), bench.raft_bench_config(2.0),
                make_raft_spec(**kw), raft_bench_config(2.0), 32, 200)
    if name == "raft_two_handler":
        return (_two_handler("jax"), JaxConfig(**TWO_HANDLER),
                _two_handler("torch"), SimConfig(**TWO_HANDLER), 32, 150)
    # tests/test_buggify.py's quiet config with a 5% heavy tail (1-5 s):
    # the tail sends ride the straggler pool and come due past 1 s
    jcfg = jax_quiet_config(buggify_delay_rate=0.05)
    return (jax_twopc_spec(5), jcfg, make_twopc_spec(5),
            SimConfig(**dataclasses.asdict(jcfg)), 32, 300)


CASES = ("raft_bench", "raft_two_handler", "twopc_tail")
_RUNS = {}


def _runs(name):
    """(JAX lineage leaves, port lineage leaves, port lineage-off leaves)
    of one case, cached per module."""
    if name not in _RUNS:
        jspec, jcfg, spec, cfg, lanes, steps = _case(name)
        assert jcfg.to_toml() == cfg.to_toml()
        jst = JaxSim(jspec, jcfg, lineage=True).run(
            jnp.arange(lanes, dtype=jnp.uint32), max_steps=steps,
            dispatch_steps=steps)
        on, off = (
            BatchedSim(spec, cfg, lineage=lin, device="cpu").run(
                range(lanes), max_steps=steps, dispatch_steps=steps)
            for lin in (True, False)
        )
        _RUNS[name] = (jax_leaves(jst), state_to_numpy(on),
                       state_to_numpy(off))
    return _RUNS[name]


@pytest.mark.parametrize("name", CASES)
def test_lineage_leaves_equal_the_jax_face(name):
    want, got, _ = _runs(name)
    lin = sorted(k for k in got if _is_lineage(k))
    expect = {"lin.lam", "lin.eid", "msgs.sent_eid"}
    if name == "twopc_tail":
        expect.add("strag.sent_eid")
    assert set(lin) == expect
    assert_leaves_equal(want, got, name)
    # real traffic: events counted, stamps written, and the counter equals
    # the events each lane processed
    assert (got["lin.eid"] == got["events"]).all()
    assert got["lin.eid"].min() > 0 and got["msgs.sent_eid"].any()
    if name == "twopc_tail":
        assert got["strag.sent_eid"].any()
        assert got["clock"].max() > 1_000_000


@pytest.mark.parametrize("name", CASES)
def test_lineage_is_observe_only(name):
    """Every non-lineage leaf is the lineage-off run's, and a lineage-off
    sim carries no lineage leaf at all."""
    _, on, off = _runs(name)
    assert not any(_is_lineage(k) for k in off)
    assert_leaves_equal(off, _without_lineage(on), f"{name} on/off")


def _refill_plan(m):
    return m.FaultPlan(name="lineage-refill", clauses=(
        m.Crash(interval_lo_us=150_000, interval_hi_us=450_000,
                down_lo_us=100_000, down_hi_us=300_000),
        m.Partition(interval_lo_us=200_000, interval_hi_us=600_000,
                    heal_lo_us=150_000, heal_hi_us=450_000),
        m.MsgLoss(rate=0.05),
    ))


def test_refill_lineage_equals_jax_and_is_observe_only():
    """A refill sweep with lineage on: the whole final state (queue, log,
    and the lineage leaves of lanes re-admitted through `init`) equals the
    JAX face's; every per-admission row and every non-lineage leaf equals
    the lineage-off sweep's."""
    jcfg = jtn.compile_plan(_refill_plan(jn), JaxConfig(horizon_us=600_000))
    cfg = ttn.compile_plan(_refill_plan(tn), SimConfig(horizon_us=600_000))
    seeds, lanes = list(range(12)), 4
    jst = JaxSim(jax_raft_spec(), jcfg, coverage=True, lineage=True
                 ).run_refill(np.asarray(seeds, np.uint32), lanes=lanes,
                              max_steps=4_000)
    on, off = (
        BatchedSim(make_raft_spec(), cfg, coverage=True, lineage=lin,
                   device="cpu").run_refill(seeds, lanes=lanes,
                                            max_steps=4_000)
        for lin in (True, False)
    )
    got = state_to_numpy(on)
    assert {"lin.eid", "queue.seeds", "refill.retired"} <= set(got)
    assert_leaves_equal(jax_leaves(jst), got, "refill lineage")
    assert int(on.refill.cursor) == len(seeds)
    assert_leaves_equal(state_to_numpy(off), _without_lineage(got),
                        "refill on/off")
    rows, rows_off, jrows = (refill_results(on), refill_results(off),
                             jax_refill_results(jst))
    assert set(rows) == set(rows_off)
    for k, v in rows.items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(v, rows_off[k], err_msg=k)
            np.testing.assert_array_equal(v, jrows[k], err_msg=k)
        else:
            assert v == rows_off[k] == jrows[k], k


def test_eid_wrap_and_epoch_rebase_from_a_loaded_jax_state():
    """The u32 trap: a JAX lineage state loaded through state_from_numpy,
    shifted to just under REBASE_US, its event counter moved to 40 below
    2^32 (in-flight stamps moved with it), stepped on both faces past the
    wrap and the rebase: every leaf equal throughout."""
    kw = dict(n_nodes=5, client_rate=0.1, log_capacity=16)
    jsim = JaxSim(jax_raft_spec(**kw), bench.raft_bench_config(400.0),
                  lineage=True)
    st = jsim.init(jnp.arange(16, dtype=jnp.uint32))
    for _ in range(120):
        st = jsim.step(st)
    leaves, treedef = jax.tree_util.tree_flatten(st)
    names = [k for k, _ in named_leaves(st)]
    shifted = _shift_to_rebase({k: np.asarray(v)
                                for k, v in zip(names, leaves)})
    delta = M32 - 40 - shifted["lin.eid"].astype(np.int64)  # [L]
    shifted["lin.eid"] = ((shifted["lin.eid"].astype(np.int64) + delta)
                          & M32).astype(np.uint32)
    shifted["msgs.sent_eid"] = (
        (shifted["msgs.sent_eid"].astype(np.int64) + delta[:, None]) & 0xFFFF
    ).astype(np.uint16)
    jst = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(shifted[k]) for k in names])
    sim = BatchedSim(make_raft_spec(**kw), raft_bench_config(400.0),
                     lineage=True, device="cpu")
    pst = state_from_numpy(shifted, "cpu", RaftState)
    assert_leaves_equal(jax_leaves(jst), state_to_numpy(pst), "loaded")
    for _ in range(60):
        jst = jsim.step(jst)
        pst = sim.step(pst)
    want = jax_leaves(jst)
    assert_leaves_equal(want, state_to_numpy(pst), "wrap + rebase")
    assert (want["epoch"] == 1).all()
    assert (want["lin.eid"] < 1000).all()  # every lane's counter wrapped


def test_golden_raft_with_lineage_keeps_golden_and_pins_lineage():
    """tests/test_state_layout.py's test_golden_digest_raft_with_lineage
    on the port, and the lineage leaves it ignores pinned on both faces."""
    spec, cfg, seeds, steps = golden_run("raft")
    pst = BatchedSim(spec, cfg, lineage=True, device="cpu").run(
        seeds, steps, dispatch_steps=steps)
    got = state_to_numpy(pst)
    assert canonical_digest(got) == GOLDEN["raft"]
    assert lineage_digest(got) == PINNED_LINEAGE
    jcfg = jtn.compile_plan(JAX_CHAOS_PLAN, JaxConfig(horizon_us=30_000_000))
    assert jcfg.to_toml() == cfg.to_toml()
    jst = JaxSim(jax_raft_spec(), jcfg, lineage=True).run(
        jnp.arange(len(seeds), dtype=jnp.uint32), max_steps=steps,
        dispatch_steps=steps)
    want = jax_leaves(jst)
    assert jax_canonical_digest(jst) == GOLDEN["raft"]
    assert lineage_digest(want) == PINNED_LINEAGE
    assert_leaves_equal(want, got, "golden raft lineage")


def test_canonical_digest_ignores_the_lineage_leaves():
    """The digest hashes values of the non-lineage leaves only, as the JAX
    one does: dropping or scrambling the lineage leaves leaves it
    unchanged, and lineage_digest sees exactly those leaves."""
    _, got, off = _runs("raft_bench")
    scrambled = dict(got)
    for k in LINEAGE_LEAVES:
        if k in scrambled:
            scrambled[k] = scrambled[k] + 1
    assert canonical_digest(got) == canonical_digest(off)
    assert canonical_digest(scrambled) == canonical_digest(got)
    assert lineage_digest(scrambled) != lineage_digest(got)
    assert lineage_digest(off) == lineage_digest({})


# ------------------------------------------------------------- the trace


@pytest.fixture(scope="module")
def planted_traces():
    """Both faces' lineage traces of the planted re-stamp seed 0 (it
    violates at step 452) through 500 steps."""
    wl, jwl = chip_smoke.triage_workload(), _sched_workload()
    _, recs = BatchedSim(wl.spec, wl.config, lineage=True,
                         device="cpu").run_traced(0, max_steps=500)
    _, jrecs = JaxSim(jwl.spec, jwl.config, lineage=True).run_traced(
        0, max_steps=500)
    return wl, recs, jrecs


def test_trace_records_and_events_equal_the_jax_face(planted_traces):
    wl, recs, jrecs = planted_traces
    for f in ("lam", "evt_eid", "sent_eid"):
        np.testing.assert_array_equal(
            getattr(recs, f).numpy().astype(np.int64),
            np.asarray(getattr(jrecs, f)).astype(np.int64), err_msg=f)
    events = extract_trace(recs, kind_names=wl.spec.msg_kind_names)
    jevents = jax_extract_trace(jrecs, kind_names=wl.spec.msg_kind_names)
    assert [dataclasses.asdict(e) for e in events] == [
        dataclasses.asdict(e) for e in jevents]
    stamped = [e for e in events if e.eid >= 0]
    assert len(stamped) > 400 and all(e.lam > 0 for e in stamped)
    assert any(e.sent_eid >= 0 for e in stamped)
    assert events[-1].kind == "violation"


def test_trace_graph_equals_the_jax_graph(planted_traces):
    """graph_from_trace decodes the port's records (verifying every edge
    and the Lamport clocks, check_lamport) into the JAX face's DAG."""
    wl, recs, jrecs = planted_traces
    names, n = wl.spec.msg_kind_names, wl.spec.n_nodes
    g = causal.graph_from_trace(recs, kind_names=names, n_nodes=n)
    jg = jcausal.graph_from_trace(jrecs, kind_names=names, n_nodes=n)
    causal.check_lamport(g)
    assert g.edges == jg.edges and len(g.edges) > 100
    assert g.prog_pred == jg.prog_pred
    assert sorted(g.events) == sorted(jg.events)
    assert g.violation is not None and g.violation.step == jg.violation.step
    assert [str(e) for e in g.chaos] == [str(e) for e in jg.chaos]


@pytest.mark.parametrize("path", ["two_handler", "straggler"])
def test_stamps_decode_on_the_two_handler_and_straggler_paths(path):
    """tests/test_causal.py's test_lineage_covers_two_handler_and_
    straggler_paths on both faces: the per-candidate-ring pack and the
    straggler side pool carry stamps that decode and verify, into equal
    graphs."""
    if path == "two_handler":
        jspec, spec = _two_handler("jax"), _two_handler("torch")
        kw, seed, steps = {}, 3, 300
    else:
        jspec, spec = jax_raft_spec(), make_raft_spec()
        kw = dict(horizon_us=3_000_000, buggify_delay_rate=0.05,
                  buggify_delay_lo_us=200_000, buggify_delay_hi_us=800_000)
        seed, steps = 5, 400
    sim = BatchedSim(spec, SimConfig(**kw), lineage=True, device="cpu")
    assert (sim._B > 0) == (path == "straggler")
    _, recs = sim.run_traced(seed, max_steps=steps)
    _, jrecs = JaxSim(jspec, JaxConfig(**kw), lineage=True).run_traced(
        seed, max_steps=steps)
    names, n = spec.msg_kind_names, spec.n_nodes
    g = causal.graph_from_trace(recs, kind_names=names, n_nodes=n)
    jg = jcausal.graph_from_trace(jrecs, kind_names=names, n_nodes=n)
    assert len(g.msg_pred) > 10 and g.edges == jg.edges
    if path == "straggler":
        # a delivery whose message flew longer than the tail's floor
        # (msg_pred maps each delivery to its send event)
        flights = [g.events[d].t_us - g.events[s].t_us
                   for d, s in g.msg_pred.items()]
        assert max(flights) >= 200_000
