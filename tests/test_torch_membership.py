"""The port's membership (reconfig) and durability (disk-fault) axes, with
the ISR, lease and WAL workloads, against the JAX engine.

`isr_workload`, `lease_workload` and `wal_workload` (correct and buggy, and
wal's quiet-disk control leg) run leaf-equal to the JAX engine at 16 lanes,
their planted bugs firing on the same lanes at the same steps (the JAX
tests' 128-256 lanes x 40000 steps cut to 16 lanes x 400-800 steps); Raft
under a Reconfig + DiskFault plan (crash, skew and the straggler pool
composed in, so every straggler drop path runs) is leaf-equal, `nem.*`
included; and `convert` carries the `strag.*` and `dur.*` planes both
ways. Tolerance everywhere: exact, leaf for leaf, after widening to int64.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import madsim_tpu.tpu as jtpu
from madsim_tpu import nemesis as jn
from madsim_tpu.tpu import BatchedSim as JaxSim
from madsim_tpu.tpu import make_raft_spec as jax_raft_spec
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu.tpu import summarize as jax_summarize
from madsim_tpu.tpu import wal as jwal
from madsim_tpu.tpu.engine import named_leaves
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch.tpu import (
    BatchedSim, SimConfig, isr_workload, lease_workload, make_raft_spec,
    summarize, wal_workload,
)
from madsim_tpu_torch.tpu import nemesis as ttn
from madsim_tpu_torch.tpu.convert import state_from_numpy, state_to_numpy
from madsim_tpu_torch.tpu.wal import WalState
from test_torch_engine import (
    assert_leaves_equal, assert_summaries_equal, jax_leaves,
)
from test_torch_workloads import run_both, violations

WORKLOADS = {
    # name: (JAX factory, port factory, virtual s, max_steps, min violating
    # lanes of the buggy build at 16 lanes)
    "isr": (jtpu.isr_workload, isr_workload, 6.0, 500, 4),
    "lease": (jtpu.lease_workload, lease_workload, 6.0, 660, 2),
    "wal": (jwal.wal_workload, wal_workload, 6.0, 400, 2),
}
CASES = [(n, b) for n in sorted(WORKLOADS) for b in (False, True)]


@pytest.mark.parametrize("name,buggy", CASES,
                         ids=[f"{n}-{'buggy' if b else 'correct'}"
                              for n, b in CASES])
def test_workload_leaf_equal(name, buggy):
    """Each workload at its factory's config: every leaf (the watermark
    `dur.*` and `nem.*` rows included) and the summary equal the JAX
    engine's; the correct build never violates, the buggy build violates
    on the same lanes at the same steps on both faces."""
    jfac, tfac, secs, steps, min_bad = WORKLOADS[name]
    jw, tw = jfac(virtual_secs=secs, buggy=buggy), tfac(virtual_secs=secs,
                                                         buggy=buggy)
    assert tw.host_repro is not None
    jst, pst = run_both(jw.spec, jw.config, tw.spec, tw.config,
                        list(range(16)), steps)
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert_leaves_equal(want, got, f"{name} buggy={buggy}")
    assert_summaries_equal(jax_summarize(jst, jw.spec), summarize(pst, tw.spec))
    assert violations(got) == violations(want)
    if buggy:
        assert len(violations(got)) >= min_bad
    else:
        assert not got["violated"].any()
    kinds = ttn.enabled_fire_kinds(tw.config)
    fires = dict(zip(tn.FIRE_KINDS, got["fires"].sum(0)))
    assert all(fires[k] > 0 for k in kinds), fires
    if name == "wal":
        # the watermark is carried, and each violating lane lost unsynced
        # durable state at a disk crash
        assert "dur.log_len" in got
        bad = got["violated"] > 0
        assert (got["unsynced_loss"][bad] > 0).all()
        if not buggy:
            assert not got["unsynced_loss"].any()
    else:
        assert got["nonmember_drops"].sum() > 0
        assert (got["member_epoch"] > 0).any()


def test_wal_quiet_disk_control_leg():
    """wal_workload(disk=False): the buggy server with the disk clause
    absent is silent and carries no watermark, leaf-equal on both faces."""
    jw = jwal.wal_workload(virtual_secs=6.0, buggy=True, disk=False)
    tw = wal_workload(virtual_secs=6.0, buggy=True, disk=False)
    jst, pst = run_both(jw.spec, jw.config, tw.spec, tw.config,
                        list(range(16)), 400)
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert_leaves_equal(want, got, "wal quiet disk")
    assert not got["violated"].any() and not got["unsynced_loss"].any()
    assert not any(k.startswith("dur.") for k in got)


def _membership_plan(m):
    """Reconfig + DiskFault, with crash (wipe), skew and dup composed in."""
    return m.FaultPlan(name="membership+durability", clauses=(
        m.Reconfig(interval_lo_us=300_000, interval_hi_us=900_000),
        m.DiskFault(interval_lo_us=300_000, interval_hi_us=900_000,
                    torn_rate=0.5),
        m.Crash(interval_lo_us=300_000, interval_hi_us=900_000,
                wipe_rate=0.5),
        m.ClockSkew(max_ppm=20_000),
        m.Duplicate(rate=0.05),
    ))


def _raft_plan_configs():
    base = dict(horizon_us=3_000_000, buggify_delay_rate=0.2)
    jcfg = jtn.compile_plan(_membership_plan(jn),
                            jtpu.SimConfig(**base))
    tcfg = ttn.compile_plan(_membership_plan(tn), SimConfig(**base))
    return jcfg, tcfg


def _straggler_drops(sim, state, steps):
    """Step the port one step at a time and count pending straggler slots
    whose destination a crash, a remove or a disk crash took down in that
    step (and which were gone after it), per kill kind."""
    drops = {"crash": 0, "remove": 0, "disk_crash": 0}
    fi = {k: tn.FIRE_INDEX[k] for k in drops}

    def view(st):
        return (st.fires.numpy(), st.strag.valid.numpy(),
                st.strag.dst.numpy(), st.alive.numpy())

    a = view(state)
    for _ in range(steps):
        state = sim.step(state)
        b = view(state)
        fired = b[0] - a[0]  # [L, kinds]
        gone = a[1] & ~b[1]  # [L,B]
        downed = a[3] & ~b[3]  # [L,N]
        hit = gone & np.take_along_axis(downed, a[2].astype(np.int64), axis=1)
        for kind, col in fi.items():
            # one kill per step per lane: attribute by the fired column
            drops[kind] += int(hit[fired[:, col] > 0].sum())
        a = b
    return drops, state


def test_raft_under_reconfig_and_disk_plan_leaf_equal():
    """Raft (no durable fields: a disk recovery rebuilds the node from
    init, every disk crash counts as unsynced loss) under Reconfig +
    DiskFault with crash-wipe, skew, dup and a 20% straggler tail: leaf-
    equal to the JAX engine after 300 steps, every enabled kind fired, and
    pending stragglers were dropped on each kill path (crash, remove, disk
    crash)."""
    jcfg, tcfg = _raft_plan_configs()
    assert jcfg.to_toml() == tcfg.to_toml()
    jsim = JaxSim(jax_raft_spec(5), jcfg)
    jst = jsim.init(jnp.arange(16, dtype=jnp.uint32))
    for _ in range(300):
        jst = jsim.step(jst)
    sim = BatchedSim(make_raft_spec(5), tcfg, device="cpu")
    drops, pst = _straggler_drops(sim, sim.init(range(16)), 300)
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert_leaves_equal(want, got, "raft reconfig+disk")
    assert sum(k.startswith("nem.") for k in got) == 18
    fires = dict(zip(tn.FIRE_KINDS, got["fires"].sum(0)))
    for kind in ttn.enabled_fire_kinds(tcfg):
        assert fires[kind] > 0, (kind, fires)
    assert got["unsynced_loss"].sum() == fires["disk_crash"]
    assert all(n > 0 for n in drops.values()), drops


def test_convert_round_trip_strag_and_dur():
    """A mid-run JAX state with both planes (wal under disk chaos plus the
    straggler tail) goes into the port through `state_from_numpy` and
    back, value for value, and both faces step it on leaf-equal."""
    import dataclasses

    jw = jwal.wal_workload(virtual_secs=6.0, buggy=True)
    jcfg = dataclasses.replace(jw.config, buggify_delay_rate=0.1)
    tw = wal_workload(virtual_secs=6.0, buggy=True)
    tcfg = dataclasses.replace(tw.config, buggify_delay_rate=0.1)
    jsim = JaxSim(jw.spec, jcfg)
    st = jsim.init(jnp.arange(8, dtype=jnp.uint32))
    for _ in range(150):
        st = jsim.step(st)
    names = [k for k, _ in named_leaves(st)]
    raw = {k: np.asarray(v) for k, v in named_leaves(st)}
    assert any(k.startswith("strag.") for k in names)
    assert any(k.startswith("dur.") for k in names)
    pst = state_from_numpy(raw, "cpu", WalState)
    assert_leaves_equal(jax_leaves(st), state_to_numpy(pst), "round trip")
    assert type(pst.strag).__name__ == "StragPool"
    assert pst.dur._fields == ("nonce", "log_len")
    sim = BatchedSim(tw.spec, tcfg, device="cpu")
    for _ in range(40):
        st = jsim.step(st)
        pst = sim.step(pst)
    assert_leaves_equal(jax_leaves(st), state_to_numpy(pst), "stepped")
    leaves = jax.tree_util.tree_leaves(st)
    assert len(leaves) == len(state_to_numpy(pst))
