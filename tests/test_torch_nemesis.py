"""The port's FaultPlan chaos against the JAX package's, exactly.

The copied clause vocabulary and validation, `compile_plan` (byte-equal
`SimConfig.to_toml()` for every single clause and the eight-clause storm
plan), `scale_delay_ppm` on edge values, the float32 rate coins, Raft under
the golden-digest CHAOS_PLAN and under the storm plan leaf-equal to the JAX
engine (`nem.*` and `occ_fired` included) at 16 lanes, the Raft GOLDEN
digest, and the Reconfig and DiskFault clauses leaf-equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from madsim_tpu import nemesis as jn
from madsim_tpu.tpu import BatchedSim as JaxSim
from madsim_tpu.tpu import SimConfig as JaxConfig
from madsim_tpu.tpu import make_raft_spec as jax_raft_spec
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu.tpu import summarize as jax_summarize
from madsim_tpu.tpu.engine import scale_delay_ppm as jax_scale_delay_ppm
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch.tpu import BatchedSim, SimConfig, make_raft_spec, summarize
from madsim_tpu_torch.tpu import nemesis as ttn
from madsim_tpu_torch.tpu import prng
from madsim_tpu_torch.tpu.convert import state_to_numpy
from madsim_tpu_torch.tpu.digest import (
    CHAOS_PLAN, GOLDEN, canonical_digest, golden_run,
)
from madsim_tpu_torch.tpu.engine import scale_delay_ppm
from madsim_tpu_torch.tpu.raft import raft_bench_config
from test_torch_engine import assert_leaves_equal, jax_leaves


def storm(m, wipe_rate=0.0):
    """The documented raft-storm plan plus the three clauses it lacks, so
    every ported clause fires (the plan chip_smoke.py phase 7 sweeps)."""
    return m.FaultPlan(name="raft-storm", clauses=(
        m.Crash(interval_lo_us=500_000, interval_hi_us=2_000_000,
                wipe_rate=wipe_rate),
        m.Partition(),
        m.Duplicate(rate=0.05),
        m.Reorder(rate=0.1, window_us=50_000),
        m.ClockSkew(max_ppm=20_000),
        m.LinkClog(),
        m.LatencySpike(),
        m.MsgLoss(rate=0.05),
    ))


# ------------------------------------------------------------ the copies

SITE_NAMES = [n for n in dir(jn) if n.startswith(("NEM_SITE_", "NET_SITE_"))]


def test_copied_constants_equal():
    assert len(SITE_NAMES) >= 26
    for n in SITE_NAMES + ["COIN_DENOM", "FIRE_KINDS", "FIRE_INDEX",
                           "OCC_CLAUSES", "OCC_ROW"]:
        assert getattr(tn, n) == getattr(jn, n), n


CLAUSES = ["Crash", "Partition", "LinkClog", "LatencySpike", "MsgLoss",
           "Duplicate", "Reorder", "ClockSkew", "Reconfig", "DiskFault"]


@pytest.mark.parametrize("name", CLAUSES)
def test_clause_fields_and_defaults_equal(name):
    def sig(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert sig(getattr(tn, name)) == sig(getattr(jn, name))


def _single(m, name):
    return m.FaultPlan(name=name, clauses=(getattr(m, name)(),))


PLANS = {f"single-{n}": (lambda m, n=n: _single(m, n)) for n in CLAUSES}
PLANS["storm"] = storm
PLANS["chaos"] = lambda m: m.FaultPlan(name="layout", clauses=(
    m.Crash(300_000, 900_000, 200_000, 600_000),
    m.Partition(400_000, 1_200_000, 300_000, 900_000),
    m.MsgLoss(rate=0.05),
))


@pytest.mark.parametrize("plan", sorted(PLANS))
def test_compile_plan_toml_equal(plan):
    """Equal configs on both faces, over the default base and over the
    bench config whose legacy crash/partition knobs a plan clears."""
    jp, tp = PLANS[plan](jn), PLANS[plan](tn)
    assert tp.enabled_kinds == jp.enabled_kinds
    for jbase, tbase in ((None, None),
                         (bench.raft_bench_config(10.0), raft_bench_config(10.0))):
        jcfg, tcfg = jtn.compile_plan(jp, jbase), ttn.compile_plan(tp, tbase)
        assert tcfg.to_toml() == jcfg.to_toml()
        assert tcfg.hash() == jcfg.hash()
        assert ttn.enabled_fire_kinds(tcfg) == jtn.enabled_fire_kinds(jcfg)


BAD_PLANS = [
    ("bad-interval", lambda m: (m.Crash(interval_lo_us=5, interval_hi_us=4),)),
    ("zero-hi", lambda m: (m.Partition(interval_lo_us=0, interval_hi_us=0),)),
    ("negative-lo", lambda m: (m.LinkClog(heal_lo_us=-1),)),
    ("wipe-rate", lambda m: (m.Crash(wipe_rate=1.0),)),
    ("loss-rate", lambda m: (m.MsgLoss(rate=-0.1),)),
    ("dup-rate", lambda m: (m.Duplicate(rate=1.5),)),
    ("reorder-window", lambda m: (m.Reorder(window_us=0),)),
    ("spike-extra", lambda m: (m.LatencySpike(extra_us=0),)),
    ("spike-duration", lambda m: (m.LatencySpike(duration_lo_us=9,
                                                 duration_hi_us=3),)),
    ("skew-zero", lambda m: (m.ClockSkew(max_ppm=0),)),
    ("skew-huge", lambda m: (m.ClockSkew(max_ppm=1_000_000),)),
    ("disk-torn", lambda m: (m.DiskFault(torn_rate=2.0),)),
    ("disk-extra", lambda m: (m.DiskFault(extra_us=-1),)),
    ("reconfig-down", lambda m: (m.Reconfig(down_lo_us=7, down_hi_us=6),)),
    ("duplicate-clause", lambda m: (m.MsgLoss(), m.MsgLoss(rate=0.1))),
    ("not-a-clause", lambda m: ("crash",)),
]


@pytest.mark.parametrize("name,clauses", BAD_PLANS, ids=[b[0] for b in BAD_PLANS])
def test_plan_validation_raises_the_same(name, clauses):
    errors = []
    for m in (jn, tn):
        with pytest.raises((ValueError, TypeError)) as e:
            m.FaultPlan(clauses=clauses(m))
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


def test_host_faces_refused_with_item():
    """The pure schedule faces are ported (item 9): `schedule` and
    `skew_ppm` equal the JAX package's for the storm plan; the host
    runtime's network face stays refused."""
    plan, jplan = storm(tn), storm(jn)
    for seed in (1, 7):
        assert plan.skew_ppm(seed, 5) == jplan.skew_ppm(seed, 5)
        got = [dataclasses.asdict(e) for e in plan.schedule(seed, 5_000_000, 5)]
        want = [dataclasses.asdict(e)
                for e in jplan.schedule(seed, 5_000_000, 5)]
        assert got == want and len(got) > 10
    with pytest.raises(NotImplementedError, match="host runtime"):
        plan.to_net_config()


# ------------------------------------------------------- integer + coins

def test_scale_delay_ppm_edge_values():
    ds = np.array([0, 1, 2, 999, 1000, 999_999, 1_000_000, 1_000_001,
                   123_456_789, 2**31 - 2, 2**31 - 1], np.int32)
    ppms = np.array([0, 1, -1, 999, -999, 1000, 20_000, -20_000, 999_999,
                     -999_999], np.int32)
    d, p = np.meshgrid(ds, ppms, indexing="ij")
    want = np.asarray(jax_scale_delay_ppm(jnp.asarray(d), jnp.asarray(p)))
    got = scale_delay_ppm(torch.as_tensor(d), torch.as_tensor(p)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    # a Python-int ppm, as for a single node
    got1 = scale_delay_ppm(torch.as_tensor(ds), 999_999).numpy()
    np.testing.assert_array_equal(
        got1, np.asarray(jax_scale_delay_ppm(jnp.asarray(ds), 999_999))
    )


@pytest.mark.parametrize("rate", [0.05, 0.1, 0.7, 0.85, 0.999])
def test_rate_coins_compare_in_float32(rate):
    """A uniform u = k * 2^-24 just around a rate: the port's coin
    (`u < prng.f32(rate)`) equals the JAX face's weak-typed float32
    comparison, also where float64 would differ (e.g. 0.7, whose float32
    value lies below it on the u grid)."""
    k0 = int(np.float32(rate) * (1 << 24))
    ks = np.arange(k0 - 3, k0 + 4, dtype=np.int64)
    u_j = (jnp.asarray(ks, jnp.uint32).astype(jnp.float32)
           * jnp.float32(1.0 / (1 << 24)))
    u_t = torch.as_tensor(ks).to(torch.float32) * (1.0 / (1 << 24))
    np.testing.assert_array_equal(np.asarray(u_j), u_t.numpy())
    want = np.asarray(u_j < rate)
    if rate == 0.7:  # the grid point where a float64 compare would differ
        assert ((u_t.numpy().astype(np.float64) < rate) != want).any()
    np.testing.assert_array_equal((u_t < prng.f32(rate)).numpy(), want)
    np.testing.assert_array_equal((u_t >= prng.f32(rate)).numpy(), ~want)
    # the integer schedule coin (wipe) threshold is the same integer
    assert round(rate * tn.COIN_DENOM) == int(round(rate * jn.COIN_DENOM))


# --------------------------------------------------------- whole engines

RUNS = {
    # name: (plan factory, base config pair, spec kwargs, steps)
    "chaos": (PLANS["chaos"], "golden", {}, 300),
    "storm": (storm, "bench", dict(client_rate=0.1, log_capacity=16), 400),
    "storm-wipe": (lambda m: storm(m, wipe_rate=0.3), "bench",
                   dict(client_rate=0.1, log_capacity=16), 400),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_raft_under_plan_leaf_equal(name):
    plan, base, kw, steps = RUNS[name]
    if base == "bench":
        jbase, tbase = bench.raft_bench_config(10.0), raft_bench_config(10.0)
    else:
        jbase, tbase = (JaxConfig(horizon_us=30_000_000),
                        SimConfig(horizon_us=30_000_000))
    jcfg = jtn.compile_plan(plan(jn), jbase)
    tcfg = ttn.compile_plan(plan(tn), tbase)
    jspec = jax_raft_spec(5, **kw)
    jst = JaxSim(jspec, jcfg).run(jnp.arange(16, dtype=jnp.uint32),
                                  max_steps=steps, dispatch_steps=steps)
    pst = BatchedSim(make_raft_spec(5, **kw), tcfg, device="cpu").run(
        range(16), max_steps=steps, dispatch_steps=steps)
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert_leaves_equal(want, got, name)
    assert any(k.startswith("nem.") for k in got) and "occ_fired" in got
    js, ps = jax_summarize(jst, jspec), summarize(pst)
    for k, v in js.items():
        if k.startswith(("fires_", "occfires_", "total_")):
            assert ps[k] == v, k
    # every kind the plan enables fired somewhere in the run
    for kind in ttn.enabled_fire_kinds(tcfg):
        assert ps[f"fires_{kind}"] > 0, kind
    assert ttn.coverage_report(ps, tcfg) == jtn.coverage_report(js, jcfg)


def test_golden_digest_raft():
    """The JAX package's pinned Raft trajectory under CHAOS_PLAN, on the
    port: exactly 1500 steps with every lane still live."""
    spec, cfg, seeds, steps = golden_run("raft")
    assert cfg.to_toml() == jtn.compile_plan(
        PLANS["chaos"](jn), JaxConfig(horizon_us=30_000_000)).to_toml()
    assert CHAOS_PLAN == PLANS["chaos"](tn)
    st = BatchedSim(spec, cfg, device="cpu").run(
        seeds, max_steps=steps, dispatch_steps=steps)
    leaves = state_to_numpy(st)
    assert (leaves["steps"] == steps).all() and not leaves["done"].any()
    assert canonical_digest(leaves) == GOLDEN["raft"]
    assert summarize(st)["total_events"] > 0


ITEM8 = [
    ("reconfig", lambda m: m.Reconfig(
        interval_lo_us=200_000, interval_hi_us=600_000,
        down_lo_us=100_000, down_hi_us=300_000)),
    ("disk", lambda m: m.DiskFault(
        interval_lo_us=200_000, interval_hi_us=600_000,
        slow_lo_us=50_000, slow_hi_us=100_000,
        down_lo_us=100_000, down_hi_us=300_000, torn_rate=0.5)),
]


@pytest.mark.parametrize("name,clause", ITEM8, ids=[c[0] for c in ITEM8])
def test_item8_clauses_still_refused(name, clause):
    """The Reconfig and DiskFault clauses, once refused (item 8), each run
    Raft leaf-equal to the JAX engine (16 lanes x 300 steps, `nem.*`
    included), and every kind the clause enables fires."""
    tcfg = ttn.compile_plan(tn.FaultPlan(clauses=(clause(tn),)),
                            SimConfig(horizon_us=5_000_000))
    jcfg = jtn.compile_plan(jn.FaultPlan(clauses=(clause(jn),)),
                            JaxConfig(horizon_us=5_000_000))
    assert tcfg.to_toml() == jcfg.to_toml()
    jst = JaxSim(jax_raft_spec(5), jcfg).run(
        jnp.arange(16, dtype=jnp.uint32), max_steps=300, dispatch_steps=300)
    pst = BatchedSim(make_raft_spec(5), tcfg, device="cpu").run(
        range(16), max_steps=300, dispatch_steps=300)
    got = state_to_numpy(pst)
    assert_leaves_equal(jax_leaves(jst), got, name)
    fires = dict(zip(tn.FIRE_KINDS, got["fires"].sum(0)))
    for kind in ttn.enabled_fire_kinds(tcfg):
        assert fires[kind] > 0, (kind, fires)


def test_epoch_rebase_under_the_storm_plan():
    """Phase 8 with the nemesis toggles live: a storm-plan state shifted to
    just under REBASE_US (clog and spike toggles included) steps across the
    rebase leaf-equal on both faces."""
    import jax

    from madsim_tpu.tpu.engine import named_leaves
    from madsim_tpu_torch.tpu.convert import state_from_numpy
    from madsim_tpu_torch.tpu.raft import RaftState
    from madsim_tpu_torch.tpu.spec import INF_GUARD, REBASE_US

    kw = dict(client_rate=0.1, log_capacity=16)
    jcfg = jtn.compile_plan(storm(jn), bench.raft_bench_config(400.0))
    tcfg = ttn.compile_plan(storm(tn), raft_bench_config(400.0))
    jsim = JaxSim(jax_raft_spec(5, **kw), jcfg)
    st = jsim.init(jnp.arange(16, dtype=jnp.uint32))
    for _ in range(120):
        st = jsim.step(st)
    leaves, treedef = jax.tree_util.tree_flatten(st)
    names = [k for k, _ in named_leaves(st)]
    flat = {k: np.asarray(v) for k, v in zip(names, leaves)}
    delta = (REBASE_US - 3_000) - flat["clock"].astype(np.int64)
    for k in ("clock", "timer", "chaos_at", "part_at", "msgs.deliver",
              "nem.clog_at", "nem.spike_at"):
        v = flat[k].astype(np.int64)
        d = delta.reshape((-1,) + (1,) * (v.ndim - 1))
        flat[k] = np.where(v < INF_GUARD, v + d, v).astype(flat[k].dtype)
    jst = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(flat[k]) for k in names]
    )
    sim = BatchedSim(make_raft_spec(5, **kw), tcfg, device="cpu")
    pst = state_from_numpy(flat, "cpu", RaftState)
    for _ in range(60):
        jst = jsim.step(jst)
        pst = sim.step(pst)
    want = jax_leaves(jst)
    assert_leaves_equal(want, state_to_numpy(pst), "storm rebase")
    assert (want["epoch"] == 1).all()
