"""The port's Paxos and chain-replication workloads against the JAX face.

Each `*_workload()` config runs leaf-equal to the JAX engine at 16 lanes,
each GOLDEN digest under CHAOS_PLAN is reproduced on the port, and the
planted bugs fire on the same lanes at the same steps on both faces while
the correct build stays silent. Sizes are cut to stay CPU-cheap: both
faces always run the same seeds and step counts.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from madsim_tpu import nemesis as jn
from madsim_tpu.tpu import BatchedSim as JaxSim
from madsim_tpu.tpu import chain_workload as jax_chain_workload
from madsim_tpu.tpu import make_chain_spec as jax_chain_spec
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu.tpu import paxos_workload as jax_paxos_workload
from madsim_tpu.tpu import summarize as jax_summarize
from madsim_tpu.tpu.paxos import make_paxos_spec as jax_paxos_spec
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch.tpu import (
    BatchedSim, chain_workload, make_chain_spec, make_paxos_spec,
    paxos_workload, summarize,
)
from madsim_tpu_torch.tpu import nemesis as ttn
from madsim_tpu_torch.tpu.convert import state_to_numpy
from madsim_tpu_torch.tpu.digest import GOLDEN, canonical_digest, golden_run
from test_torch_engine import (
    assert_leaves_equal, assert_summaries_equal, jax_leaves,
)

WORKLOADS = {
    # name: (JAX factory, port factory, max_steps of a 2-virtual-s run)
    "paxos": (jax_paxos_workload, paxos_workload, 600),
    "chain": (jax_chain_workload, chain_workload, 400),
}


def run_both(jspec, jcfg, tspec, tcfg, seeds, steps):
    """(JAX state, port state) of the same seeds and step budget."""
    assert tcfg.to_toml() == jcfg.to_toml()
    jst = JaxSim(jspec, jcfg).run(
        jnp.asarray(seeds, jnp.uint32), max_steps=steps, dispatch_steps=steps
    )
    pst = BatchedSim(tspec, tcfg, device="cpu").run(
        seeds, max_steps=steps, dispatch_steps=steps
    )
    return jst, pst


def violations(leaves):
    """{lane: first violating step} of a numpy-leaf state."""
    lanes = np.nonzero(leaves["violated"])[0]
    return {int(i): int(leaves["violation_step"][i]) for i in lanes}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_leaf_equal(name):
    jfac, tfac, steps = WORKLOADS[name]
    jw, tw = jfac(virtual_secs=2.0), tfac(virtual_secs=2.0)
    # every factory ships its host twin (item 16)
    assert tw.host_repro is not None
    assert jw.host_repro is not None
    jst, pst = run_both(jw.spec, jw.config, tw.spec, tw.config,
                        list(range(16)), steps)
    got = state_to_numpy(pst)
    assert_leaves_equal(jax_leaves(jst), got, name)
    assert_summaries_equal(jax_summarize(jst, jw.spec), summarize(pst, tw.spec))
    assert got["events"].sum() > 0 and got["fires"][:, 0].sum() > 0


@pytest.mark.parametrize("name", ["paxos", "chain"])
def test_golden_digest(name):
    spec, cfg, seeds, steps = golden_run(name)
    st = BatchedSim(spec, cfg, device="cpu").run(
        seeds, max_steps=steps, dispatch_steps=steps)
    leaves = state_to_numpy(st)
    assert (leaves["steps"] == steps).all()
    assert canonical_digest(leaves) == GOLDEN[name]


def test_paxos_planted_bug_fires_on_the_same_lanes():
    """buggy_ignore_discovered (phase 2 pushes the proposer's own value)
    splits agreement under the workload's chaos within a few dozen steps;
    the JAX test's 1024 lanes x 10 s are cut to 64 lanes x 40 steps."""
    jcfg = jax_paxos_workload(virtual_secs=10.0).config
    tcfg = paxos_workload(virtual_secs=10.0).config
    seeds = list(range(64))
    jst, pst = run_both(
        jax_paxos_spec(5, buggy_ignore_discovered=True), jcfg,
        make_paxos_spec(5, buggy_ignore_discovered=True), tcfg, seeds, 40,
    )
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert_leaves_equal(want, got, "paxos buggy")
    assert violations(got) == violations(want)
    assert len(violations(got)) >= 1
    clean = state_to_numpy(BatchedSim(make_paxos_spec(5), tcfg, device="cpu")
                           .run(seeds, max_steps=40, dispatch_steps=40))
    assert not clean["violated"].any()


def _dup_reorder(m, base):
    """Heavy duplication plus wide reordering: late duplicate forwards
    overtake newer writes (the JAX test's straggler tails do the same, but
    the straggler pool is not ported yet)."""
    plan = m.FaultPlan(name="dup-reorder", clauses=(
        m.Duplicate(rate=0.2), m.Reorder(rate=0.3, window_us=500_000),
    ))
    mod = jtn if m is jn else ttn
    return mod.compile_plan(plan, base)


def test_chain_blind_apply_bug_fires_on_the_same_lanes():
    """buggy_blind_apply (no apply-if-newer guard) rolls a replica back
    when a late duplicate forward arrives: chain monotonicity fires on the
    same lanes at the same steps on both faces; the correct build is
    silent under the same chaos."""
    jcfg = _dup_reorder(jn, jax_chain_workload(virtual_secs=4.0).config)
    tcfg = _dup_reorder(tn, chain_workload(virtual_secs=4.0).config)
    seeds = list(range(16))
    jst, pst = run_both(
        jax_chain_spec(5, buggy_blind_apply=True), jcfg,
        make_chain_spec(5, buggy_blind_apply=True), tcfg, seeds, 350,
    )
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert_leaves_equal(want, got, "chain blind apply")
    assert violations(got) == violations(want)
    assert len(violations(got)) >= 3
    clean = state_to_numpy(BatchedSim(make_chain_spec(5), tcfg, device="cpu")
                           .run(seeds, max_steps=350, dispatch_steps=350))
    assert not clean["violated"].any()
    assert clean["fires"].sum(0)[tn.FIRE_INDEX["dup"]] > 0


def test_chain_read_at_head_runs_leaf_equal():
    """buggy_read_at_head (dirty reads at the head) is documented as
    invisible to the per-step oracle on both faces: the port runs it
    leaf-equal, and neither face flags a lane."""
    jw, tw = jax_chain_workload(virtual_secs=2.0), chain_workload(virtual_secs=2.0)
    jst, pst = run_both(
        jax_chain_spec(5, buggy_read_at_head=True), jw.config,
        make_chain_spec(5, buggy_read_at_head=True), tw.config,
        list(range(16)), 300,
    )
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert_leaves_equal(want, got, "chain read at head")
    assert not got["violated"].any()


def test_fused_specs_derive_from_both_handlers():
    """paxos and chain fuse their two handlers (fuse_two_handlers): the
    stale-wrapper guard accepts the result, and a bare replace of one
    handler is refused as on the JAX face."""
    for spec in (make_paxos_spec(5), make_chain_spec(5)):
        assert spec.on_event.__fused_from__ == (spec.on_message, spec.on_timer)
        with pytest.raises(ValueError, match="replace_handlers"):
            dataclasses.replace(spec, on_timer=lambda *a: None)


def test_chain_blind_apply_under_straggler_tails_on_the_jax_lanes():
    """tests/test_tpu_chain.py's canonical planted bug under heavy-tail
    stragglers (buggify_delay_rate=0.05, depth 8, 128 lanes at 8 virtual
    seconds): the port's violating lanes are the JAX face's, lane for lane
    and step for step, on more than half the lanes; the correct spec is
    clean under the same tails on both faces."""
    jcfg = dataclasses.replace(jax_chain_workload(virtual_secs=8.0).config,
                               buggify_delay_rate=0.05, buggify_depth=8)
    tcfg = dataclasses.replace(chain_workload(virtual_secs=8.0).config,
                               buggify_delay_rate=0.05, buggify_depth=8)
    assert tcfg.to_toml() == jcfg.to_toml()
    seeds = list(range(128))
    got = {}
    for buggy in (True, False):
        jst = JaxSim(jax_chain_spec(5, buggy_blind_apply=buggy), jcfg).run(
            jnp.asarray(seeds, jnp.uint32), max_steps=40_000)
        pst = BatchedSim(make_chain_spec(5, buggy_blind_apply=buggy), tcfg,
                         device="cpu").run(seeds, max_steps=40_000)
        want, have = jax_leaves(jst), state_to_numpy(pst)
        assert violations(have) == violations(want), buggy
        got[buggy] = violations(have)
    assert len(got[True]) > 64
    assert got[False] == {}
