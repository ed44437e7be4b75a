"""The port's 2PC and replicated-KV workloads, and its copy of the exact
linearizability checker, against the JAX face.

twopc_workload() and kv_workload() configs run leaf-equal to the JAX engine
at 16 lanes; their GOLDEN digests under CHAOS_PLAN are reproduced on the
port; kv's planted stale-read bug fires on the same lanes at the same steps
on both faces (cut from the JAX test's 256 lanes x 80000 steps to 16 lanes
x 600 steps) while the correct build stays silent; 2PC's planted
impatient-timer bug runs on the two-handler path and fires on the same
lanes at the same steps; and `linearize` gives the original's verdicts on
the same histories.
"""

import collections

import jax.numpy as jnp
import pytest
import torch

from madsim_tpu.tpu import SimConfig as JaxConfig
from madsim_tpu.tpu import linearize as jax_linearize
from madsim_tpu.tpu import summarize as jax_summarize
from madsim_tpu.tpu import twopc_workload as jax_twopc_workload
from madsim_tpu.tpu.kv import buggy_local_read_spec as jax_buggy_local_read_spec
from madsim_tpu.tpu.kv import kv_workload as jax_kv_workload
from madsim_tpu.tpu.kv import make_kv_spec as jax_kv_spec
from madsim_tpu.tpu.spec import replace_handlers as jax_replace_handlers
from madsim_tpu.tpu.twopc import make_twopc_spec as jax_twopc_spec
from madsim_tpu_torch.tpu import (
    BatchedSim, SimConfig, buggy_local_read_spec, kv_workload, make_kv_spec,
    make_twopc_spec, replace_handlers, run_batch, summarize, twopc_workload,
)
from madsim_tpu_torch.tpu import linearize, prng
from madsim_tpu_torch.tpu import twopc as tpc
from madsim_tpu_torch.tpu.convert import state_to_numpy
from madsim_tpu_torch.tpu.digest import GOLDEN, canonical_digest, golden_run
from test_torch_engine import (
    assert_leaves_equal, assert_summaries_equal, jax_leaves,
)
from test_torch_workloads import run_both, violations

WORKLOADS = {
    # name: (JAX factory, port factory, max_steps of a 2-virtual-s run)
    "twopc": (jax_twopc_workload, twopc_workload, 400),
    "kv": (jax_kv_workload, kv_workload, 300),
}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_workload_leaf_equal(name):
    jfac, tfac, steps = WORKLOADS[name]
    jw, tw = jfac(virtual_secs=2.0), tfac(virtual_secs=2.0)
    assert tw.host_repro is not None
    jst, pst = run_both(jw.spec, jw.config, tw.spec, tw.config,
                        list(range(16)), steps)
    got = state_to_numpy(pst)
    assert_leaves_equal(jax_leaves(jst), got, name)
    assert_summaries_equal(jax_summarize(jst, jw.spec), summarize(pst, tw.spec))
    assert got["events"].sum() > 0


@pytest.mark.parametrize("name", ["twopc", "kv"])
def test_golden_digest(name):
    spec, cfg, seeds, steps = golden_run(name)
    st = BatchedSim(spec, cfg, device="cpu").run(
        seeds, max_steps=steps, dispatch_steps=steps)
    leaves = state_to_numpy(st)
    assert (leaves["steps"] == steps).all()
    assert canonical_digest(leaves) == GOLDEN[name]


def _partition_config(m):
    """tests/test_tpu_kv.py's partition_config()."""
    return m(
        horizon_us=8_000_000, loss_rate=0.05,
        partition_interval_lo_us=400_000, partition_interval_hi_us=1_500_000,
        partition_heal_lo_us=500_000, partition_heal_hi_us=2_000_000,
    )


def test_kv_stale_read_bug_fires_on_the_same_lanes():
    jcfg, tcfg = _partition_config(JaxConfig), _partition_config(SimConfig)
    seeds = list(range(16))
    jst, pst = run_both(
        jax_buggy_local_read_spec(jax_kv_spec(5)), jcfg,
        buggy_local_read_spec(make_kv_spec(5)), tcfg, seeds, 600,
    )
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert_leaves_equal(want, got, "kv stale read")
    assert violations(got) == violations(want)
    assert len(violations(got)) >= 3
    clean = state_to_numpy(BatchedSim(make_kv_spec(5), tcfg, device="cpu")
                           .run(seeds, max_steps=600, dispatch_steps=600))
    assert not clean["violated"].any()


def test_twopc_planted_bug_waits_for_the_two_handler_path():
    """The JAX test plants the impatient-timer bug (an in-doubt participant
    flips a coin and unilaterally aborts) by replacing on_timer;
    replace_handlers clears the fused on_event, so both faces run it on the
    two-handler path. Under the test's full-chaos config (the JAX test's
    256 lanes x 60000 steps cut to 16 lanes x 300 steps) the port is
    leaf-equal and violates on the same lanes at the same steps."""
    from madsim_tpu.tpu import prng as jprng
    from madsim_tpu.tpu import twopc as jtpc

    jspec = jax_twopc_spec(5)

    def jax_impatient_timer(s, nid, now, key):
        state, out, timer = jspec.on_timer(s, nid, now, key)
        voted_yes = (s.v_tid >= 0) & (s.v_val == jtpc.COMMIT)
        resolved = (
            (s.v_tid[:, None] == s.o_tid[None, :]) & (s.o_tid[None, :] >= 0)
        ).any(-1)
        doubt = voted_yes & ~resolved
        tid = jnp.where(doubt, s.v_tid, jnp.int32(2**30)).min()
        give_up = (nid != 0) & doubt.any() & (jprng.uniform(key, 77) < 0.5)
        at = jnp.arange(s.o_tid.shape[0], dtype=jnp.int32) == (
            tid % s.o_tid.shape[0]
        )
        state = state._replace(
            o_tid=jnp.where(give_up & at, tid, state.o_tid),
            o_val=jnp.where(give_up & at, jtpc.ABORT, state.o_val),
        )
        return state, out, timer

    spec = make_twopc_spec(5)

    def impatient_timer(s, nid, now, key):
        state, out, timer = spec.on_timer(s, nid, now, key)
        voted_yes = (s.v_tid >= 0) & (s.v_val == tpc.COMMIT)
        resolved = (
            (s.v_tid[..., :, None] == s.o_tid[..., None, :])
            & (s.o_tid[..., None, :] >= 0)
        ).any(-1)
        doubt = voted_yes & ~resolved
        tid = torch.where(doubt, s.v_tid, 2**30).amin(-1)
        give_up = (nid != 0) & doubt.any(-1) & (prng.uniform(key, 77) < 0.5)
        at = (torch.arange(s.o_tid.shape[-1]) == torch.remainder(
            tid, s.o_tid.shape[-1])[..., None]) & give_up[..., None]
        state = state._replace(
            o_tid=torch.where(at, tid[..., None], state.o_tid),
            o_val=torch.where(at, tpc.ABORT, state.o_val),
        )
        return state, out, timer

    buggy = replace_handlers(spec, on_timer=impatient_timer)
    assert buggy.on_event is None
    full_chaos = dict(
        horizon_us=8_000_000, msg_capacity=128, loss_rate=0.1,
        crash_interval_lo_us=400_000, crash_interval_hi_us=2_000_000,
        restart_delay_lo_us=200_000, restart_delay_hi_us=1_000_000,
        partition_interval_lo_us=400_000, partition_interval_hi_us=1_500_000,
        partition_heal_lo_us=300_000, partition_heal_hi_us=1_200_000,
    )
    jst, pst = run_both(
        jax_replace_handlers(jspec, on_timer=jax_impatient_timer),
        JaxConfig(**full_chaos), buggy, SimConfig(**full_chaos),
        list(range(16)), 300,
    )
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert_leaves_equal(want, got, "twopc impatient timer")
    assert violations(got) == violations(want)
    assert len(violations(got)) >= 1


# ----------------------------------------------------------- linearize

def _numpy_node(leaves):
    """A JAX-face-style node view (numpy leaves) of a port state's leaves."""
    names = [k[len("node."):] for k in leaves if k.startswith("node.")]
    return collections.namedtuple("KvNode", names)(
        *(leaves[f"node.{n}"] for n in names)
    )


def test_linearize_equals_the_original_on_run_histories():
    """Both checkers over the same recorded histories: the port's copy on
    the port's tensors, the original on their numpy values."""
    wl = kv_workload(virtual_secs=2.0)
    res = run_batch(range(16), wl, device="cpu")
    st = res.state
    lanes = list(range(16))
    mine = linearize.check_lanes(st.node, lanes)
    ref = jax_linearize.check_lanes(_numpy_node(state_to_numpy(st)), lanes)
    assert mine == ref
    assert mine["ops_checked"] > 50 and mine["violations"] == 0
    # run_batch's deep-oracle leg ran the same checker on its sample
    assert res.summary["lane_check_histories_checked"] == 16
    assert res.summary["lane_check_violations"] == 0


def _op(mod, tinv, trsp, w, val, rev=0, node=0):
    return mod.Op(tinv=tinv, trsp=trsp, is_write=w, key=0, val=val, rev=rev,
                  node=node)


HISTORIES = {
    "sequential": [(0, 5, True, 7), (6, 9, False, 7)],
    "stale-read": [(0, 5, True, 7), (6, 9, True, 8), (10, 12, False, 7)],
    "concurrent": [(0, 10, True, 7), (1, 3, False, 7), (4, 6, False, 0)],
    "future-read": [(0, 2, False, 7), (5, 9, True, 7)],
    "unmatched": [(0, 2, False, 99), (3, 4, True, 5)],
    "duplicate-write": [(0, 2, True, 5), (3, 4, True, 5)],
}


@pytest.mark.parametrize("name", sorted(HISTORIES))
def test_linearize_key_history_verdicts_equal(name):
    results = []
    for mod in (linearize, jax_linearize):
        ops = [_op(mod, *h) for h in HISTORIES[name]]
        ok, ce, unmatched = mod.check_key_history(ops)
        results.append((ok, None if ce is None else [str(o) for o in ce],
                        unmatched))
    assert results[0] == results[1]
