"""The port's two-handler path and straggler side pool against the JAX engine.

`_first_free` and `_tree_where` equal the JAX functions on seeded numpy
inputs; Raft and 2PC specs run through `replace_handlers` (on_event=None,
so both handlers run and their states merge 3-way) at equal and unequal
per-class ring depths and with duplication; the heavy-tail straggler pool
on fused and two-handler specs at depths 1, 4 and 8; and the planted
unilateral-abort 2PC participant of tests/test_buggify.py under its quiet
config with a 5% tail, which violates on the same lanes at the same steps
on both faces. Tolerance everywhere: exact, leaf for leaf, after widening
to int64. Sizes are cut to stay CPU-cheap (8-32 lanes, at most 300 steps);
both faces always run the same seeds and step counts.
"""

import collections
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu.tpu import SimConfig as JaxConfig
from madsim_tpu.tpu import make_raft_spec as jax_raft_spec
from madsim_tpu.tpu import make_twopc_spec as jax_twopc_spec
from madsim_tpu.tpu.engine import _first_free as jax_first_free
from madsim_tpu.tpu.engine import _tree_where as jax_tree_where
from madsim_tpu.tpu.spec import replace_handlers as jax_replace_handlers
from madsim_tpu_torch.tpu import (
    BatchedSim, SimConfig, make_raft_spec, make_twopc_spec, replace_handlers,
    unilateral_abort_spec,
)
from madsim_tpu_torch.tpu.convert import state_to_numpy
from madsim_tpu_torch.tpu.engine import _first_free, _tree_where
from test_buggify import quiet_config as jax_quiet_config
from test_buggify import unilateral_abort_spec as jax_unilateral_abort_spec
from test_torch_engine import assert_leaves_equal, jax_leaves
from test_torch_workloads import run_both, violations

# ------------------------------------------------------------ primitives


@pytest.mark.parametrize("K", [1, 2, 3, 4, 8])
def test_first_free_matches_jax(K):
    rng = np.random.default_rng(K)
    free = rng.random((16, 12, K)) < 0.4
    free[0] = False  # rows with no free slot
    free[1] = True  # rows with every slot free
    want = np.asarray(jax_first_free(jnp.asarray(free), K))
    got = _first_free(torch.as_tensor(free), K).numpy()
    np.testing.assert_array_equal(got, want)
    # one slot per row at most, and only where one is free
    assert (got.sum(-1) == free.any(-1)).all()


def test_tree_where_matches_jax():
    rng = np.random.default_rng(7)
    T = collections.namedtuple("T", "a b c")
    L, N = 8, 5
    shapes = dict(a=(L, N), b=(L, N, 4), c=(L, N, 3, 2))
    x = T(**{k: rng.integers(-50, 50, s).astype(np.int32)
             for k, s in shapes.items()})
    y = T(**{k: rng.integers(-50, 50, s).astype(np.int32)
             for k, s in shapes.items()})
    mask = rng.random((L, N)) < 0.5
    want = jax_tree_where(jnp.asarray(mask), T(*map(jnp.asarray, x)),
                          T(*map(jnp.asarray, y)))
    got = _tree_where(torch.as_tensor(mask), T(*map(torch.as_tensor, x)),
                      T(*map(torch.as_tensor, y)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# --------------------------------------------------------- the two handlers


def two_handler(name, face):
    """A factory's spec with its handlers replaced by themselves: the fused
    on_event is cleared, so the engine takes the two-handler path."""
    if face == "jax":
        spec = {"raft": jax_raft_spec, "twopc": jax_twopc_spec}[name](5)
        return jax_replace_handlers(spec, on_message=spec.on_message)
    spec = {"raft": make_raft_spec, "twopc": make_twopc_spec}[name](5)
    return replace_handlers(spec, on_message=spec.on_message)


CHAOS = dict(
    horizon_us=2_000_000, loss_rate=0.05,
    crash_interval_lo_us=300_000, crash_interval_hi_us=900_000,
    restart_delay_lo_us=200_000, restart_delay_hi_us=600_000,
    partition_interval_lo_us=300_000, partition_interval_hi_us=900_000,
)
DEPTHS = {
    "equal-2-2": dict(msg_depth_msg=2, msg_depth_timer=2),
    "unequal-1-3": dict(msg_depth_msg=1, msg_depth_timer=3),
    "dup-2-1": dict(msg_depth_msg=2, msg_depth_timer=1, nem_dup_rate=0.2),
}


@pytest.mark.parametrize("depths", sorted(DEPTHS))
@pytest.mark.parametrize("name", ["raft", "twopc"])
def test_two_handler_leaf_equal(name, depths):
    """Both handlers run, their states merge with the restart's, and each
    candidate takes the first free of its class's K ring slots: two
    segments when the depths differ, both bounds doubled under
    duplication."""
    kw = dict(CHAOS, **DEPTHS[depths])
    sim = BatchedSim(two_handler(name, "torch"), SimConfig(**kw), device="cpu")
    km, kt = kw["msg_depth_msg"], kw["msg_depth_timer"]
    mult = 2 if "nem_dup_rate" in kw else 1
    cm = 5 * 5 * mult  # max_out_msg == max_out == N for both specs
    assert sim._CK == cm * km + cm * kt
    if km == kt:
        assert sim._segs == ((0, 2 * cm, km, 0, sim._CK),)
    else:
        assert sim._segs == ((0, cm, km, 0, cm * km),
                             (cm, 2 * cm, kt, cm * km, sim._CK))
    jst, pst = run_both(two_handler(name, "jax"), JaxConfig(**kw),
                        two_handler(name, "torch"), SimConfig(**kw),
                        list(range(8)), 100)
    got = state_to_numpy(pst)
    assert_leaves_equal(jax_leaves(jst), got, f"{name} {depths}")
    assert got["events"].sum() > 0 and got["fires"][:, 0].sum() > 0


def test_two_handler_refuses_spare_slots():
    """msg_spare_slots belongs to the fused path's node pools; both faces
    refuse it on a two-handler spec."""
    cfg = dict(horizon_us=1_000_000, msg_spare_slots=2)
    from madsim_tpu.tpu import BatchedSim as JaxSim

    with pytest.raises(ValueError, match="msg_spare_slots"):
        JaxSim(two_handler("raft", "jax"), JaxConfig(**cfg))
    with pytest.raises(ValueError, match="msg_spare_slots"):
        BatchedSim(two_handler("raft", "torch"), SimConfig(**cfg),
                   device="cpu")


# ------------------------------------------------------ the straggler pool

STRAG = {
    # name: (two-handler spec?, extra config)
    "fused-depth1": (False, dict(msg_depth_msg=2, buggify_depth=1)),
    "fused-depth8": (False, dict(msg_depth_msg=2, buggify_depth=8)),
    "two-handler-depth4": (True, dict(msg_depth_msg=2, msg_depth_timer=2)),
    "two-handler-dup": (True, dict(msg_depth_msg=2, msg_depth_timer=2,
                                   nem_dup_rate=0.1)),
}


@pytest.mark.parametrize("case", sorted(STRAG))
def test_straggler_pool_leaf_equal(case):
    """twopc at buggify_delay_rate 0.1: tail sends ride the side pool (K4
    slots per candidate), are picked only when strictly earlier than the
    main pool's head, and are consumed when delivered."""
    th, extra = STRAG[case]
    kw = dict(horizon_us=3_000_000, buggify_delay_rate=0.1, **extra)
    if th:
        jspec, tspec = two_handler("twopc", "jax"), two_handler("twopc", "torch")
    else:
        jspec, tspec = jax_twopc_spec(5), make_twopc_spec(5)
    jst, pst = run_both(jspec, JaxConfig(**kw), tspec, SimConfig(**kw),
                        list(range(8)), 250)
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert_leaves_equal(want, got, case)
    k4 = max(1, kw.get("buggify_depth", 4))
    assert got["strag.valid"].shape[1] % k4 == 0
    assert got["strag.valid"].any()
    # stragglers came due and were delivered: the lanes ran past the
    # shortest tail (1 s)
    assert got["clock"].max() > 1_000_000


def test_unilateral_abort_fires_on_the_same_lanes_under_the_tail():
    """tests/test_buggify.py's planted participant under its quiet config
    with a 5% heavy tail: the two-handler spec (replace_handlers on
    on_timer) with stragglers violates on the same lanes at the same steps
    on both faces (the JAX test's 128 lanes x 40000 steps cut to 32 lanes x
    200 steps)."""
    jcfg = jax_quiet_config(buggify_delay_rate=0.05)
    tcfg = SimConfig(**dataclasses.asdict(jcfg))
    tspec = unilateral_abort_spec(5)
    assert tspec.on_event is None
    jst, pst = run_both(jax_unilateral_abort_spec(), jcfg, tspec, tcfg,
                        list(range(32)), 200)
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert_leaves_equal(want, got, "unilateral abort")
    assert violations(got) == violations(want)
    assert len(violations(got)) >= 1
