"""Raft handlers and one engine step of the port against the JAX engine.

States are JAX-engine states snapshotted mid-run and carried across with
`convert.state_from_numpy`, so a fault shows at the step and the handler
where it happens. All comparisons are exact (values widened to int64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import bench
from madsim_tpu.tpu import BatchedSim as JaxSim
from madsim_tpu.tpu import SimConfig as JaxConfig
from madsim_tpu.tpu import make_raft_spec as jax_raft_spec
from madsim_tpu.tpu.engine import named_leaves
from madsim_tpu_torch.tpu import BatchedSim, SimConfig, make_raft_spec
from madsim_tpu_torch.tpu.convert import state_from_numpy, state_to_numpy
from madsim_tpu_torch.tpu.raft import RaftState, raft_bench_config, verify_chain_cache
from madsim_tpu_torch.tpu.spec import tree_leaves

LANES = 16
SNAPSHOTS = (0, 1, 37, 150, 400, 700, 1000)
ENTRY = dict(horizon_us=5_000_000, loss_rate=0.1,
             crash_interval_lo_us=500_000, crash_interval_hi_us=3_000_000)
CONFIGS = {
    "raft_bench": (
        lambda: (jax_raft_spec(5, client_rate=0.1, log_capacity=16),
                 bench.raft_bench_config(10.0)),
        lambda: (make_raft_spec(5, client_rate=0.1, log_capacity=16),
                 raft_bench_config(10.0)),
    ),
    "raft_entry": (
        lambda: (jax_raft_spec(5), JaxConfig(**ENTRY)),
        lambda: (make_raft_spec(5), SimConfig(**ENTRY)),
    ),
}


def jax_leaves(state):
    return {k: np.asarray(v) for k, v in named_leaves(state)}


def assert_leaves_equal(want, got, context):
    want = {k: np.asarray(v).astype(np.int64) for k, v in want.items()}
    assert set(want) == set(got), (context, set(want) ^ set(got))
    bad = [k for k in want if not np.array_equal(want[k], got[k])]
    assert not bad, f"{context}: leaves differ: {bad}"


_SNAPS = {}


def snapshots(name):
    """JAX states at SNAPSHOTS step counts and the states one step later."""
    if name not in _SNAPS:
        jspec, jcfg = CONFIGS[name][0]()
        jsim = JaxSim(jspec, jcfg)
        st = jsim.init(jnp.arange(LANES, dtype=jnp.uint32))
        out = []
        for i in range(max(SNAPSHOTS) + 1):
            nxt = jsim.step(st)
            if i in SNAPSHOTS:
                out.append((i, jax_leaves(st), jax_leaves(nxt)))
            st = nxt
        _SNAPS[name] = (jsim, out)
    return _SNAPS[name]


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_one_step_from_jax_snapshots_leaf_equal(name):
    _, snaps = snapshots(name)
    spec, cfg = CONFIGS[name][1]()
    sim = BatchedSim(spec, cfg, device="cpu")
    for i, before, after in snaps:
        state = state_from_numpy(before, "cpu", RaftState)
        assert_leaves_equal(before, state_to_numpy(state), f"{name} convert@{i}")
        assert_leaves_equal(after, state_to_numpy(sim.step(state)),
                            f"{name} step {i}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_init_leaf_equal(name):
    jspec, jcfg = CONFIGS[name][0]()
    spec, cfg = CONFIGS[name][1]()
    seeds = np.array([0, 1, 7, 2**31 - 1, 2**32 - 1], np.uint32)
    want = jax_leaves(JaxSim(jspec, jcfg).init(jnp.asarray(seeds)))
    got = state_to_numpy(BatchedSim(spec, cfg, device="cpu").init(seeds))
    assert_leaves_equal(want, got, f"{name} init")


def _handler_inputs(seed, L, N, P):
    rng = np.random.default_rng(seed)
    kind = rng.integers(-1, 5, size=(L, N)).astype(np.int32)
    src = rng.integers(0, N, size=(L, N)).astype(np.int32)
    payload = rng.integers(-2, 40, size=(L, N, P)).astype(np.int32)
    now = rng.integers(0, 10_000_000, size=(L, N)).astype(np.int32)
    key = rng.integers(0, 2**32, size=(L, N), dtype=np.uint64).astype(np.uint32)
    return kind, src, payload, now, key


def _jax_node(jsim, leaves):
    """The widened JAX node pytree and the port's node from the same leaves."""
    node = {k[5:]: v for k, v in leaves.items() if k.startswith("node.")}
    jnode = jsim._widen_node(type(jsim.init(jnp.arange(1)).node)(
        **{k: jnp.asarray(v) for k, v in node.items()}
    ))
    tnode = state_from_numpy(leaves, "cpu", RaftState).node
    return jnode, tnode


def _assert_tree_equal(jtree, ttree, context):
    jl = [np.asarray(x).astype(np.int64) for x in jax.tree_util.tree_leaves(jtree)]
    tl = [x.numpy().astype(np.int64) for x in tree_leaves(ttree)]
    assert len(jl) == len(tl), context
    for i, (a, b) in enumerate(zip(jl, tl)):
        np.testing.assert_array_equal(b, a, err_msg=f"{context} leaf {i}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_handlers_on_reachable_states_equal_jax(name):
    """on_event / on_restart / check_invariants / lane_metrics on states a
    JAX run reached, with random event inputs (every kind and the timer)."""
    jsim, snaps = snapshots(name)
    spec, _ = CONFIGS[name][1]()
    jspec = jsim.spec
    N, P = spec.n_nodes, spec.payload_width
    v_event = jax.jit(jsim._v_on_event)
    v_restart = jax.jit(jsim._v_on_restart)
    v_check = jax.jit(jsim._v_check)
    for i, leaves, _ in snaps:
        jnode, tnode = _jax_node(jsim, leaves)
        kind, src, payload, now, key = _handler_inputs(i, LANES, N, P)
        nid = np.broadcast_to(np.arange(N, dtype=np.int32), (LANES, N))
        j_out = v_event(jnode, jnp.asarray(nid), jnp.asarray(src),
                        jnp.asarray(kind), jnp.asarray(payload),
                        jnp.asarray(now), jnp.asarray(key))
        t_out = spec.on_event(
            tnode, torch.as_tensor(nid.copy()), torch.as_tensor(src),
            torch.as_tensor(kind), torch.as_tensor(payload),
            torch.as_tensor(now), torch.as_tensor(key.astype(np.int64)),
        )
        _assert_tree_equal(j_out, t_out, f"{name} on_event@{i}")
        t_now = now[:, 0].copy()
        _assert_tree_equal(
            v_restart(jnode, jnp.asarray(nid), jnp.asarray(t_now),
                      jnp.asarray(key)),
            spec.on_restart(tnode, torch.as_tensor(nid.copy()),
                            torch.as_tensor(t_now),
                            torch.as_tensor(key.astype(np.int64))),
            f"{name} on_restart@{i}",
        )
        alive = np.random.default_rng(i).random((LANES, N)) < 0.8
        np.testing.assert_array_equal(
            spec.check_invariants(tnode, torch.as_tensor(alive),
                                  torch.as_tensor(t_now)).numpy(),
            np.asarray(v_check(jnode, jnp.asarray(alive), jnp.asarray(t_now))),
        )
        jm = jspec.lane_metrics(jnode)
        tm = spec.lane_metrics(tnode)
        assert set(jm) == set(tm)
        for k in jm:
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       rtol=1e-6)
        assert verify_chain_cache(tnode)


def test_buggify_leader_mute_equal_jax():
    """make_raft_spec(buggify_rate=...) mutes leader broadcasts on the same
    coin on both faces."""
    _, snaps = snapshots("raft_bench")
    kw = dict(n_nodes=5, client_rate=0.1, log_capacity=16, buggify_rate=0.5)
    jsim = JaxSim(jax_raft_spec(**kw), bench.raft_bench_config(10.0))
    spec = make_raft_spec(**kw)
    v_event = jax.jit(jsim._v_on_event)
    muted = 0
    for i, leaves, _ in snaps:
        jnode, tnode = _jax_node(jsim, leaves)
        _, src, payload, now, key = _handler_inputs(i + 100, LANES, 5, 6)
        kind = np.full((LANES, 5), -1, np.int32)  # every node's timer fires
        nid = np.broadcast_to(np.arange(5, dtype=np.int32), (LANES, 5))
        j_out = v_event(jnode, jnp.asarray(nid), jnp.asarray(src),
                        jnp.asarray(kind), jnp.asarray(payload),
                        jnp.asarray(now), jnp.asarray(key))
        t_out = spec.on_event(
            tnode, torch.as_tensor(nid.copy()), torch.as_tensor(src),
            torch.as_tensor(kind), torch.as_tensor(payload),
            torch.as_tensor(now), torch.as_tensor(key.astype(np.int64)),
        )
        _assert_tree_equal(j_out, t_out, f"buggify on_event@{i}")
        leader = tnode.role == 2
        muted += int((leader & ~t_out[1].valid.any(-1)).sum())
    assert muted > 0  # the coin fired on some leader


def test_invariant_check_flags_a_corrupted_state():
    """check_invariants is not vacuous: two leaders of one term fail
    election safety on both faces."""
    name = "raft_bench"
    jsim, snaps = snapshots(name)
    spec, _ = CONFIGS[name][1]()
    leaves = dict(snaps[-1][1])
    role = leaves["node.role"].astype(np.int32).copy()
    term = leaves["node.term"].astype(np.int32).copy()
    role[:, :2] = 2
    term[:, 1] = term[:, 0]
    leaves["node.role"], leaves["node.term"] = role, term
    jnode, tnode = _jax_node(jsim, leaves)
    alive = np.ones((LANES, spec.n_nodes), bool)
    now = np.zeros(LANES, np.int32)
    want = np.asarray(jax.jit(jsim._v_check)(jnode, jnp.asarray(alive),
                                             jnp.asarray(now)))
    got = spec.check_invariants(tnode, torch.as_tensor(alive),
                                torch.as_tensor(now)).numpy()
    np.testing.assert_array_equal(got, want)
    assert not got.any()


class _OpLog(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def test_integer_contractions_avoid_matmul():
    """The integer-contraction trap: CUDA has no integer matmul, so no step
    op may be a matmul/einsum family op (the JAX face's einsums are
    select-and-sum here)."""
    spec, cfg = CONFIGS["raft_bench"][1]()
    sim = BatchedSim(spec, cfg, device="cpu")
    state = sim.init(range(4))
    with _OpLog() as log:
        for _ in range(3):
            state = sim.step(state)
    banned = {"mm", "bmm", "matmul", "addmm", "einsum", "dot", "baddbmm",
              "tensordot", "_int_mm"}
    assert not (log.ops & banned), log.ops & banned


def test_stored_leaf_dtypes_keep_jax_value_semantics():
    """The dtype trap: torch's sum of int32/bool returns int64, so every
    stored leaf is pinned to its declared dtype after whole steps — int32
    for the JAX face's i32 (and narrow) leaves, int64 for u32 values."""
    spec, cfg = CONFIGS["raft_bench"][1]()
    sim = BatchedSim(spec, cfg, device="cpu")
    state = sim.run_steps(sim.init(range(4)), 40)
    for f, x in zip(RaftState._fields, state.node):
        want = torch.int64 if f == "log_chain" else torch.int32
        assert x.dtype == want, f
    for f in ("clock", "epoch", "steps", "events", "timer", "chaos_at",
              "part_at", "overflow", "dead_drops", "fires"):
        assert getattr(state, f).dtype == torch.int32, f
    for f in ("key", "key0", "alive_p", "link_ok_p"):
        assert getattr(state, f).dtype == torch.int64, f
