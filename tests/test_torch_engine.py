"""The port's engine against the JAX engine over whole runs.

Full runs of the headline bench config and the `entry()` config to the end
of their horizons (64 lanes, seeds 0..63), compared leaf for leaf with
values widened to int64; `summarize` equal (float lane means at
rtol=1e-6, their sums run in another order); the pinned digests; an epoch
rebase from a shifted state; the argmin tie order; the early stop; the
once-refused clauses and options (the device-loop plane included), each
run 40 steps leaf-equal; and the configurations both faces refuse.
"""

import fcntl
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench
from madsim_tpu.tpu import BatchedSim as JaxSim
from madsim_tpu.tpu import SimConfig as JaxConfig
from madsim_tpu.tpu import make_raft_spec as jax_raft_spec
from madsim_tpu.tpu import summarize as jax_summarize
from madsim_tpu.tpu.engine import named_leaves
from madsim_tpu_torch.tpu import BatchedSim, SimConfig, make_raft_spec, summarize
from madsim_tpu_torch.tpu import engine as tengine
from madsim_tpu_torch.tpu.convert import state_from_numpy, state_to_numpy
from madsim_tpu_torch.tpu.digest import PINNED, canonical_digest, pinned_run
from madsim_tpu_torch.tpu.raft import RaftState, raft_bench_config
from madsim_tpu_torch.tpu.spec import INF_GUARD, REBASE_US

# The port's CPU tests run torch single-threaded. Under the suite's
# pytest-xdist workers (each worker imports every test module before it
# runs a test, so this holds in all of them), torch's intra-op pool, one
# thread per core in every worker, oversubscribes the cores: five
# processes tracing a 100000-step seed (1024-lane idle blocks) took 843 s
# each with the default pool and 15 s each with one thread. No result
# depends on the thread count.
torch.set_num_threads(1)


def jax_faces(name):
    """The JAX (spec, config) of a pinned run."""
    if name == "raft_bench":
        return (jax_raft_spec(5, client_rate=0.1, log_capacity=16),
                bench.raft_bench_config(10.0))
    return (jax_raft_spec(5), JaxConfig(
        horizon_us=5_000_000, loss_rate=0.1,
        crash_interval_lo_us=500_000, crash_interval_hi_us=3_000_000,
    ))


def jax_leaves(state):
    return {k: np.asarray(v).astype(np.int64) for k, v in named_leaves(state)}


def assert_leaves_equal(want, got, context):
    assert set(want) == set(got), (context, set(want) ^ set(got))
    bad = [k for k in want if not np.array_equal(want[k], got[k])]
    assert not bad, f"{context}: leaves differ: {bad}"


def assert_summaries_equal(a, b):
    assert set(a) == set(b), set(a) ^ set(b)
    for k in a:
        if isinstance(a[k], float):
            np.testing.assert_allclose(b[k], a[k], rtol=1e-6, err_msg=k)
        else:
            assert a[k] == b[k], k


def shared_dir(tmp_path_factory):
    """A directory every pytest-xdist worker of this test run shares, and
    only this run: xdist's run id under the workers' common base temp, or
    this process's base temp without xdist."""
    run = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = base.parent / f"shared-{run}" if run else base / "shared"
    root.mkdir(parents=True, exist_ok=True)
    return root


def shared_across_workers(tmp_path_factory, name, build):
    """`build()` once per test run, whichever pytest-xdist workers ask:
    the first caller builds under an exclusive lock file in `shared_dir`
    and pickles the result, the others wait on the lock and load it."""
    root = shared_dir(tmp_path_factory)
    path = root / f"{name}.pkl"
    with open(root / f"{name}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if path.exists():
                with open(path, "rb") as f:
                    return pickle.load(f)
            value = build()
            with open(f"{path}.tmp", "wb") as f:
                pickle.dump(value, f)
            os.replace(f"{path}.tmp", path)
            return value
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def _pinned_runs(name):
    """Both faces' full runs of one pinned config: (JAX leaves, the JAX
    summary, the repo's golden digest of the JAX state, the port's leaves,
    the port's summary)."""
    from test_state_layout import canonical_digest as jax_canonical_digest

    spec, cfg, seeds, max_steps = pinned_run(name)
    jspec, jcfg = jax_faces(name)
    assert jcfg.to_toml() == cfg.to_toml()
    jst = JaxSim(jspec, jcfg).run(
        jnp.asarray(seeds, jnp.uint32), max_steps=max_steps
    )
    pst = BatchedSim(spec, cfg, device="cpu").run(seeds, max_steps=max_steps)
    return (jax_leaves(jst), jax_summarize(jst, jspec),
            jax_canonical_digest(jst), state_to_numpy(pst),
            summarize(pst, spec))


@pytest.fixture(scope="session")
def pinned(tmp_path_factory):
    """pinned(name): both faces' full runs of one pinned config, run once
    per test run (shared_across_workers)."""
    return lambda name: shared_across_workers(
        tmp_path_factory, f"engine-pinned-{name}",
        lambda: _pinned_runs(name))


@pytest.mark.parametrize("name", ["raft_bench", "raft_entry"])
def test_full_run_leaf_equal(name, pinned):
    jleaves, _, _, got, _ = pinned(name)
    assert_leaves_equal(jleaves, got, name)
    # the whole horizon ran (the bench config's 10 virtual seconds take
    # ~1200 steps) and the sweep did real work
    assert got["done"].all()
    assert got["steps"].max() >= (1200 if name == "raft_bench" else 600)


@pytest.mark.parametrize("name", ["raft_bench", "raft_entry"])
def test_summarize_equal(name, pinned):
    _, js, _, _, ps = pinned(name)
    assert_summaries_equal(js, ps)
    assert ps["total_events"] > 0 and ps["fires_crash"] > 0
    assert ps["total_overflow"] == 0


@pytest.mark.parametrize("name", ["raft_bench", "raft_entry"])
def test_pinned_digest_matches_jax_engine(name, pinned):
    """The constants chip_smoke.py holds the card to are the JAX engine's:
    the port's digest function equals the repo's golden-digest function
    on the JAX state, and both runs hash to the pinned value."""
    jleaves, _, jdigest, pleaves, _ = pinned(name)
    assert jdigest == PINNED[name]
    assert canonical_digest(jleaves) == PINNED[name]
    assert canonical_digest(pleaves) == PINNED[name]


def _shift_to_rebase(leaves, target=REBASE_US - 3_000):
    """Move every lane's clock and live time offsets so its clock sits just
    under REBASE_US (sentinels >= INF_GUARD untouched)."""
    out = dict(leaves)
    delta = (target - leaves["clock"].astype(np.int64))  # [L]
    for k in ("clock", "timer", "chaos_at", "part_at", "msgs.deliver"):
        v = leaves[k].astype(np.int64)
        d = delta.reshape((-1,) + (1,) * (v.ndim - 1))
        out[k] = np.where(v < INF_GUARD, v + d, v).astype(leaves[k].dtype)
    return out


def test_epoch_rebase_from_shifted_state():
    """Phase 8: a mid-run state shifted to just under REBASE_US, stepped on
    both faces until every lane rebased, is leaf-equal throughout."""
    kw = dict(n_nodes=5, client_rate=0.1, log_capacity=16)
    jcfg = bench.raft_bench_config(400.0)
    cfg = raft_bench_config(400.0)
    jsim = JaxSim(jax_raft_spec(**kw), jcfg)
    st = jsim.init(jnp.arange(16, dtype=jnp.uint32))
    for _ in range(120):
        st = jsim.step(st)
    leaves, treedef = jax.tree_util.tree_flatten(st)
    names = [k for k, _ in named_leaves(st)]
    shifted = _shift_to_rebase({k: np.asarray(v) for k, v in zip(names, leaves)})
    jst = jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(shifted[k]) for k in names]
    )
    sim = BatchedSim(make_raft_spec(**kw), cfg, device="cpu")
    pst = state_from_numpy(shifted, "cpu", RaftState)
    for i in range(60):
        jst = jsim.step(jst)
        pst = sim.step(pst)
    want = jax_leaves(jst)
    assert_leaves_equal(want, state_to_numpy(pst), "rebase")
    assert (want["epoch"] == 1).all() and (want["clock"] < REBASE_US).all()


def test_argmin_tie_order_first_minimum():
    """The tie trap: the event pick's argmin returns the FIRST minimum on
    the port as jnp.argmin does, over u32 priorities held in int64 and
    int32 times alike."""
    rng = np.random.default_rng(0)
    for dtype, hi in ((np.int64, 2**32), (np.int32, 2**31 - 1)):
        for vals in (3, 50, hi):
            a = rng.integers(0, vals, size=(64, 5, 40)).astype(dtype)
            a[:, :, -1] = a[:, :, 0]  # force ties at both ends
            want = np.asarray(jnp.argmin(jnp.asarray(
                a.astype(np.uint32) if dtype == np.int64 else a), axis=2))
            got = torch.as_tensor(a).argmin(dim=2).numpy()
            np.testing.assert_array_equal(got, want)
    # an engine step whose slots all tie picks the lowest slot
    a = np.full((2, 3, 8), 7, np.int64)
    assert (torch.as_tensor(a).argmin(dim=2) == 0).all()


def test_early_stop_and_segments_match_jax_loop():
    """Truncated runs (max_steps below the horizon) and odd segment sizes
    end on the JAX loop's state, key leaf included."""
    jspec, jcfg = jax_faces("raft_entry")
    spec, cfg, _, _ = pinned_run("raft_entry")
    seeds = list(range(8))
    jsim = JaxSim(jspec, jcfg)
    jst = jsim.run(jnp.arange(8, dtype=jnp.uint32), max_steps=97,
                   dispatch_steps=97)
    sim = BatchedSim(spec, cfg, device="cpu")
    for dispatch in (7, 40, 10_000):
        pst = sim.run(seeds, max_steps=97, dispatch_steps=dispatch)
        assert_leaves_equal(jax_leaves(jst), state_to_numpy(pst),
                            f"dispatch={dispatch}")
    # once every lane is done, a gated step changes nothing and an ungated
    # one (the JAX face's step, held equal in test_torch_raft.py) advances
    # `key` alone: a 1 us horizon finishes every lane in one step
    import dataclasses

    sim = BatchedSim(spec, dataclasses.replace(cfg, horizon_us=1), device="cpu")
    done = sim.step(sim.init([0, 1]))
    assert bool(done.done.all())
    want = state_to_numpy(done)
    gated = state_to_numpy(sim._step(done, gate_key=True))
    ungated = state_to_numpy(sim.step(done))
    assert_leaves_equal(want, gated, "gated step after all done")
    assert not np.array_equal(ungated.pop("key"), want.pop("key"))
    assert_leaves_equal(want, ungated, "ungated step after all done")


REFUSED = [
    ("nem_crash", dict(crash_interval_hi_us=0, nem_crash_interval_lo_us=1,
                       nem_crash_interval_hi_us=10)),
    ("nem_partition", dict(partition_interval_hi_us=0,
                           nem_partition_interval_lo_us=1,
                           nem_partition_interval_hi_us=10)),
    ("nem_clog", dict(nem_clog_interval_lo_us=1, nem_clog_interval_hi_us=10)),
    ("nem_spike", dict(nem_spike_interval_lo_us=1, nem_spike_interval_hi_us=10)),
    ("nem_loss", dict(nem_loss_rate=0.1)),
    ("nem_dup", dict(nem_dup_rate=0.1)),
    ("nem_reorder", dict(nem_reorder_rate=0.1, nem_reorder_window_us=5)),
    ("nem_skew", dict(nem_skew_max_ppm=100)),
    ("nem_reconfig", dict(nem_reconfig_interval_lo_us=1,
                          nem_reconfig_interval_hi_us=10)),
    ("nem_disk", dict(nem_disk_interval_lo_us=1, nem_disk_interval_hi_us=10)),
    ("straggler pool", dict(buggify_delay_rate=0.01)),
]


@pytest.mark.parametrize("what,kw", REFUSED, ids=[r[0] for r in REFUSED])
def test_construction_refuses_out_of_slice_config(what, kw):
    """Every one of these clauses was once refused at construction; all are
    ported now (items 4, 6 and 8), so each config runs 40 steps leaf-equal
    to the JAX engine."""
    import dataclasses

    cfg = dataclasses.replace(raft_bench_config(1.0), **kw)
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    jsim = JaxSim(jax_raft_spec(5), jcfg)
    sim = BatchedSim(make_raft_spec(5), cfg, device="cpu")
    jst = jsim.run(jnp.arange(8, dtype=jnp.uint32), max_steps=40,
                   dispatch_steps=40)
    pst = sim.run(range(8), max_steps=40, dispatch_steps=40)
    assert_leaves_equal(jax_leaves(jst), state_to_numpy(pst), what)


@pytest.mark.parametrize("opt", ["triage", "coverage", "lineage", "devloop",
                                 "two_handler"])
def test_construction_refuses_out_of_slice_option(opt):
    """Every one of these options was once refused at construction: a
    two-handler spec (item 4), a triage sim with its default ctl (item
    10), a coverage sim and a lineage sim (item 9) and a device-loop sim
    (its plan is inert outside `init_devloop`) each run 40 steps
    leaf-equal to the JAX engine (the ctl's float32 rate scales compared
    exactly)."""
    from madsim_tpu.tpu.spec import replace_handlers as jax_replace_handlers
    from madsim_tpu_torch.tpu.spec import replace_handlers

    spec, cfg = make_raft_spec(5), SimConfig(horizon_us=1_000_000)
    kw = {"device": "cpu"}
    if opt in ("triage", "coverage", "lineage", "devloop"):
        from madsim_tpu.tpu.engine import make_devloop_plan as jax_plan

        jkw, pkw = {opt: True}, {opt: True}
        if opt == "devloop":
            jkw = dict(triage=True, coverage=True, devloop=jax_plan(
                JaxConfig(horizon_us=1_000_000), pop=8))
            pkw = dict(triage=True, coverage=True,
                       devloop=tengine.make_devloop_plan(cfg, pop=8))
            assert tuple(pkw["devloop"]) == tuple(jkw["devloop"])
        jst = JaxSim(jax_raft_spec(5), JaxConfig(horizon_us=1_000_000),
                     **jkw).run(jnp.arange(8, dtype=jnp.uint32),
                                max_steps=40, dispatch_steps=40)
        pst = BatchedSim(spec, cfg, **pkw, **kw).run(
            range(8), max_steps=40, dispatch_steps=40)
        want = {k: np.asarray(v).astype(
                    np.float64 if np.asarray(v).dtype.kind == "f" else np.int64)
                for k, v in named_leaves(jst)}
        plane = {"triage": "ctl.", "coverage": "cov.", "lineage": "lin.",
                 "devloop": "cov."}[opt]
        assert any(k.startswith(plane) for k in want)
        assert_leaves_equal(want, state_to_numpy(pst), opt)
        return
    if opt == "two_handler":
        jspec = jax_raft_spec(5)
        jspec = jax_replace_handlers(jspec, on_message=jspec.on_message)
        jst = JaxSim(jspec, JaxConfig(horizon_us=1_000_000)).run(
            jnp.arange(8, dtype=jnp.uint32), max_steps=40, dispatch_steps=40)
        spec = replace_handlers(spec, on_message=spec.on_message)
        pst = BatchedSim(spec, cfg, **kw).run(
            range(8), max_steps=40, dispatch_steps=40)
        assert_leaves_equal(jax_leaves(jst), state_to_numpy(pst), opt)
        return


def test_both_faces_refuse_the_narrow_horizon():
    """Configs past the u16-term safe horizon raise ValueError on both
    faces (the JAX face would wrap its narrow terms)."""
    h = 65_535 * 150_000 // 5 + 1
    with pytest.raises(ValueError, match="narrow-dtype safe horizon"):
        JaxSim(jax_raft_spec(5), JaxConfig(horizon_us=h))
    with pytest.raises(ValueError, match="narrow-dtype safe horizon"):
        BatchedSim(make_raft_spec(5), SimConfig(horizon_us=h), device="cpu")
    with pytest.raises(ValueError, match="loss_rate"):
        BatchedSim(make_raft_spec(5), SimConfig(loss_rate=1.0), device="cpu")


def test_default_device_without_card_raises(monkeypatch):
    """Entry points default to the card and never fall back to the CPU."""
    from madsim_tpu_torch.tpu import raft_workload, run_batch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BatchedSim(make_raft_spec(5), SimConfig())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_batch(range(2), raft_workload(virtual_secs=0.1))
    assert tengine.resolve_device("cpu") == torch.device("cpu")
