"""The port's lane mesh against the JAX package's multi-device face.

The JAX suite runs its sharding tests on eight virtual CPU devices
(tests/conftest.py); the port runs the same cases on meshes of repeated
CPU devices (`Mesh((cpu,) * D)`), the counterpart of those, and holds
each result against the JAX face's on its virtual mesh:
  * sharded refill rows (D = 2, 8) equal the one-shard refill's and the
    JAX face's sharded rows; every shard worked;
  * `run_batch(mesh=...)` is honored on the chunked and the refill paths,
    with the unsharded run's per-seed rows and summary;
  * the occupancy and scaling bars on the 10x horizon-spread mix, from
    `refill_results_sharded`;
  * `truncated` counts the stripped rows only, never the tail pad;
  * the two decoders refuse each other's states;
  * the chunked shrink refuses a mesh, and a sharded shrink writes the
    bundle of the unsharded one;
  * the 2-island federation on a 2-shard mesh is sharded and reaches
    `digest.PINNED_FEDERATION`, also across a kill and resume;
  * serve's device-aware round-robin over stub devices;
  * `run(mesh=)` is leaf-equal to `run`; a lane count the mesh does not
    divide, a mesh naming a card the host lacks and node-axis sharding
    (item 14b) are refused; twins on two devices share their counts and
    switches; `resolve_mesh`, the CLI's `--islands` mesh and
    `tune._mesh_for` over device counts.

Tolerances: exact everywhere (integer rows, leaves widened to int64).
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from madsim_tpu import nemesis as jn
from madsim_tpu.tpu import BatchedSim as JaxSim
from madsim_tpu.tpu import SimConfig as JaxConfig
from madsim_tpu.tpu import make_raft_spec as jax_raft_spec
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu.tpu.engine import TriageCtl as JaxCtl
from madsim_tpu.tpu.engine import refill_results_sharded as jax_sharded_rows
from madsim_tpu_torch import campaign, explore, triage, tune
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch.tpu import (
    BatchedSim, BatchWorkload, SimConfig, TriageCtl, make_raft_spec,
    run_batch,
)
from madsim_tpu_torch.tpu import nemesis as ttn
from madsim_tpu_torch.tpu.batch import resolve_mesh
from madsim_tpu_torch.tpu.convert import state_to_numpy
from madsim_tpu_torch.tpu.digest import (
    FEDERATION_GENERATIONS, FEDERATION_H_US, FEDERATION_RUN,
    PINNED_FEDERATION,
)
from madsim_tpu_torch.tpu.engine import (
    ShardedState, refill_results, refill_results_sharded,
)
from madsim_tpu_torch.tpu.mesh import Mesh
from madsim_tpu_torch.tpu.spec import REBASE_US

torch.set_num_threads(1)

CPU = torch.device("cpu")
HORIZON = 500_000
A = 24  # admissions of the row-equality sweeps


def _plan(m):
    """tests/test_multichip.py's plan, built from either face's module."""
    return m.FaultPlan(name="multichip-tests", clauses=(
        m.Crash(interval_lo_us=150_000, interval_hi_us=450_000,
                down_lo_us=100_000, down_hi_us=300_000),
        m.Partition(interval_lo_us=200_000, interval_hi_us=600_000,
                    heal_lo_us=150_000, heal_hi_us=450_000),
        m.MsgLoss(rate=0.05),
    ))


CFG = ttn.compile_plan(_plan(tn), SimConfig(horizon_us=HORIZON))
JCFG = jtn.compile_plan(_plan(jn), JaxConfig(horizon_us=HORIZON))

# the per-admission rows the shard-count contract covers (`retired` is
# scheduling metadata: the sweep step at retirement depends on the queue
# partition, as it does between the refill and chunked paths)
ROW_FIELDS = (
    "violated", "deadlocked", "violation_at", "violation_epoch",
    "violation_step", "steps", "events", "overflow", "dead_drops",
    "clock", "epoch", "fires", "occ_fired", "cov_bitmap", "cov_hiwater",
    "cov_transitions",
)


def cpu_mesh(n, axis="seeds"):
    return Mesh((CPU,) * n, axis)


def jax_mesh(n, axis="seeds"):
    devs = jax.devices()
    assert len(devs) >= n, "tests/conftest.py forces an 8-device CPU mesh"
    return jax.sharding.Mesh(np.array(devs[:n]), (axis,))


def _spread_h(n, spread=10, long_every=4):
    return np.where(np.arange(n) % long_every == 0, HORIZON,
                    HORIZON // spread).astype(np.int64)


def _ctl(n):
    h = _spread_h(n)
    return TriageCtl(
        off=torch.zeros((n,), dtype=torch.int32),
        occ=torch.zeros((n, 4), dtype=torch.int32),
        rate_scale=torch.ones((n, 3), dtype=torch.float32),
        h_epoch=torch.as_tensor((h // REBASE_US).astype(np.int32)),
        h_off=torch.as_tensor((h % REBASE_US).astype(np.int32)),
    )


def _jctl(n):
    h = _spread_h(n)
    return JaxCtl(
        off=jnp.zeros((n,), jnp.int32), occ=jnp.zeros((n, 4), jnp.int32),
        rate_scale=jnp.ones((n, 3), jnp.float32),
        h_epoch=jnp.asarray((h // REBASE_US).astype(np.int32)),
        h_off=jnp.asarray((h % REBASE_US).astype(np.int32)),
    )


@pytest.fixture(scope="module")
def tsim():
    assert CFG.to_toml() == JCFG.to_toml()
    return BatchedSim(make_raft_spec(), CFG, triage=True, coverage=True,
                      device="cpu")


@pytest.fixture(scope="module")
def jsim():
    return JaxSim(jax_raft_spec(), JCFG, triage=True, coverage=True)


@pytest.fixture(scope="module")
def one_shard(tsim):
    seeds = np.arange(A, dtype=np.uint32)
    return refill_results(tsim.run_refill(seeds, lanes=2, max_steps=30_000,
                                          ctl=_ctl(A)))


def _assert_rows_equal(ref, res, what):
    for f in ROW_FIELDS:
        if ref[f] is None:
            assert res[f] is None, f
            continue
        np.testing.assert_array_equal(
            np.asarray(ref[f]).astype(np.int64),
            np.asarray(res[f]).astype(np.int64), err_msg=f"{what}: {f}")


# ------------------------------------------------- engine bit-identity


@pytest.mark.parametrize("D", [2, 8])
def test_sharded_refill_rows_bit_identical_across_device_counts(
    tsim, jsim, one_shard, D,
):
    """The same admissions (triage ctl genomes with a 10x horizon spread,
    coverage on) through the one-shard refill, the D-shard refill on
    repeated CPU devices and the JAX face's D-device shard_map'd refill:
    every per-admission row equal."""
    seeds = np.arange(A, dtype=np.uint32)
    before = tsim.dispatch_count
    st = tsim.run_refill_sharded(seeds, lanes=2, mesh=cpu_mesh(D),
                                 max_steps=30_000, ctl=_ctl(A))
    assert isinstance(st, ShardedState) and len(st.shards) == D
    # one init per shard and one put, then the slowest shard's segments
    assert tsim.dispatch_count - before == D + 2
    res = refill_results_sharded(st, admissions=A)
    assert res["devices"] == D and res["truncated"] == 0
    assert res["admissions"] == A
    _assert_rows_equal(one_shard, res, f"{D} shards vs 1")
    # every shard really worked on its own sub-queue
    assert len(res["per_device"]) == D
    assert all(p["busy_lane_steps"] > 0 for p in res["per_device"])
    jst = jsim.run_refill_sharded(seeds, lanes=2, mesh=jax_mesh(D),
                                  max_steps=30_000, ctl=_jctl(A))
    jres = jax_sharded_rows(jst, admissions=A)
    _assert_rows_equal(jres, res, f"{D} shards vs the JAX face")
    np.testing.assert_array_equal(jres["retired"], res["retired"])
    for k in ("iters", "busy_lane_steps", "total_lane_steps", "devices",
              "truncated", "per_device", "lane_steps_per_iter"):
        assert res[k] == jres[k], k


def test_twins_share_the_counts_and_the_eager_switch(tsim):
    """A sim and its twin on another device (`on`) share the dispatch
    count, the refill read seconds and the eager-run switch, whichever
    side changes them; a sharded refill over the two devices counts its
    dispatches once, as the JAX face does (one init per shard, the put,
    the slowest shard's segments)."""
    sim = BatchedSim(make_raft_spec(), CFG, triage=True, coverage=True,
                     device="cpu")
    other = torch.device("cpu", 1)  # a second device key; tensors stay on CPU
    twin = sim.on(other)
    assert twin is not sim and sim.on(other) is twin and twin.on(CPU) is sim
    sim._eager_run = True
    assert twin._eager_run
    twin._eager_run = False
    assert not sim._eager_run
    seeds = np.arange(8, dtype=np.uint32)
    before, read = sim.dispatch_count, sim.refill_read_s
    st = twin.run_refill_sharded(seeds, lanes=2, mesh=Mesh((CPU, other)),
                                 max_steps=30_000, ctl=_ctl(8))
    assert sim.dispatch_count - before == 2 + 2
    assert twin.dispatch_count == sim.dispatch_count
    assert sim.refill_read_s > read and twin.refill_read_s == sim.refill_read_s
    res = refill_results_sharded(st, admissions=8)
    ref = refill_results(tsim.run_refill(seeds, lanes=2, max_steps=30_000,
                                         ctl=_ctl(8)))
    _assert_rows_equal(ref, res, "shards on two device keys")


def _batch_workload():
    return BatchWorkload(spec=make_raft_spec(), config=CFG,
                         max_steps=30_000)


@pytest.fixture(scope="module")
def unsharded_batch():
    """The unsharded chunked sweep every run_batch mesh case is held to
    (refill rows equal chunked rows per seed)."""
    return run_batch(range(12), _batch_workload(), mesh=None, max_traces=0,
                     coverage=True, chunk=12, device="cpu")


@pytest.mark.parametrize("path", ["chunked", "refill"])
def test_run_batch_refill_explicit_mesh_honored(unsharded_batch, path):
    """run_batch(mesh=<explicit mesh>) is honored on both paths: the
    summary reports the mesh's size (and per-shard occupancy on the
    refill path), and every per-seed row equals the unsharded sweep's
    (the chunked path pads each 6-seed chunk to a multiple of 8)."""
    kw = dict(refill=2, chunk=12) if path == "refill" else dict(chunk=6)
    r1 = unsharded_batch
    r8 = run_batch(range(12), _batch_workload(), mesh=cpu_mesh(8),
                   max_traces=0, coverage=True, device="cpu", **kw)
    assert r1.summary["n_devices"] == 1 and r8.summary["n_devices"] == 8
    if path == "refill":
        assert len(r8.summary["per_device_occupancy"]) == 8
    else:
        assert "per_device_occupancy" not in r8.summary
        np.testing.assert_array_equal(r1.retired_step, r8.retired_step)
    np.testing.assert_array_equal(r1.violated, r8.violated)
    np.testing.assert_array_equal(r1.violation_step, r8.violation_step)
    np.testing.assert_array_equal(r1.coverage.bitmap, r8.coverage.bitmap)
    for k in ("violations", "total_events", "coverage_bits", "fires_crash",
              "fires_partition", "fires_loss", "mean_steps"):
        assert r1.summary[k] == r8.summary[k], k


def test_sharded_refill_occupancy_and_scaling_bars():
    """The fleet's two bars on the 10x horizon-spread mix
    (`tune.spread_mix_sim`, one long admission per 8), sized down from
    the JAX smoke's 8 lanes x 32 waves x 8 devices to 2 x 16 x 4:
    occupancy >= 0.90 on every shard, and the aggregate busy lane-steps
    per sweep
    iteration >= 0.75 * D times the one-shard figure at equal per-shard
    lanes and queue depth (the JAX face's 6x at 8)."""
    lanes, waves, D = 2, 16, 4
    sim, h = tune.spread_mix_sim(0.5, device="cpu")
    one = refill_results(sim.run_refill(
        np.arange(lanes * waves), lanes=lanes, max_steps=50_000,
        ctl=tune.spread_ctl_rows(h, lanes * waves)))
    n = lanes * waves * D
    res = refill_results_sharded(sim.run_refill_sharded(
        np.arange(n), lanes=lanes, mesh=cpu_mesh(D), max_steps=50_000,
        ctl=tune.spread_ctl_rows(h, n)), admissions=n)
    for p in res["per_device"]:
        assert p["occupancy"] >= 0.90, res["per_device"]
    base = one["busy_lane_steps"] / one["iters"]
    assert res["lane_steps_per_iter"] >= 0.75 * D * base, (
        res["lane_steps_per_iter"], base)


def test_sharded_truncated_count_excludes_tail_pad(tsim):
    """9 admissions over 8 shards pad the last sub-queues with 7 repeats
    of admission 0 (a long one); when the per-shard iteration budget
    bites mid-admission, the aggregate `truncated` counts the stripped
    rows only, not the truncated pad rows the per-shard counts hold."""
    n = 9
    st = tsim.run_refill_sharded(
        np.arange(n, dtype=np.uint32), lanes=1, mesh=cpu_mesh(8),
        max_steps=30_000, ctl=_ctl(n), total_steps=20,
    )
    assert [int(s.queue.seeds.shape[0]) for s in st.shards] == [2] * 8
    res = refill_results_sharded(st, admissions=n)
    assert res["truncated"] == int((res["retired"] == -1).sum())
    assert 0 < res["truncated"] <= n
    assert res["violated"].shape == (n,)
    per_shard = sum(refill_results(s)["truncated"] for s in st.shards)
    assert per_shard > res["truncated"]


def test_sharded_state_refused_by_plain_decoder(tsim):
    """Mis-paired decoders fail loudly both ways, with the JAX face's
    words."""
    seeds = np.arange(8, dtype=np.uint32)
    st8 = tsim.run_refill_sharded(seeds, lanes=2, mesh=cpu_mesh(8),
                                  max_steps=20, ctl=_ctl(8))
    with pytest.raises(ValueError, match="refill_results_sharded"):
        refill_results(st8)
    st1 = tsim.run_refill(seeds, lanes=2, max_steps=20, ctl=_ctl(8))
    with pytest.raises(ValueError, match="leading device axis"):
        refill_results_sharded(st1)


# ------------------------------------------------------ triage / ddmin


def test_triage_chunked_shrink_refuses_mesh(tsim):
    """An explicit mesh is honored or refused loudly, never dropped: the
    chunked ddmin evaluator has no sharded form."""
    wl = BatchWorkload(spec=make_raft_spec(), config=CFG, max_steps=1_000)
    sim = BatchedSim(make_raft_spec(), CFG, triage=True, device="cpu")
    with pytest.raises(ValueError, match="refill"):
        triage.shrink_seed(wl, 0, sim=sim, refill=False, mesh=cpu_mesh(2))


def test_triage_shrink_bundle_identical_with_mesh(tmp_path):
    """ddmin generations ride the sharded path: the planted re-stamp's
    seed 29 (it violates at step 147), shrunk within a horizon just past
    its violation, writes the same bundle (kept atoms, masks, bisected
    horizon, violation step) with each generation one sharded refill
    sweep over 2 shards of 2 lanes as with the unsharded evaluator's 4
    lanes, in as many dispatches."""
    wl = chip_smoke.triage_workload()
    st = BatchedSim(wl.spec, wl.config, device="cpu").run([29], wl.max_steps)
    t_us = int(st.violation_epoch[0]) * REBASE_US + int(st.violation_at[0])
    base = {"horizon_us": t_us + 2_000}
    a, b = (
        triage.shrink_seed(wl, 29, lane_width=lw, device="cpu", mesh=mesh,
                           base_ctl=base, out_dir=str(tmp_path / str(lw)))
        for lw, mesh in ((2, cpu_mesh(2)), (4, None))
    )
    assert a.kept_atoms == b.kept_atoms and a.kept_atoms
    assert a.dispatches == b.dispatches
    assert a.bundle.to_json() == b.bundle.to_json()
    assert a.bundle.violation_step == 147


# --------------------------------------------------- island federation


def _fed(mesh):
    return explore.Federation(
        chip_smoke.explore_workload(FEDERATION_H_US), device="cpu",
        mesh=mesh, **FEDERATION_RUN)


@pytest.fixture(scope="module")
def sharded_federation():
    """The pinned 2-island federation on a 2-shard "islands" mesh, killed
    after generation 2 and resumed from its JSON snapshot in a new
    federation: (report after 2, report of the resumed run)."""
    fa = _fed(cpu_mesh(2, "islands"))
    first = fa.run(FEDERATION_GENERATIONS - 1)
    snap = json.loads(json.dumps(fa.snapshot()))
    fb = _fed(cpu_mesh(2, "islands"))
    fb.restore(snap)
    return first, fb.run(1)


def test_federation_fingerprint_pinned_across_device_counts(
    sharded_federation,
):
    """One sharded refill sweep per generation (island i = shard i) gives
    the unsharded federation's fingerprint, PINNED_FEDERATION (the JAX
    face's `mesh=None` run); a mesh whose size is not the island count
    runs the islands one after another."""
    first, rep = sharded_federation
    assert first["sharded"] and rep["sharded"]
    assert rep["fingerprint"] == PINNED_FEDERATION
    assert rep["exchanges"] and rep["exchanges"][0]["merged"] > 0
    assert not _fed(cpu_mesh(3))._sharded()
    assert not _fed(None)._sharded()


def test_federation_kill_resume_bit_identical(sharded_federation):
    """snapshot()/restore() through JSON at a generation boundary: the
    resumed sharded federation's report is the uninterrupted one's."""
    first, rep = sharded_federation
    assert first["generations"] == FEDERATION_GENERATIONS - 1
    assert rep["generations"] == FEDERATION_GENERATIONS
    assert rep["fingerprint"] == PINNED_FEDERATION


def test_cli_islands_build_an_islands_mesh_over_the_cards(monkeypatch):
    """`explore --islands N` hands the federation an "islands" mesh over
    the first N visible cards when there are at least N (the JAX CLI's
    rule over its devices), and no mesh with fewer cards, one island or
    on the CPU."""
    cards = tuple(torch.device("cuda", i) for i in range(3))
    monkeypatch.setattr(explore, "visible_devices", lambda kind: cards)
    monkeypatch.setattr(explore, "Mesh", lambda devs, axis: (devs, axis))
    seen = []

    class Stop(Exception):
        pass

    def federation(wl, **kw):
        seen.append(kw["mesh"])
        raise Stop

    monkeypatch.setattr(explore, "Federation", federation)
    for argv in (["--islands", "2"], ["--islands", "3"],
                 ["--islands", "4"], ["--islands", "1"],
                 ["--islands", "2", "--device", "cpu"]):
        with pytest.raises(Stop):
            explore.main(argv + ["--json"])
    assert seen == [(cards[:2], "islands"), (cards, "islands"), None, None,
                    None]


# ------------------------------------------------------- campaign farm


def test_serve_schedules_campaigns_across_devices_stub(tmp_path):
    """tests/test_multichip.py's stub farm on the port: three campaigns
    on a 4-device service land on three different devices, a pin is
    honored, an out-of-range pin is rejected, every slice line carries
    its device, and all three run in the first round."""
    d = str(tmp_path / "svc")
    os.makedirs(os.path.join(d, "queue"))

    class Stub:
        def __init__(self, cid):
            self.cid, self.generation, self.bugs = cid, 0, []

        def run(self, g):
            self.generation += g
            return explore.ExploreReport(
                meta_seed=0, lanes=1, dispatches=1, coverage_curve=[1],
                corpus_curve=[1], violation_curve=[0], violations=[],
                coverage_bits=1, corpus_size=1, seeds_run=1,
                first_violation_dispatch=None, wall_s=0.0,
                device_dispatches=2, corpus_digest="00" * 32,
            )

        def checkpoint(self):
            os.makedirs(os.path.join(d, "campaigns", self.cid),
                        exist_ok=True)

    reqs = {
        "a": {"workload": "raft", "generations": 2},
        "b": {"workload": "raft", "generations": 2, "devices": [1]},
        "c": {"workload": "raft", "generations": 2, "devices": [2, 3]},
        "bad": {"workload": "raft", "generations": 1, "devices": [9]},
    }
    for name, req in reqs.items():
        with open(os.path.join(d, "queue", f"{name}.json"), "w") as f:
            json.dump(req, f)
    lines = []
    res = campaign.serve(
        d, slice_generations=1, max_rounds=4, idle_rounds=1,
        out=lambda s: lines.append(json.loads(s)),
        factory=lambda request, cd, rd, log: Stub(request["id"]),
        sleep=lambda s: None, devices=["d0", "d1", "d2", "d3"], oracle=False,
    )
    assert sorted(res["completed"]) == ["a", "b", "c"]
    assert res["devices"] == 4
    rejected = [x for x in lines if x.get("rejected")]
    assert len(rejected) == 1 and "out of range" in rejected[0]["rejected"]
    devmap = {}
    for x in lines:
        if "report" in x:
            devmap.setdefault(x["campaign"], set()).add(x["device"])
    assert devmap["a"] == {0} and devmap["b"] == {1}
    assert devmap["c"] <= {2, 3}
    assert sorted([x["campaign"] for x in lines if "report" in x][:3]) == [
        "a", "b", "c"]


# ----------------------------------------------- run(mesh=) and the mesh


def test_lane_sharding_over_mesh():
    """tests/test_tpu_engine.py:122-134 on the port: a 16-lane chaos run
    (100 steps) over a 4-shard mesh is leaf-equal to the unsharded run, gathered
    onto the sim's device."""
    cfg = SimConfig(horizon_us=2_000_000, loss_rate=0.1,
                    crash_interval_lo_us=300_000,
                    crash_interval_hi_us=1_500_000)
    sim = BatchedSim(make_raft_spec(), cfg, device="cpu")
    ref = state_to_numpy(sim.run(range(16), 100))
    out = sim.run(range(16), 100, mesh=cpu_mesh(4))
    assert out.clock.device == CPU
    got = state_to_numpy(out)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(ref[k], got[k], err_msg=k)


def test_mesh_refusals():
    """A lane count the mesh does not divide raises as on the JAX face; a
    mesh naming a card this host lacks raises when built, never falling
    back; node-axis sharding is refused naming ROADMAP item 14b; an empty
    mesh and an unknown mesh string raise."""
    sim = BatchedSim(make_raft_spec(), None, device="cpu")
    with pytest.raises(ValueError, match="not divisible by mesh size 4"):
        sim.run(range(6), 10, mesh=cpu_mesh(4))
    n = torch.cuda.device_count()
    with pytest.raises((RuntimeError, ValueError), match="CUDA device"):
        Mesh((CPU, torch.device("cuda", n)))
    with pytest.raises(NotImplementedError, match="item 14b"):
        sim.shard_state(sim.init(range(4)), cpu_mesh(2), node_axis="nodes")
    with pytest.raises(ValueError, match="at least one device"):
        Mesh(())
    with pytest.raises(ValueError, match="'auto'"):
        resolve_mesh("every", "cpu")


def test_resolve_mesh_and_mesh_for_over_device_counts(monkeypatch):
    """resolve_mesh's rules (None unsharded; "auto" every visible card,
    unsharded on one card and on the CPU; a Mesh as is, even of size 1; a
    device sequence made a "seeds" mesh), and tune._mesh_for over device
    counts: 0 "auto", 1 unsharded, d an explicit mesh over the first d
    cards, a count past the host's falling back to "auto" for a cached
    entry and raising in the tuner's own search."""
    one = cpu_mesh(1)
    assert resolve_mesh(None, "cpu") is None
    assert resolve_mesh("auto", "cpu") is None
    assert resolve_mesh(one, "cpu") is one
    assert resolve_mesh([CPU, CPU], "cpu") == cpu_mesh(2)
    assert cpu_mesh(2) != cpu_mesh(2, "islands")
    assert tune._mesh_for(0) == "auto" and tune._mesh_for(1) is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert resolve_mesh("auto", "cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    auto = resolve_mesh("auto", "cuda:0")
    assert auto.size == 4 and auto.axis_name == "seeds"
    assert auto.devices == tuple(torch.device("cuda", i) for i in range(4))
    assert tune._mesh_for(2) == Mesh(auto.devices[:2])
    assert tune._mesh_for(4) == auto
    assert tune._mesh_for(8, cached=True) == "auto"
    with pytest.raises(ValueError, match="only 4 visible"):
        tune._mesh_for(8)
