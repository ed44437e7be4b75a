"""The port's host runtime (`madsim_tpu_torch.core`, `net`, `fs`) and its
host fault driver against the JAX package's.

  * the same coroutine programs (spawn, sleep, kill/restart, Endpoint
    send/recv under a NetSim clog, stdlib time and random inside the sim)
    give the same event logs and `check_determinism` results on both faces;
  * the two stdlib interposers share one process: a sim of either face,
    whichever installed first, reads only its own virtual clock and RNG, no
    patch raises outside a sim, and the port's `uninstall()` lifts only its
    own patches;
  * `raft_host.fuzz_one_seed` and `chain_host.fuzz_one_seed` return equal
    dicts on both faces (chain's blind apply under tails raises on both);
  * under the all-eight-clause plan the port's `NemesisDriver` applies the
    JAX driver's stream, skew and coin draws, which are the pure schedule's;
    the port's CPU-traced device lane, the schedule and the host driver
    agree; `causal.check_host_lineage` passes on the port's `HostLineage`;
  * `Runtime.run_batch` is `tpu.batch.run_batch`.

Tolerances: exact (logs, dicts, digests, event streams).
"""

import dataclasses
import datetime
import os
import random
import threading
import time

import pytest

import madsim_tpu as jms
import madsim_tpu_torch as tms
from madsim_tpu import nemesis as jn
from madsim_tpu.core import interpose as jinterpose
from madsim_tpu.net import Endpoint as JEndpoint
from madsim_tpu.net import NetSim as JNetSim
from madsim_tpu.workloads import chain_host as jchain
from madsim_tpu.workloads import raft_host as jraft
from madsim_tpu_torch import causal
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch.core import interpose as tinterpose
from madsim_tpu_torch.net import Endpoint as TEndpoint
from madsim_tpu_torch.net import NetSim as TNetSim
from madsim_tpu_torch.workloads import chain_host as tchain
from madsim_tpu_torch.workloads import raft_host as traft

FACES = {"jax": (jms, JEndpoint, JNetSim), "port": (tms, TEndpoint, TNetSim)}


def plan8(nem):
    """tests/test_oracle.py's PLAN8: all eight clauses, intervals tightened
    so every schedule-level clause fires inside 3 s."""
    return nem.FaultPlan(name="oracle-all8", clauses=(
        nem.Crash(interval_lo_us=400_000, interval_hi_us=1_500_000,
                  down_lo_us=200_000, down_hi_us=800_000),
        nem.Partition(interval_lo_us=500_000, interval_hi_us=1_800_000,
                      heal_lo_us=300_000, heal_hi_us=1_000_000),
        nem.LinkClog(interval_lo_us=600_000, interval_hi_us=2_000_000,
                     heal_lo_us=300_000, heal_hi_us=1_000_000),
        nem.LatencySpike(interval_lo_us=500_000, interval_hi_us=2_000_000,
                         duration_lo_us=200_000, duration_hi_us=800_000,
                         extra_us=80_000),
        nem.MsgLoss(rate=0.05),
        nem.Duplicate(rate=0.05),
        nem.Reorder(rate=0.15, window_us=40_000),
        nem.ClockSkew(max_ppm=30_000),
    ))


HOR8, N, SEED = 3_000_000, 5, 7


# ------------------------------------------------------- the same programs


def echo_program(face, log):
    """Two nodes over Endpoint: a client pings a server through a clog
    window and across a server kill + restart; every step logs virtual
    time, and the sim also reads the stdlib clock and RNG."""
    ms, Endpoint, NetSim = FACES[face]

    async def server():
        ep = await Endpoint.bind("10.0.0.1:700")
        while True:
            data, src = await ep.recv_from(1)
            log.append(("srv", ms.time.current().now_ns(), data))
            await ep.send_to(src, 2, data + b"!")

    async def main():
        h = ms.Handle.current()
        srv = (h.create_node().name("srv").ip("10.0.0.1").init(server)
               .restart_on_panic().build())
        cli = h.create_node().name("cli").ip("10.0.0.2").build()
        net = ms.plugin.simulator(NetSim)
        done = []

        async def client():
            ep = await Endpoint.bind("10.0.0.2:0")
            for i in range(8):
                await ep.send_to("10.0.0.1:700", 1, b"p%d" % i)
                try:
                    data, _ = await ms.time.timeout(
                        0.2, ep.recv_from(2))
                    log.append(("cli", ms.time.current().now_ns(), data))
                except Exception as e:  # noqa: BLE001 - logged by name
                    log.append(("cli", ms.time.current().now_ns(),
                                type(e).__name__))
                if i == 1:
                    net.clog_link(cli.id, srv.id)
                if i == 3:
                    net.unclog_link(cli.id, srv.id)
                    h.kill(srv.id)
                if i == 4:
                    h.restart(srv.id)
                await ms.time.sleep(0.05 + ms.rand() * 0.1)
            done.append(True)

        cli.spawn(client())

        async def nap():
            await ms.time.sleep(0.3)
            return ms.rand()

        log.append(("nap", await ms.spawn(nap())))
        log.append(("stdlib", time.time(), time.monotonic_ns(),
                    random.random(), os.urandom(4).hex(),
                    datetime.datetime.now().isoformat()))
        while not done:
            await ms.time.sleep(0.1)
        log.append(("end", ms.time.current().now_ns(), ms.randrange(1000),
                    net.stat().msg_count))
        return len(log)

    return main


@pytest.mark.parametrize("seed", [1, 5, 9])
def test_same_program_same_event_log_on_both_faces(seed):
    logs = {}
    for face in FACES:
        ms = FACES[face][0]
        log = []
        n = ms.Runtime(seed=seed).block_on(echo_program(face, log)())
        assert n == len(log) > 10
        logs[face] = log
    assert logs["port"] == logs["jax"]
    kinds = {e[2] for e in logs["port"] if e[0] == "cli"}
    assert "TimeoutError_" in kinds  # the clog window and the kill bit
    assert any(e[0] == "srv" for e in logs["port"])


def test_check_determinism_equal_on_both_faces():
    got = {}
    for face in FACES:
        ms = FACES[face][0]
        log = []
        got[face] = (ms.check_determinism(
            3, lambda: echo_program(face, log)()), len(log))
    assert got["port"] == got["jax"]

    # a program that reads real entropy once per run diverges on both
    def leaky(ms):
        first = []

        async def main():
            if not first:
                first.append(1)
                await ms.time.sleep(0.01)
            return ms.rand()

        return main

    errors = []
    for ms in (jms, tms):
        with pytest.raises(ms.DeterminismError) as e:
            ms.check_determinism(3, leaky(ms))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ------------------------------------------------------- two interposers


def _clock_and_rng(ms):
    async def main():
        await ms.time.sleep(1.5)
        return (time.time(), time.monotonic(), random.random(),
                os.urandom(8), datetime.datetime.now().timestamp())

    return main


@pytest.mark.parametrize("first", ["jax", "port"])
def test_each_face_reads_its_own_clock_and_rng(first):
    """Whichever interposer installs first, a sim of either face reads its
    own virtual clock and RNG, equal to a sim of the other face at the same
    seed (the two runtimes draw the same streams), and real time outside."""
    order = ["jax", "port"] if first == "jax" else ["port", "jax"]
    for face in order:
        FACES[face][0].Runtime(seed=0)  # installs that face's interposer
    tms.Runtime(seed=0)  # and the port reasserts its patches on top
    got = {face: FACES[face][0].Runtime(seed=11).block_on(
        _clock_and_rng(FACES[face][0])()) for face in order}
    assert got["jax"] == got["port"]
    t, mono, _r, _u, dt = got["port"]
    assert 1.5 <= mono < 1.6
    assert 50 * 365 * 86400 < t < 54 * 365 * 86400  # the 2022-ish base
    assert abs(dt - t) < 1e-3
    # a different seed differs on both faces alike
    other = {face: FACES[face][0].Runtime(seed=12).block_on(
        _clock_and_rng(FACES[face][0])()) for face in order}
    assert other["jax"] == other["port"] != got["port"]
    # outside any sim: the real clock
    assert abs(time.time() - datetime.datetime.now().timestamp()) < 5
    assert time.time() > 1.6e9


def test_no_patch_raises_outside_a_sim_and_uninstall_is_per_face():
    jms.Runtime(seed=0)
    tms.Runtime(seed=0)
    # outside a sim every patched entry point passes through
    time.sleep(0)
    assert len(os.urandom(5)) == 5
    assert 0 <= random.random() < 1
    random.seed(3)
    a = random.random()
    random.seed(3)
    assert random.random() == a
    assert isinstance(random.Random().random(), float)
    assert isinstance(datetime.datetime.now(), datetime.datetime)
    assert isinstance(datetime.date.today(), datetime.date)
    th = threading.Thread(target=lambda: None)
    th.start()
    th.join()

    async def nothing():
        return 4

    import asyncio

    assert asyncio.run(nothing()) == 4
    # inside a port sim the forbidden primitives raise the port's error
    async def starts_thread():
        threading.Thread(target=lambda: None).start()

    with pytest.raises(tinterpose.SimForbiddenError):
        tms.Runtime(seed=0).block_on(starts_thread())
    with pytest.raises(jinterpose.SimForbiddenError):
        jms.Runtime(seed=0).block_on(starts_thread())

    # the port's uninstall lifts only its own patches: the JAX face's sims
    # stay virtual, a port sim runs on the real clock until the port
    # installs again (at its next Runtime construction)
    tinterpose.uninstall()
    try:
        jt = jms.Runtime(seed=11).block_on(_clock_and_rng(jms)())
        assert 1.5 <= jt[1] < 1.6
        time.sleep(0)
        assert len(os.urandom(3)) == 3
        assert time.time() > 1.6e9
    finally:
        # the next port Runtime installs the port's patches again
        pt = tms.Runtime(seed=11).block_on(_clock_and_rng(tms)())
    assert pt == jt


# ------------------------------------------------------- the host twins


def _strip(d):
    return {k: v for k, v in d.items() if k != "nemesis"}


@pytest.mark.parametrize("seed", [0, 3])
def test_raft_host_twin_equal_on_both_faces(seed):
    kw = dict(virtual_secs=4.0, partitions=True)
    got, want = traft.fuzz_one_seed(seed, **kw), jraft.fuzz_one_seed(seed, **kw)
    assert got == want and got["events"] > 100


@pytest.mark.parametrize("seed", [3, 5])
def test_chain_host_twin_equal_on_both_faces(seed):
    got = tchain.fuzz_one_seed(seed, virtual_secs=6.0)
    want = jchain.fuzz_one_seed(seed, virtual_secs=6.0)
    assert got == want and got["acked_ops"] > 20


def test_chain_blind_apply_under_tails_raises_on_both_faces():
    msgs = []
    for mod in (jchain, tchain):
        with pytest.raises(mod.InvariantViolation) as e:
            mod.fuzz_one_seed(3, virtual_secs=10.0, tails=True, buggy=True)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    # the correct protocol is clean under the same tails and seed
    assert tchain.fuzz_one_seed(3, virtual_secs=10.0, tails=True) == \
        jchain.fuzz_one_seed(3, virtual_secs=10.0, tails=True)


def test_to_net_config_fields_equal():
    base_t, base_j = tms.NetConfig(), jms.NetConfig()
    base_t.packet_loss_rate = base_j.packet_loss_rate = 0.1
    for base in (None, "loss"):
        got = plan8(tn).to_net_config(base_t if base else None)
        want = plan8(jn).to_net_config(base_j if base else None)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.packet_reorder_window == 0.04


# ------------------------------------------------------- the fault driver


def _run_driver(ms, nem, plan, seed, hor_us):
    """A raft twin under the plan through the face's NemesisDriver."""
    raft = traft if ms is tms else jraft
    run = raft.fuzz_one_seed(seed, n_nodes=N, virtual_secs=hor_us / 1e6,
                             chaos=False, plan=plan, lineage=True)
    return run["nemesis"]


def test_driver_stream_skew_and_coins_equal_the_jax_driver_and_schedule():
    art = _run_driver(tms, tn, plan8(tn), SEED, HOR8)
    jart = _run_driver(jms, jn, plan8(jn), SEED, HOR8)
    sched = plan8(tn).schedule(SEED, HOR8, N)
    assert {"crash", "split", "clog", "spike_on", "skew"} <= {
        e.kind for e in sched}
    want = [dataclasses.asdict(e) for e in sched if e.kind != "skew"]
    assert [dataclasses.asdict(e) for e in art["applied"]] == want
    assert [dataclasses.asdict(e) for e in jart["applied"]] == want
    assert art["node_skew"] == jart["node_skew"] == {
        art["node_ids"][i]: p
        for i, p in enumerate(plan8(tn).skew_ppm(SEED, N)) if p}
    assert art["coins"].draws == jart["coins"].draws
    assert len(art["coins"].draws) > 100 and art["coins"].dropped == 0
    key = tn.key_from_seed(SEED)
    span = round(0.04 * 1e9)
    rate = {tn.NET_SITE_NEM_LOSS: 0.05, tn.NET_SITE_DUP: 0.05,
            tn.NET_SITE_REORDER: 0.15}
    for site, index, value, _t, _eid in art["coins"].draws:
        if site == tn.NET_SITE_REORDER_EXTRA:
            assert value == tn.randint32(key, site, 0, span, index=index)
        else:
            assert value == int(tn.coin32(key, site, rate[site], index=index))
    assert art["occ_fired"] == jart["occ_fired"]
    assert art["fires"] == jart["fires"] and art["state"] == jart["state"]
    # the host lineage obeys the Lamport law on the port's checker
    assert causal.check_host_lineage(art["lineage"]) == len(
        art["lineage"].edges) > 0


def test_three_faces_agree_device_schedule_host_driver():
    """tests/test_host_twins.py's twin contract on the port alone: the CPU
    traced device lane's chaos events = the pure schedule = the host
    driver's applied stream, and the per-node skew agrees."""
    from madsim_tpu_torch.tpu import SimConfig, make_raft_spec
    from madsim_tpu_torch.tpu import nemesis as ttn
    from madsim_tpu_torch.tpu.batch import BatchedSim

    plan = tn.FaultPlan(name="raft-twin", clauses=(
        tn.Crash(interval_lo_us=400_000, interval_hi_us=1_200_000,
                 down_lo_us=300_000, down_hi_us=900_000),
        tn.Partition(interval_lo_us=500_000, interval_hi_us=1_500_000,
                     heal_lo_us=400_000, heal_hi_us=1_200_000),
        tn.ClockSkew(max_ppm=20_000),
    ))
    seed = 5
    sim = BatchedSim(make_raft_spec(N),
                     ttn.compile_plan(plan, SimConfig(horizon_us=HOR8)),
                     device="cpu")
    n_dev = ttn.assert_device_matches_schedule(sim, plan, seed, HOR8)
    art = _run_driver(tms, tn, plan, seed, HOR8)
    sched = plan.schedule(seed, HOR8, N)
    assert list(art["applied"]) == [e for e in sched if e.kind != "skew"]
    assert ttn.schedule_tuples(art["applied"], HOR8) == \
        ttn.schedule_tuples([e for e in sched if e.kind != "skew"], HOR8)
    assert n_dev >= 4
    st = sim.init([seed])
    dev_ppm = st.nem.skew_ppm[0].tolist()
    assert dev_ppm == plan.skew_ppm(seed, N)
    assert sorted(art["node_skew"].values()) == sorted(
        p for p in dev_ppm if p)


def test_runtime_run_batch_is_the_batched_entry_point():
    from madsim_tpu_torch.tpu import run_batch
    from madsim_tpu_torch.tpu.raft import raft_workload

    wl = dataclasses.replace(raft_workload(virtual_secs=0.3), max_steps=300)
    a = tms.Runtime.run_batch(range(4), wl, device="cpu")
    b = run_batch(range(4), wl, device="cpu")
    for row in ("violated", "deadlocked", "violation_step", "retired_step"):
        assert getattr(a, row).tolist() == getattr(b, row).tolist(), row
    assert a.summary["violations"] == b.summary["violations"]
    with pytest.raises(NotImplementedError, match="16b"):
        tms.spawn(_clock_and_rng(tms)())


def test_port_interposer_first_then_the_jax_face_in_a_fresh_process():
    """In a fresh process the port installs before the JAX face's
    interposer is even imported: the JAX face's dispatching datetime
    classes then subclass the port's without a metaclass conflict, and
    both faces' sims read their own clocks."""
    import subprocess
    import sys

    code = (
        "import datetime, time, madsim_tpu_torch as t\n"
        "t.Runtime(seed=0)\n"
        "import madsim_tpu as j\n"
        "async def m(ms):\n"
        "    await ms.time.sleep(2)\n"
        "    return (datetime.datetime.now().timestamp(), time.monotonic(),\n"
        "            isinstance(datetime.datetime(2020, 1, 1),\n"
        "                       datetime.date))\n"
        "a = j.Runtime(seed=3).block_on(m(j))\n"
        "b = t.Runtime(seed=3).block_on(m(t))\n"
        "assert a == b and 2 <= a[1] < 2.1 and a[2], (a, b)\n"
        "assert time.time() > 1.6e9\n"
        "assert isinstance(datetime.datetime.now(), datetime.datetime)\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-W", "ignore", "-c", code],
                         cwd=root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
