"""The port's hand-written host twins against the JAX package's.

  * `madsim_tpu_torch.workloads.<x>_host.fuzz_one_seed` for kv, twopc,
    paxos, isr, lease and wal returns the JAX twin's result dict on the
    seeds and sizes of the JAX suite's own twin tests
    (tests/test_host_twins.py, test_kv_host.py, test_tpu_isr.py,
    test_tpu_lease.py), and each planted seed raises the port's
    `InvariantViolation` with the JAX message;
  * each workload factory's `host_repro` (kv's device half on the CPU)
    gives the JAX factory's output;
  * in plan mode the port's `NemesisDriver` applies the JAX driver's
    stream, which is the pure schedule's: wal's DiskFault plans
    (tests/test_host_twins.py, test_fs_durability.py and the occurrence-
    filtered one of test_triage.py) and a Reconfig plan on isr and lease;
  * `host_fuzz(name)` resolves for every registry row.

Tolerance: exact (the dicts hold integers, strings and event tuples).
"""

import dataclasses
import importlib

import pytest

import madsim_tpu.workloads as jreg
import madsim_tpu_torch.workloads as reg
from madsim_tpu import nemesis as jn
from madsim_tpu_torch import nemesis as tn

TWINS = ("kv", "twopc", "paxos", "isr", "lease", "wal")


def twin(face, name):
    pkg = "madsim_tpu" if face == "jax" else "madsim_tpu_torch"
    return importlib.import_module(f"{pkg}.workloads.{name}_host")


def norm(x):
    """A result dict with each face's event, coin and error objects as
    plain values, so the two faces' dicts compare."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__, dataclasses.asdict(x))
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(norm(v) for v in x)
    if isinstance(x, BaseException):
        return (type(x).__name__, str(x))
    if hasattr(x, "draws"):  # the driver's ScheduleCoins
        return ("coins", norm(x.draws), x.dropped)
    return x


def run(face, name, seed, **kw):
    """(result dict, None) or (None, violation message)."""
    mod = twin(face, name)
    try:
        return norm(mod.fuzz_one_seed(seed, **kw)), None
    except mod.InvariantViolation as e:
        return None, str(e)


# ------------------------------------------------------------ clean runs

CLEAN = [
    ("twopc", 3, dict(virtual_secs=6.0)),
    ("paxos", 1, dict(virtual_secs=8.0)),
    ("isr", 1, dict(virtual_secs=6.0)),
    ("isr", 1, dict(virtual_secs=10.0)),
    ("lease", 0, dict(virtual_secs=6.0)),
    ("lease", 0, dict(virtual_secs=10.0)),
    ("wal", 1, dict(virtual_secs=6.0, buggy=False, disk=True)),
    # the quiet-disk control: the planted bug is invisible without the
    # durability axis
    *[("wal", s, dict(virtual_secs=6.0, buggy=True, disk=False))
      for s in range(4)],
    *[("kv", s, dict(virtual_secs=5.0, partitions=True)) for s in (1, 2, 3)],
    ("kv", 7, dict(virtual_secs=3.0)),
]


@pytest.mark.parametrize(
    "name,seed,kw", CLEAN,
    ids=[f"{n}-s{s}-{kw['virtual_secs']:g}s" + (
        "-quiet" if kw.get("disk") is False else "") for n, s, kw in CLEAN])
def test_twin_equal_on_both_faces(name, seed, kw):
    got, err = run("port", name, seed, **kw)
    want, jerr = run("jax", name, seed, **kw)
    assert err is None and jerr is None, (err, jerr)
    assert got == want and got["events"] > 100


PLANTED = [
    ("twopc", 0, dict(virtual_secs=10.0, buggy=True), "atomicity"),
    ("paxos", 0, dict(virtual_secs=10.0, buggy=True), "agreement"),
    ("isr", 1, dict(virtual_secs=10.0, buggy=True), "ISR"),
    ("lease", 0, dict(virtual_secs=10.0, buggy=True), "zombie"),
    ("wal", 0, dict(virtual_secs=8.0, buggy=True, disk=True), "lost ack"),
]


@pytest.mark.parametrize("name,seed,kw,words", PLANTED,
                         ids=[p[0] for p in PLANTED])
def test_planted_seed_raises_the_jax_message(name, seed, kw, words):
    got, err = run("port", name, seed, **kw)
    want, jerr = run("jax", name, seed, **kw)
    assert got is None and want is None
    assert err == jerr and words in err


def test_twin_is_deterministic_within_the_process():
    a = twin("port", "kv").fuzz_one_seed(7, virtual_secs=3.0)
    assert a == twin("port", "kv").fuzz_one_seed(7, virtual_secs=3.0)


# ------------------------------------------------------------ host_repro


def factories(face):
    if face == "jax":
        from madsim_tpu.tpu import isr, kv, lease, paxos, twopc, wal
    else:
        from madsim_tpu_torch.tpu import isr, kv, lease, paxos, twopc, wal
    dev = {} if face == "jax" else {"device": "cpu"}
    return {
        "twopc": lambda: twopc.twopc_workload(virtual_secs=4.0),
        "paxos": lambda: paxos.paxos_workload(virtual_secs=4.0),
        "isr": lambda: isr.isr_workload(virtual_secs=4.0, buggy=True),
        "lease": lambda: lease.lease_workload(virtual_secs=10.0, buggy=True),
        "wal": lambda: wal.wal_workload(virtual_secs=4.0, buggy=True),
        "kv": lambda: kv.kv_workload(virtual_secs=2.0, **dev),
    }


REPRO_SEEDS = {"twopc": (5, 6), "paxos": (5, 6), "isr": (1, 5),
               "lease": (0, 1), "wal": (0, 1), "kv": (1, 2)}


@pytest.mark.parametrize("name", TWINS)
def test_factory_host_repro_equal_on_both_faces(name):
    tw, jw = factories("port")[name](), factories("jax")[name]()
    for seed in REPRO_SEEDS[name]:
        got, want = tw.host_repro(seed), jw.host_repro(seed)
        assert norm(got) == norm(want), (name, seed)
        if name == "kv":
            assert got["device"]["ops_checked"] > 0
            assert isinstance(got["host_twin"], dict)
    if name in ("isr", "wal"):
        # the buggy build's repro reports its violation
        assert tw.host_repro(REPRO_SEEDS[name][0])["violations"] == 1


def test_twin_repro_reports_the_twin_verdict():
    from madsim_tpu_torch.tpu.batch import twin_repro

    class Planted(AssertionError):
        pass

    def fuzz(seed, **kw):
        if seed:
            raise Planted(f"seed {seed} {kw}")
        return {"events": 3}

    repro = twin_repro(fuzz, Planted, n_nodes=5)
    assert repro(0) == {"events": 3, "violations": 0}
    assert repro(2) == {"violations": 1, "violation": "seed 2 {'n_nodes': 5}"}


def test_paxos_repro_of_a_swapped_buggy_spec_runs_the_correct_twin():
    """A buggy spec swapped into paxos_workload keeps the factory's twin,
    which runs the correct protocol on both faces: the repro of a seed the
    buggy device sweep violates reports 0 violations."""
    from madsim_tpu.tpu import paxos as jpaxos
    from madsim_tpu_torch.tpu import paxos as tpaxos

    got = []
    for mod in (tpaxos, jpaxos):
        wl = mod.paxos_workload(virtual_secs=8.0)
        wl = dataclasses.replace(
            wl, spec=mod.make_paxos_spec(5, buggy_ignore_discovered=True))
        got.append(norm(wl.host_repro(15)))
    assert got[0] == got[1] and got[0]["violations"] == 0


def test_kv_host_repro_takes_its_device():
    from madsim_tpu_torch.tpu.kv import kv_workload

    with pytest.raises((RuntimeError, ValueError)):
        kv_workload(virtual_secs=1.0, device="cuda:99").host_repro(0)


# ------------------------------------------------------------ plan mode


def wal_disk_plan(nem, torn_rate=0.5, name="disk-twin"):
    return nem.FaultPlan(name=name, clauses=(
        nem.DiskFault(interval_lo_us=300_000, interval_hi_us=900_000,
                      slow_lo_us=80_000, slow_hi_us=250_000,
                      down_lo_us=200_000, down_hi_us=600_000,
                      torn_rate=torn_rate, extra_us=30_000),
    ))


def disk_purity_plan(nem):
    """tests/test_triage.py's disk-purity plan (crash + disk)."""
    return nem.FaultPlan(name="disk-purity", clauses=(
        nem.Crash(interval_lo_us=400_000, interval_hi_us=1_500_000,
                  down_lo_us=300_000, down_hi_us=1_000_000),
        nem.DiskFault(interval_lo_us=400_000, interval_hi_us=1_200_000,
                      slow_lo_us=80_000, slow_hi_us=250_000,
                      down_lo_us=200_000, down_hi_us=600_000,
                      torn_rate=0.5, extra_us=30_000),
    ))


def reconfig_plan(nem):
    """tests/test_host_twins.py's reconfig-twin plan (crash + reconfig)."""
    return nem.FaultPlan(name="reconfig-twin", clauses=(
        nem.Crash(interval_lo_us=400_000, interval_hi_us=1_200_000,
                  down_lo_us=300_000, down_hi_us=900_000),
        nem.Reconfig(interval_lo_us=500_000, interval_hi_us=1_200_000,
                     down_lo_us=200_000, down_hi_us=600_000),
    ))


PLANS = {
    # id: (twin, plan builder, seed, n_nodes, horizon us, extra kwargs,
    #      occ_off, schedule kinds that must fire)
    "wal-disk": ("wal", wal_disk_plan, 5, 4, 3_000_000,
                 dict(loss_rate=0.0), None, {"disk_slow", "disk_crash"}),
    **{f"wal-torn-s{s}": (
        "wal", lambda nem: wal_disk_plan(nem, 0.9, "fs-chaos-twin"), s, 4,
        4_000_000, dict(loss_rate=0.0), None, {"disk_crash"})
       for s in range(4)},
    "wal-occ-filtered": ("wal", disk_purity_plan, 7, 4, 5_000_000,
                         dict(loss_rate=0.0), {"disk": 0b1},
                         {"disk_slow", "crash"}),
    "isr-reconfig": ("isr", reconfig_plan, 5, 5, 3_000_000,
                     dict(chaos=False), None, {"remove", "join"}),
    "lease-reconfig": ("lease", reconfig_plan, 5, 5, 3_000_000,
                       dict(chaos=False), None, {"remove", "join"}),
}


@pytest.mark.parametrize("case", sorted(PLANS))
def test_plan_mode_driver_applies_the_jax_stream(case):
    name, mk, seed, n, hor, kw, occ_off, kinds = PLANS[case]
    runs = {}
    for face, nem in (("port", tn), ("jax", jn)):
        kw2 = dict(kw, n_nodes=n, virtual_secs=hor / 1e6, plan=mk(nem),
                   occ_off=occ_off)
        runs[face] = run(face, name, seed, **kw2)
    (got, err), (want, jerr) = runs["port"], runs["jax"]
    assert err is None and jerr is None, (err, jerr)
    assert got == want
    bundle = got["nemesis"]
    plan = mk(tn)
    sched = plan.schedule(seed, hor, n)
    if occ_off is not None:
        sched = tn.filter_schedule(sched, occ_off=occ_off)
    want_applied = [norm(e) for e in sched if e.kind != "skew"]
    assert bundle["applied"] == want_applied
    assert kinds <= {e[1]["kind"] for e in bundle["applied"]}
    for clause, row in (("disk", "disk_slow"), ("reconfig", "remove")):
        mask = 0
        for e in sched:
            if e.kind == row:
                mask |= 1 << min(e.k, 31)
        if mask or clause in bundle["occ_fired"]:
            assert bundle["occ_fired"].get(clause, 0) == mask, clause


# ------------------------------------------------------------ registry


def test_host_fuzz_resolves_for_every_row():
    assert reg.names() == jreg.names() and len(reg.names()) == 11
    for name in reg.names():
        e, je = reg.get(name), jreg.get(name)
        assert e.host_module == je.host_module.replace(
            "madsim_tpu.", "madsim_tpu_torch.", 1)
        fuzz = reg.host_fuzz(name)
        assert fuzz is importlib.import_module(e.host_module).fuzz_one_seed
        assert callable(fuzz)
