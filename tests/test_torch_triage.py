"""Triage on the port against the JAX package: the per-lane TriageCtl, the
pure schedule, the ddmin shrinker, repro bundles and their replay.

The same inputs, made from seeds, go through both faces on the CPU:
  * the copied constants and the murmur3 mirror equal their originals;
  * `FaultPlan.schedule` / `filter_schedule` equal for a plan with every
    clause kind;
  * a triage sim under the default ctl is leaf-equal to the plain sim on
    both faces, and under a ctl that suppresses crash, reconfig and disk
    occurrences, turns clauses off, scales the dup and loss rates and cuts
    horizons it is leaf-equal to the JAX engine under the same ctl;
  * the planted re-stamp shrink (tests/test_triage.py's bug and plan,
    lane_width 4) writes a bundle equal to the JAX face's, whose digest is
    `digest.PINNED_BUNDLE`, and bundles replay across faces at the
    recorded step and time;
  * each argument that needs an unported plane raises NotImplementedError.

Tolerances: exact everywhere (integer leaves widened to int64, the ctl's
float32 rate scales compared as float64, bundle JSON byte for byte).
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from madsim_tpu import nemesis as jn
from madsim_tpu import repro as jrepro
from madsim_tpu import triage as jtri
from madsim_tpu.tpu import BatchedSim as JaxSim
from madsim_tpu.tpu import SimConfig as JaxConfig
from madsim_tpu.tpu import make_raft_spec as jax_raft_spec
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu.tpu.engine import _occ_on as jax_occ_on
from madsim_tpu.tpu.engine import default_ctl as jax_default_ctl
from madsim_tpu.tpu.engine import named_leaves
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch import repro, triage
from madsim_tpu_torch.tpu import BatchedSim, SimConfig, make_raft_spec, run_batch
from madsim_tpu_torch.tpu import nemesis as ttn
from madsim_tpu_torch.tpu import prng
from madsim_tpu_torch.tpu.batch import BatchViolation
from madsim_tpu_torch.tpu.convert import state_to_numpy
from madsim_tpu_torch.tpu.digest import PINNED_BUNDLE, bundle_digest
from madsim_tpu_torch.tpu.engine import TriageCtl, _occ_on
from test_torch_engine import assert_leaves_equal
from test_triage import _sched_workload, planted_restamp_spec as jax_planted

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_REF = "chip_smoke:planted_restamp_spec"


def jax_leaves(state):
    """JAX-face leaves as numpy: integers widened to int64, floats to
    float64 (the port's state_to_numpy convention)."""
    out = {}
    for k, v in named_leaves(state):
        a = np.asarray(v)
        out[k] = a.astype(np.float64 if a.dtype.kind == "f" else np.int64)
    return out


def every_clause(m):
    """A plan with every clause kind, windows short enough that each fires
    within a few hundred steps."""
    return m.FaultPlan(name="every-clause", clauses=(
        m.Crash(interval_lo_us=200_000, interval_hi_us=600_000,
                down_lo_us=100_000, down_hi_us=300_000, wipe_rate=0.5),
        m.Partition(interval_lo_us=200_000, interval_hi_us=600_000,
                    heal_lo_us=100_000, heal_hi_us=400_000),
        m.LinkClog(interval_lo_us=150_000, interval_hi_us=500_000,
                   heal_lo_us=100_000, heal_hi_us=300_000),
        m.LatencySpike(interval_lo_us=150_000, interval_hi_us=500_000,
                       duration_lo_us=50_000, duration_hi_us=200_000,
                       extra_us=20_000),
        m.MsgLoss(rate=0.05),
        m.Duplicate(rate=0.1),
        m.Reorder(rate=0.1, window_us=20_000),
        m.ClockSkew(max_ppm=20_000),
        m.Reconfig(interval_lo_us=200_000, interval_hi_us=600_000,
                   down_lo_us=100_000, down_hi_us=300_000),
        m.DiskFault(interval_lo_us=200_000, interval_hi_us=600_000,
                    slow_lo_us=50_000, slow_hi_us=150_000,
                    down_lo_us=100_000, down_hi_us=300_000,
                    torn_rate=0.5),
    ))


def every_clause_faces(horizon_us=3_000_000):
    cfg = ttn.compile_plan(every_clause(tn), SimConfig(horizon_us=horizon_us))
    jcfg = jtn.compile_plan(every_clause(jn), JaxConfig(horizon_us=horizon_us))
    assert cfg.to_toml() == jcfg.to_toml()
    return cfg, jcfg


# ------------------------------------------------------- copied constants

@pytest.mark.parametrize("name", [
    "TRIAGE_CLAUSES", "TRIAGE_BIT", "RATE_CLAUSES", "RATE_ROW",
    "CLAUSE_OF_EVENT", "OCC_CLAUSES", "OCC_ROW", "COIN_DENOM",
])
def test_triage_vocabulary_equals_the_original(name):
    assert getattr(tn, name) == getattr(jn, name)


@pytest.mark.parametrize("name", ["BUNDLE_FORMAT", "BUNDLE_FORMATS_READ"])
def test_bundle_format_equals_the_original(name):
    assert getattr(triage, name) == getattr(jtri, name)


def test_hash_mirror_equals_the_original_and_the_engine_chain():
    rng = np.random.default_rng(4)
    xs = [int(x) for x in rng.integers(0, 2**32, size=300, dtype=np.uint64)]
    for x in xs[:100]:
        assert tn.mix32(x) == jn.mix32(x)
        assert tn.key_from_seed(x) == jn.key_from_seed(x)
        assert tn.fold32(x, 7) == jn.fold32(x, 7)
    for key, site, idx in zip(xs[:100], xs[100:200], xs[200:]):
        site %= 300
        assert tn.bits32(key, site, idx) == jn.bits32(key, site, idx)
        assert (tn.randint32(key, site, -5, 1000, idx)
                == jn.randint32(key, site, -5, 1000, idx))
        assert (tn.coin32(key, site, 0.37, idx)
                == jn.coin32(key, site, 0.37, idx))
    # the mirror is the engine's tensor chain in plain integers
    keys = torch.as_tensor(np.asarray(xs[:100], np.int64))
    got = prng.bits(keys, 213, index=77).tolist()
    assert got == [tn.bits32(k, 213, 77) for k in xs[:100]]


# ------------------------------------------------------- the pure schedule

@pytest.mark.parametrize("seed", [0, 7, 123456789])
def test_schedule_and_filter_equal_the_original(seed):
    plan, jplan = every_clause(tn), every_clause(jn)
    evs = plan.schedule(seed, 3_000_000, 5)
    jevs = jplan.schedule(seed, 3_000_000, 5)
    assert [dataclasses.asdict(e) for e in evs] == [
        dataclasses.asdict(e) for e in jevs]
    assert [str(e) for e in evs] == [str(e) for e in jevs]
    kinds = {e.kind for e in evs}
    assert {"crash", "split", "clog", "spike_on", "skew", "remove",
            "disk_slow", "disk_crash"} <= kinds
    assert plan.skew_ppm(seed, 5) == jplan.skew_ppm(seed, 5)
    occ_off = {"crash": 0b101, "reconfig": 0b10, "disk": 0b1}
    drop = ("clog", "spike")
    got = tn.filter_schedule(evs, occ_off, drop)
    want = jn.filter_schedule(jevs, occ_off, drop)
    assert [dataclasses.asdict(e) for e in got] == [
        dataclasses.asdict(e) for e in want]
    assert len(got) < len(evs)
    assert ttn.schedule_tuples(got, 3_000_000) == jtn.schedule_tuples(
        want, 3_000_000)


def test_plan_faces_equal_the_original():
    cfg, jcfg = every_clause_faces()
    plan, jplan = triage.plan_from_config(cfg), jtri.plan_from_config(jcfg)
    assert triage.plan_to_json(plan) == jtri.plan_to_json(jplan)
    again = triage.plan_from_json(triage.plan_to_json(plan))
    assert set(again.clauses) == set(every_clause(tn).clauses)
    shrunk = triage.shrink_plan(plan, ["clog", "wipe"], {"dup": 0.5})
    jshrunk = jtri.shrink_plan(jplan, ["clog", "wipe"], {"dup": 0.5})
    assert triage.plan_to_json(shrunk) == jtri.plan_to_json(jshrunk)
    for seed, h in ((3, 3_000_000), (3, 700_000), (11, 3_000_000)):
        assert (triage.enumerate_atoms(plan, cfg, seed, h, 5)
                == jtri.enumerate_atoms(jplan, jcfg, seed, h, 5))


def test_ddmin_is_one_minimal():
    """Synthetic oracle (tests/test_triage.py): violates iff {3, 7} are
    kept; both faces find exactly that pair in the same generations."""
    atoms = [("a", k) for k in range(10)]
    need = {("a", 3), ("a", 7)}
    calls = {"port": [], "jax": []}

    def batch(face):
        def run(cands):
            calls[face].append([list(c) for c in cands])
            return [need <= set(c) for c in cands]
        return run

    kept = triage.ddmin(atoms, batch("port"))
    assert set(kept) == need
    assert kept == jtri.ddmin(atoms, batch("jax"))
    assert calls["port"] == calls["jax"] and len(calls["port"]) >= 2
    assert triage.ddmin([], lambda c: [True] * len(c)) == []
    assert triage.ddmin([("a", None)], lambda c: [True] * len(c)) == []


# ------------------------------------------------------- the ctl in the step

def test_occ_on_equals_the_original_at_every_bit():
    """`_occ_on` reads the int32 mask as u32: bit 31 works and k >= 32 is
    always on, on both faces."""
    rng = np.random.default_rng(2)
    L = 256
    occ = rng.integers(-2**31, 2**31, size=(L, len(tn.OCC_CLAUSES)),
                       dtype=np.int64).astype(np.int32)
    occ[0, :] = -1  # every bit, including 31
    off = rng.integers(0, 2**len(tn.TRIAGE_CLAUSES), size=L).astype(np.int32)
    k = rng.integers(-3, 40, size=L).astype(np.int32)
    k[:4] = (31, 32, 0, 30)
    ctl = TriageCtl(off=torch.as_tensor(off), occ=torch.as_tensor(occ),
                    rate_scale=None, h_epoch=None, h_off=None)
    jctl = jax_default_ctl(L, 1)._replace(off=jnp.asarray(off),
                                          occ=jnp.asarray(occ))
    for name in tn.OCC_CLAUSES:
        got = _occ_on(ctl, name, torch.as_tensor(k)).numpy()
        want = np.asarray(jax_occ_on(jctl, name, jnp.asarray(k)))
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_default_ctl_is_the_plain_engine_on_both_faces():
    """A triage sim under the default ctl: leaf-equal (ctl aside) to the
    plain sim on each face, and the two faces leaf-equal, under a plan
    with every clause kind (300 steps, 8 lanes)."""
    cfg, jcfg = every_clause_faces()
    spec, jspec = make_raft_spec(5), jax_raft_spec(5)
    seeds = list(range(8))
    tri = state_to_numpy(BatchedSim(spec, cfg, triage=True, device="cpu")
                         .run(seeds, max_steps=300))
    plain = state_to_numpy(BatchedSim(spec, cfg, device="cpu")
                           .run(seeds, max_steps=300))
    jtri_st = jax_leaves(JaxSim(jspec, jcfg, triage=True).run(
        jnp.arange(8, dtype=jnp.uint32), max_steps=300))
    jplain = jax_leaves(JaxSim(jspec, jcfg).run(
        jnp.arange(8, dtype=jnp.uint32), max_steps=300))
    assert_leaves_equal(jtri_st, tri, "triage, default ctl")
    ctl_keys = [k for k in tri if k.startswith("ctl.")]
    assert len(ctl_keys) == 5
    for k in ctl_keys:
        del tri[k], jtri_st[k]
    assert_leaves_equal(plain, tri, "port: default ctl vs plain")
    assert_leaves_equal(jplain, jtri_st, "jax: default ctl vs plain")
    assert plain["fires"].sum() > 0 and plain["occ_fired"].any()


def suppressing_rows(horizon_us):
    """Per-lane ctl rows (off clauses, occ_off, rate scales, horizon): crash,
    reconfig and disk occurrences suppressed, wipe/clog/skew/reorder off,
    dup and loss scaled, horizons cut; lane 0 stays the full plan."""
    return [
        ((), {}, {}, horizon_us),
        ((), {"crash": 0b1, "reconfig": 0b10, "disk": 0b1}, {}, horizon_us),
        (("wipe", "clog"), {"crash": 0b110}, {"dup": 0.5, "loss": 0.25},
         horizon_us),
        (("skew", "reorder"), {"disk": 0b11, "partition": 0b1},
         {"dup": 0.25}, horizon_us // 2),
        (("spike",), {"reconfig": 0b1, "crash": 0b1000}, {"loss": 0.5},
         horizon_us),
        (("dup", "loss"), {"disk": 0b100}, {}, 1_234_567),
        ((), {"partition": 0b110, "clog": 0b1}, {"reorder": 0.5}, horizon_us),
        (("crash", "partition", "reconfig", "disk"), {}, {}, horizon_us),
    ]


def _rows_ctl(mod, rows):
    """One ctl with a lane per row, built through the face's build_ctl."""
    per = [mod.build_ctl(1, h, off, occ, rs) for off, occ, rs, h in rows]
    if mod is triage:
        return TriageCtl(*(torch.cat(xs) for xs in zip(*per)))
    return type(per[0])(*(jnp.concatenate(xs) for xs in zip(*per)))


def test_suppressing_ctl_equals_the_jax_engine():
    """Suppressed occurrences keep their timing and drop only their effect:
    per-lane ctls switching occurrences, clauses, rates and horizons give
    the JAX engine's states leaf for leaf, and differ from the full plan."""
    cfg, jcfg = every_clause_faces()
    rows = suppressing_rows(cfg.horizon_us)
    seeds = [5] * len(rows)  # one seed: the lanes differ only by ctl
    pst = state_to_numpy(BatchedSim(make_raft_spec(5), cfg, triage=True,
                                    device="cpu")
                         .run(seeds, max_steps=300, ctl=_rows_ctl(triage, rows)))
    jst = jax_leaves(JaxSim(jax_raft_spec(5), jcfg, triage=True).run(
        jnp.asarray(seeds, jnp.uint32), max_steps=300,
        ctl=_rows_ctl(jtri, rows)))
    assert_leaves_equal(jst, pst, "suppressing ctl")
    fires = pst["fires"]
    assert (fires[1:] != fires[0]).any(axis=1).all()
    assert fires[7, :5].sum() == 0 and fires[0, :5].sum() > 0
    np.testing.assert_array_equal(pst["ctl.rate_scale"][2], [0.25, 0.5, 1.0])


def test_ctl_requires_triage_mode():
    sim = BatchedSim(make_raft_spec(5), SimConfig(horizon_us=500_000),
                     device="cpu")
    with pytest.raises(ValueError, match="triage=True"):
        sim.init([0, 1], triage.build_ctl(2, 500_000))


# ------------------------------------------------------- bundles

def _bundle(**kw):
    cfg = SimConfig(horizon_us=2_000_000)
    fields = dict(
        seed=42, spec_ref="pkg.mod:factory", spec_kwargs={"n": 5},
        spec_name="raft5", n_nodes=5, config_toml=cfg.to_toml(),
        config_hash=cfg.hash(), violation_kind="invariant",
        violation_step=17, violation_t_us=123_456,
        dropped_clauses=["crash"], occ_off={"partition": 5},
        rate_scale={"loss": 0.25}, horizon_us=130_000, max_steps=10_000,
        plan=triage.plan_to_json(every_clause(tn)), trace_tail=["a", "b"],
    )
    fields.update(kw)
    return fields


def test_bundle_json_roundtrip_equals_the_original(tmp_path):
    b, jb = triage.ReproBundle(**_bundle()), jtri.ReproBundle(**_bundle())
    assert b.to_json() == jb.to_json()
    path = tmp_path / "b.json"
    jb.save(str(path))
    again = triage.ReproBundle.load(str(path))
    assert again == b and again.config() == SimConfig(horizon_us=2_000_000)
    with pytest.raises(ValueError, match="format"):
        triage.ReproBundle.from_json(json.dumps({"format": "bogus/9"}))
    doc = json.loads(b.to_json())
    doc["config_toml"] = doc["config_toml"].replace(
        "loss_rate = 0.0", "loss_rate = 0.5")
    with pytest.raises(ValueError, match="hash mismatch"):
        triage.ReproBundle(**doc).config()
    # a v1 bundle (no provenance fields) reads back with them defaulted
    for key in ("signature", "campaign", "generation", "causal"):
        del doc[key]
    doc["format"] = "madsim-tpu-repro/1"
    v1 = triage.ReproBundle.from_json(json.dumps(doc))
    assert v1.signature is None and v1.format == "madsim-tpu-repro/1"
    ctl, jctl = b.ctl(3), jb.ctl(3)
    for f in TriageCtl._fields:
        np.testing.assert_array_equal(getattr(ctl, f).numpy(),
                                      np.asarray(getattr(jctl, f)), err_msg=f)


# ------------------------------------------------------- the planted shrink

@pytest.fixture(scope="module")
def shrunk(tmp_path_factory):
    """One shrink per face of the planted re-stamp seed 0 (lane_width 4):
    the port's through run_batch's trace and shrink legs (seeds 0 and 1,
    both violate), the JAX face's through shrink_seed."""
    out = str(tmp_path_factory.mktemp("bundles"))
    wl = chip_smoke.triage_workload()
    jwl = _sched_workload()
    assert wl.config.to_toml() == jwl.config.to_toml()
    result = run_batch(
        range(2), wl, device="cpu", max_traces=1, shrink_on_violation=True,
        shrink_kwargs=dict(lane_width=4, out_dir=out, spec_ref=SPEC_REF),
    )
    jsr = jtri.shrink_seed(jwl, 0, lane_width=4, refill=False,
                           spec_ref=SPEC_REF)
    return dict(wl=wl, jwl=jwl, result=result, jsr=jsr, out=out)


def test_planted_shrink_bundle_equals_the_jax_face(shrunk):
    result, jsr = shrunk["result"], shrunk["jsr"]
    assert result.violating_seeds == [0, 1]
    bundle = result.bundle
    assert bundle.to_json() == jsr.bundle.to_json()
    assert PINNED_BUNDLE == (0, bundle_digest(jsr.bundle))
    assert bundle_digest(bundle) == PINNED_BUNDLE[1]
    # genuinely shrunk, horizon bisected just past the violation
    assert bundle.dropped_clauses and bundle.occ_off
    assert (bundle.violation_t_us < bundle.horizon_us
            <= bundle.violation_t_us + 2_000)
    assert bundle.trace_tail and "VIOLATION" in bundle.trace_tail[-1]
    assert triage.ReproBundle.load(result.bundle_path) == bundle
    assert os.path.dirname(result.bundle_path) == shrunk["out"]


def test_run_batch_trace_leg_equals_the_jax_trace(shrunk):
    """The sweep's traced seed: the same events as the JAX face's traced
    run (the event list ends at the violation, so a JAX scan just past the
    violating step has them all), ending in VIOLATION at the lane's
    violation step."""
    from madsim_tpu.tpu.trace import trace_seed as jax_trace_seed

    result, jwl = shrunk["result"], shrunk["jwl"]
    events = result.traces[0]
    step = int(result.violation_step[0])
    jevents = jax_trace_seed(JaxSim(jwl.spec, jwl.config), 0,
                             max_steps=step + 40,
                             kind_names=jwl.spec.msg_kind_names)
    assert [str(e) for e in events] == [str(e) for e in jevents]
    assert [dataclasses.asdict(e) for e in events] == [
        dataclasses.asdict(e) for e in jevents]
    assert events[-1].kind == "violation" and events[-1].step == step


def test_bundles_replay_across_faces(shrunk, tmp_path, capsys):
    """The JAX-written bundle file replays on the port through the repro
    CLI (its spec_ref resolves the port's spec from the repo root; two
    runs, bit-identical), and the port-written file on the JAX face, each
    at the recorded step and time."""
    jpath = shrunk["jsr"].bundle.save(str(tmp_path / "jax_bundle.json"))
    jbundle = triage.ReproBundle.load(jpath)
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        assert repro.main([jpath, "--device", "cpu", "--repeats", "2"]) == 0
    finally:
        os.chdir(cwd)
    assert (f"violates at step {jbundle.violation_step}, "
            f"t={jbundle.violation_t_us}us, bit-identical across 2 runs"
            ) in capsys.readouterr().out
    bundle = jtri.ReproBundle.load(shrunk["result"].bundle_path)
    jrep = jrepro.replay_device(bundle, spec=jax_planted(), repeats=1,
                                out=lambda *_: None)
    assert (jrep["step"], jrep["t_us"]) == (bundle.violation_step,
                                            bundle.violation_t_us)


def test_shrunk_plan_twin_check_survives_the_shrink(shrunk):
    """The device chaos stream under the bundle's ctl equals the shrunk
    plan's occurrence-filtered pure schedule, on both faces alike."""
    bundle, wl, jwl = shrunk["result"].bundle, shrunk["wl"], shrunk["jwl"]
    kw = dict(horizon_us=bundle.horizon_us, occ_off=bundle.occ_off,
              max_steps=bundle.violation_step + 40)
    sim = BatchedSim(wl.spec, wl.config, triage=True, device="cpu")
    got = ttn.assert_device_matches_schedule(
        sim, bundle.shrunk_plan(), bundle.seed, ctl=bundle.ctl(1), **kw)
    want = jtn.assert_device_matches_schedule(
        JaxSim(jwl.spec, jwl.config, triage=True), jtri.plan_from_json(
            bundle.plan), bundle.seed, ctl=jtri.build_ctl(
                1, bundle.horizon_us, bundle.dropped_clauses,
                bundle.occ_off, bundle.rate_scale), **kw)
    assert got == want and got > 0


def test_batch_violation_reports_bundle_and_repro_command(shrunk):
    result = shrunk["result"]
    with pytest.raises(BatchViolation) as e:
        result.raise_on_violation()
    msg = str(e.value)
    assert "MADSIM_TEST_SEED=0" in msg and "MADSIM_TEST_NUM=1" in msg
    assert "python -m pytest" in msg
    assert f"python -m madsim_tpu_torch.repro {result.bundle_path}" in msg
    assert e.value.bundle_path == result.bundle_path


def test_chaos_free_violation_shrinks_to_the_same_empty_plan():
    """A bug that needs no chaos shrinks to the empty plan on both faces,
    with every clause recorded dropped (tests/test_triage.py's case)."""
    from madsim_tpu.tpu.spec import replace_handlers as jax_replace_handlers
    from madsim_tpu_torch.tpu.spec import replace_handlers

    wl, jwl = chip_smoke.triage_workload(), _sched_workload()
    wl = dataclasses.replace(wl, spec=replace_handlers(
        make_raft_spec(5), check_invariants=lambda ns, alive, now:
        now < 600_000))
    jwl = dataclasses.replace(jwl, spec=jax_replace_handlers(
        jax_raft_spec(5), check_invariants=lambda ns, alive, now:
        jnp.asarray(now < 600_000)))
    sr = triage.shrink_seed(wl, 3, lane_width=4, device="cpu")
    jsr = jtri.shrink_seed(jwl, 3, lane_width=4, refill=False)
    assert sr.kept_atoms == [] and sr.dispatches == jsr.dispatches
    assert set(sr.bundle.dropped_clauses) == {"crash", "partition"}
    assert sr.bundle.to_json() == jsr.bundle.to_json()


def test_shrink_rejects_a_non_violating_seed():
    wl = chip_smoke.triage_workload()
    quiet = dataclasses.replace(wl, config=dataclasses.replace(
        wl.config, nem_crash_interval_lo_us=0, nem_crash_interval_hi_us=0,
        nem_partition_interval_lo_us=0, nem_partition_interval_hi_us=0,
        horizon_us=300_000))
    with pytest.raises(triage.NotReproducible, match="does not violate"):
        triage.shrink_seed(quiet, 0, lane_width=2, device="cpu")


# ------------------------------------------------------- refusals

REFUSED = [
    ("refill", lambda wl: triage.shrink_seed(wl, 0, refill=True,
                                             device="cpu"), "item 11"),
    ("mesh", lambda wl: triage.shrink_seed(wl, 0, mesh="auto",
                                           device="cpu"), "item 14"),
    ("tuning", lambda wl: triage.shrink_seed(wl, 0, tuning="auto",
                                             device="cpu"), "item 12"),
    ("causal", lambda wl: triage.shrink_seed(wl, 0, causal=True,
                                             device="cpu"), "item 9"),
    ("explain", lambda wl: repro.replay_device(
        triage.ReproBundle(**_bundle()), spec=wl.spec, explain=5,
        device="cpu"), "item 9"),
    ("perfetto", lambda wl: repro.replay_device(
        triage.ReproBundle(**_bundle()), spec=wl.spec, perfetto="x.json",
        device="cpu"), "telemetry"),
    ("host backend", lambda wl: repro.replay(
        triage.ReproBundle(**_bundle()), backend="host"), "host runtime"),
    ("both backends", lambda wl: repro.replay(
        triage.ReproBundle(**_bundle()), backend="both"), "host runtime"),
]


@pytest.mark.parametrize("what,call,item", REFUSED,
                         ids=[r[0] for r in REFUSED])
def test_unported_arguments_are_refused(what, call, item):
    with pytest.raises(NotImplementedError, match=item):
        call(chip_smoke.triage_workload())


def test_resolve_spec_refuses_the_jax_package():
    with pytest.raises(ValueError, match="JAX package"):
        repro.resolve_spec("madsim_tpu.tpu.raft:make_raft_spec")
    spec = repro.resolve_spec("madsim_tpu_torch.tpu.raft:make_raft_spec",
                              {"n_nodes": 3})
    assert spec.n_nodes == 3
