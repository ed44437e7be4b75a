"""The port's measured tuning against the JAX package: `madsim_tpu_torch/tune.py`
and `tuning=` on `run_batch`, `shrink_seed`, `Explorer` and `Campaign`.

The same inputs go through both faces on the CPU:
  * cache identity — `lane_bucket`, `config_hash_sans_tier_b` and
    `cache_key` of every tunable workload's config and of a
    Tier-B-perturbed twin equal the JAX values; `TunedEntry` documents
    round-trip, and a stale format, a wrong device, unknown fields or a
    smuggled Tier-B knob raise `TunedCacheError` (tests/test_tune.py's
    cases); an entry either face writes is byte-equal to the other's and
    resolves to the same dict there; the CPU key is ``cpu`` whether or
    not a card is visible, and a card keys by its sanitized name;
  * the search — one scripted measure (walls from a seeded numpy table)
    gives `coordinate_descent`, `ab_guard` and `_guard_tier_a` the same
    assignment, fallback and trial log on both faces;
  * Tier-A invariance — `run_batch` over raft and the buggy generated
    backup under each Tier-A knob and a cache hit (`tuning="auto"`) gives
    the default run's per-seed rows and the JAX run's; explicit arguments
    win over the cache; a tuned shrink gives the untuned bundle; a tuned
    `Explorer` and a tuned `Campaign` give the JAX face's untuned
    search's fingerprint (the planted workload, 8 lanes); a campaign
    persists the
    resolved tuning, refuses a drifting resume, and its checkpoint and
    the JAX face's resume in the other face;
  * Tier B — the effective-default grids and the screened search grid
    equal the JAX face's; legs 1-2 of the gate give the JAX face's
    verdict and reasons on the planted drop-inducing config (48 seeds),
    an engine-refused config and the shipped config; the certifier leg,
    `tier_b_gate(certify=True)` and a Tier-B tune refuse (item 15) before
    any trial; `apply_tier_b` refuses an uncertified entry;
  * `tune_workload` keys its entry by the spec name and the measured
    sweep size, runs one sim per chunk width, and the CLI prints it.

Tolerances: exact everywhere (integers, JSON byte for byte).
"""

import dataclasses
import json
import os
import zlib

import numpy as np
import pytest
import torch

import chip_smoke
from madsim_tpu import campaign as jc
from madsim_tpu import explore as jex
from madsim_tpu import tune as jtune
from madsim_tpu import workloads as jreg
from madsim_tpu.tpu import SimConfig as JSimConfig
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu.tpu import raft_workload as j_raft_workload
from madsim_tpu.tpu.batch import run_batch as j_run_batch
from madsim_tpu_torch import campaign, explore, telemetry, triage, tune
from madsim_tpu_torch import workloads as reg
from madsim_tpu_torch.tpu import BatchedSim, SimConfig, raft_workload
from madsim_tpu_torch.tpu import batch as tbatch
from madsim_tpu_torch.tpu.batch import run_batch
from madsim_tpu_torch.tpu.digest import FEDERATION_H_US, bundle_digest
from test_explore import PLAN, _planted_workload

# one torch thread per process, as tests/test_torch_engine.py sets (six
# xdist workers with torch's default pool oversubscribe the cores)
torch.set_num_threads(1)

ROWS = ("violated", "deadlocked", "violation_step")


def _raft(virtual_secs=0.5):
    return dataclasses.replace(raft_workload(virtual_secs=virtual_secs),
                               host_repro=None)


def _jraft(virtual_secs=0.5):
    return dataclasses.replace(j_raft_workload(virtual_secs=virtual_secs),
                               host_repro=None)


def _faces(name, virtual_secs=0.5):
    """(port, JAX) registry workloads of one tunable name."""
    return (reg.workload_factory(name)(virtual_secs=virtual_secs),
            jreg.workload_factory(name)(virtual_secs=virtual_secs))


def _entry(face, **kw):
    cfg = kw.pop("cfg", SimConfig())
    return face.TunedEntry(
        device_kind="cpu", workload="raft5",
        config_hash=face.config_hash_sans_tier_b(cfg),
        lane_bucket=face.lane_bucket(40), **kw,
    )


# ---------------------------------------------------------- cache identity


def test_copied_constants_equal_the_jax_face(monkeypatch, tmp_path):
    for name in ("TUNED_FORMAT", "TIER_A_KNOBS", "TIER_B_KNOBS",
                 "TRIAL_MS_BUCKETS", "WORKLOADS"):
        assert getattr(tune, name) == getattr(jtune, name), name
    assert tune.default_cache_dir() == jtune.default_cache_dir()
    monkeypatch.setenv("MADSIM_TUNED_DIR", str(tmp_path))
    assert tune.default_cache_dir() == jtune.default_cache_dir() == \
        str(tmp_path)
    # the CPU kind is the JAX face's CPU kind, so CPU entries are shared
    assert tune.device_kind("cpu") == jtune.device_kind() == "cpu"
    assert [f.name for f in dataclasses.fields(tune.TunedEntry)] == \
        [f.name for f in dataclasses.fields(jtune.TunedEntry)]


@pytest.mark.parametrize("name", reg.names(tunable=True))
def test_cache_keys_equal_the_jax_face(name):
    wl, jwl = _faces(name)
    assert wl.spec.name == jwl.spec.name
    assert wl.config.to_toml() == jwl.config.to_toml()
    twin = dataclasses.replace(wl.config, msg_capacity=96, msg_depth_msg=3,
                               msg_depth_timer=2, msg_spare_slots=5)
    jtwin = dataclasses.replace(jwl.config, msg_capacity=96, msg_depth_msg=3,
                                msg_depth_timer=2, msg_spare_slots=5)
    for cfg, jcfg in ((wl.config, jwl.config), (twin, jtwin)):
        assert tune.config_hash_sans_tier_b(cfg) == \
            jtune.config_hash_sans_tier_b(jcfg)
        for lanes in (1, 7, 300, 4096, 32768):
            assert tune.lane_bucket(lanes) == jtune.lane_bucket(lanes)
            assert tune.cache_key("cpu", wl.spec.name, cfg, lanes) == \
                jtune.cache_key("cpu", jwl.spec.name, jcfg, lanes)
    # the key is stable under the Tier-B knobs, the full hash is not
    assert tune.config_hash_sans_tier_b(twin) == \
        tune.config_hash_sans_tier_b(wl.config)
    assert twin.hash() != wl.config.hash() and twin.hash() == jtwin.hash()
    assert tune.config_hash_sans_tier_b(
        dataclasses.replace(wl.config, horizon_us=1)
    ) != tune.config_hash_sans_tier_b(wl.config)


def test_tuned_cache_round_trip_miss_and_refusals(tmp_path):
    cfg = SimConfig()
    d = str(tmp_path)
    entry = _entry(tune, dispatch={"chunk": 32, "pipeline": False},
                   baseline_seeds_per_sec=10.0, tuned_seeds_per_sec=12.0,
                   trials=5)
    path = entry.save(d)
    assert tune.TunedEntry.from_doc(entry.to_doc()) == entry
    assert tune.load_tuned("raft5", cfg, 40, dir=d, device="cpu") == entry
    assert tune.load_tuned("raft5", cfg, 64, dir=d, device="cpu") == entry
    assert tune.load_tuned("raft5", cfg, 128, dir=d, device="cpu") is None
    assert tune.load_tuned("kv", cfg, 40, dir=d, device="cpu") is None
    other = dataclasses.replace(cfg, horizon_us=123_456)
    assert tune.load_tuned("raft5", other, 40, dir=d, device="cpu") is None
    assert tune.resolve_tuning("auto", "raft5", cfg, 40, dir=d,
                               device="cpu") == {"chunk": 32,
                                                 "pipeline": False}
    assert tune.resolve_tuning("auto", "raft5", cfg, 128, dir=d,
                               device="cpu") == {}
    assert tune.resolve_tuning(path, "raft5", cfg, 40) == entry.dispatch
    assert tune.resolve_tuning(entry, "raft5", cfg, 40) == entry.dispatch

    def rewrite(**patch):
        doc = entry.to_doc()
        doc.update(patch)
        with open(path, "w") as f:
            json.dump(doc, f)

    for patch, match in (
        ({"format": "madsim-tpu-tuned/0"}, "format"),
        ({"device_kind": "NVIDIA_H100_80GB_HBM3"}, "does not match"),
        ({"frobnicate": 1}, "unknown"),
        ({"dispatch": {"msg_capacity": 8}}, "non-Tier-A"),
        ({"config": {"chunk": 8}}, "non-Tier-B"),
    ):
        rewrite(**patch)
        with pytest.raises(tune.TunedCacheError, match=match):
            tune.load_tuned("raft5", cfg, 40, dir=d, device="cpu")
        with pytest.raises(jtune.TunedCacheError, match=match):
            jtune.load_tuned("raft5", JSimConfig(), 40, dir=d)


def test_resolve_tuning_forms():
    cfg = SimConfig()
    assert tune.resolve_tuning(None, "raft5", cfg, 64) == {}
    assert tune.resolve_tuning({"chunk": 8}, "raft5", cfg, 64) == {"chunk": 8}
    with pytest.raises(ValueError, match="not Tier-A"):
        tune.resolve_tuning({"msg_capacity": 8}, "raft5", cfg, 64)
    with pytest.raises(TypeError):
        tune.resolve_tuning(3.14, "raft5", cfg, 64)


def test_entries_cross_faces_byte_for_byte(tmp_path):
    """An entry written by either face is the other's, byte for byte, and
    resolves to the same dispatch dict in both."""
    pd, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(dispatch={"chunk": 16, "dispatch_steps": 5000,
                        "pipeline": False, "refill_lanes": 8},
              baseline_seeds_per_sec=101.25, tuned_seeds_per_sec=130.5,
              trials=11)
    p = _entry(tune, **kw).save(pd)
    j = _entry(jtune, cfg=JSimConfig(), **kw).save(jd)
    assert os.path.basename(p) == os.path.basename(j)
    assert open(p).read() == open(j).read()
    want = kw["dispatch"]
    assert tune.resolve_tuning("auto", "raft5", SimConfig(), 40, dir=jd,
                               device="cpu") == want
    assert jtune.resolve_tuning("auto", "raft5", JSimConfig(), 40,
                                dir=pd) == want
    assert tune.load_tuned("raft5", SimConfig(), 40, dir=jd,
                           device="cpu").to_doc() == \
        jtune.load_tuned("raft5", JSimConfig(), 40, dir=pd).to_doc()


def test_device_kind_keys_by_the_device_asked(monkeypatch, tmp_path):
    """A card keys by its sanitized name; a CPU consumer looks up the
    ``cpu`` entry even on a host with a card; a CUDA lookup without a
    card raises rather than falling back to the CPU's entry."""
    d = str(tmp_path)
    _entry(tune, dispatch={"chunk": 8}).save(d)
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            tune.device_kind("cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert tune.device_kind("cuda") == "NVIDIA_H100_80GB_HBM3"
    assert tune.device_kind(torch.device("cuda", 0)) == \
        "NVIDIA_H100_80GB_HBM3"
    assert tune.resolve_tuning("auto", "raft5", SimConfig(), 40, dir=d,
                               device="cpu") == {"chunk": 8}
    assert tune.resolve_tuning("auto", "raft5", SimConfig(), 40,
                               dir=d) == {}  # no card entry: a clean miss


# --------------------------------------------------------------- the search


def _scripted_measure(seed):
    """A measure whose wall is a pure function of (assignment, rep): a
    seeded table of per-assignment walls times a seeded per-rep noise."""
    def measure(assign, rep):
        key = repr(sorted((k, repr(v)) for k, v in assign.items()))
        base = np.random.default_rng([seed, zlib.crc32(key.encode())])
        noise = np.random.default_rng([seed, 7919, int(rep)])
        return float(base.uniform(0.1, 1.0) * noise.uniform(0.9, 1.1))

    return measure


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_search_equals_the_jax_face(seed):
    default = {"chunk": 64, "dispatch_steps": 10_000, "pipeline": True,
               "refill_lanes": 0, "devices": 0}
    out = []
    for face in (tune, jtune):
        knobs = (face.Knob("dispatch_steps", (2_000, 5_000, 10_000, 20_000)),
                 face.Knob("pipeline", (True, False)),
                 face.Knob("chunk", (16, 32, 64)),
                 face.Knob("refill_lanes", (0, 16)))
        measure = _scripted_measure(seed)
        tl = face.TrialLog()
        best = face.coordinate_descent(knobs, measure, default, tl)
        meds = face.ab_guard(measure, default, best, tl, rounds=2)
        guarded = face._guard_tier_a(measure, default, best, tl,
                                     work_items=64, guard_rounds=2)
        out.append((best, meds, guarded, tl.trials, tl.rep))
    assert out[0] == out[1]


def test_guard_falls_back_like_the_jax_face():
    for face in (tune, jtune):
        tl = face.TrialLog()
        best, fallback, base_sps, tuned_sps = face._guard_tier_a(
            lambda a, rep: 1.0 if a["k"] == 7 else 0.5,
            {"k": 1}, {"k": 7}, tl, work_items=10, guard_rounds=1,
        )
        assert fallback and best == {"k": 1}
        assert base_sps == tuned_sps == 10 / 0.5


def test_trial_log_routes_through_metrics_registry(tmp_path):
    telemetry.enable(out_dir=str(tmp_path))
    try:
        tl = tune.TrialLog()
        tl.trial(lambda a, rep: 0.01, {"k": 1}, "refill_lanes", 1)
        tl.trial(lambda a, rep: 0.02, {"k": 2}, "refill_lanes", 2)
        reg_ = telemetry.get_registry()
        assert reg_.counter("tune_trials_total").value(
            knob="refill_lanes") == 2
        snap = reg_.histogram("tune_trial_ms").snapshot(knob="refill_lanes")
        assert snap and snap["count"] == 2
        assert any(s.name == "tune_trial" for s in telemetry.spans())
    finally:
        telemetry.disable()


# ------------------------------------------------ Tier-A invariance matrix


def _rows(res):
    return {k: np.asarray(getattr(res, k)) for k in ROWS}


def _matrix_faces(name):
    if name == "raft":
        return _raft(), _jraft(), 32
    from madsim_tpu.speclang.generated import backup_device as jb
    from madsim_tpu_torch.speclang.generated import backup_device as tb

    return (dataclasses.replace(tb.make_workload(buggy=True, virtual_secs=2.0),
                                host_repro=None),
            dataclasses.replace(jb.make_workload(buggy=True, virtual_secs=2.0),
                                host_repro=None), 32)


@pytest.mark.parametrize("name", ["raft", "backup"])
def test_tier_a_invariance_matrix(name, monkeypatch, tmp_path):
    """Every Tier-A knob, and a cache hit, leave each seed's rows where the
    default run and the JAX run put them; the chunked variants keep each
    seed's own step count too."""
    wl, jwl, n = _matrix_faces(name)
    sim = BatchedSim(wl.spec, wl.config, device="cpu")
    calls = []
    inner = sim.run
    sim.run = lambda *a, **kw: calls.append(len(a[0])) or inner(*a, **kw)
    base = run_batch(range(n), wl, sim=sim, max_traces=0)
    want = _rows(j_run_batch(range(n), jwl, mesh=None, max_traces=0))
    got = _rows(base)
    for k in ROWS:
        assert np.array_equal(got[k], want[k]), k
    if name == "backup":
        assert got["violated"].any()  # the planted bug fires
    monkeypatch.setenv("MADSIM_TUNED_DIR", str(tmp_path))
    tune.TunedEntry(
        device_kind="cpu", workload=wl.spec.name,
        config_hash=tune.config_hash_sans_tier_b(wl.config),
        lane_bucket=tune.lane_bucket(n),
        dispatch={"chunk": n // 4, "dispatch_steps": 40, "pipeline": False},
    ).save()
    for tuning in ({"chunk": n // 4}, {"dispatch_steps": 2000},
                   {"pipeline": False}, {"refill_lanes": 16}, "auto"):
        calls.clear()
        res = run_batch(range(n), wl, sim=sim, max_traces=0, tuning=tuning)
        for k in ROWS:
            assert np.array_equal(_rows(res)[k], got[k]), (tuning, k)
        if "refill_lanes" in tuning:
            assert res.summary["refill_lanes"] == 16 and not calls
        else:
            assert np.array_equal(res.retired_step, base.retired_step)
        if tuning == "auto":  # the cache hit landed: four chunks
            assert calls == [n // 4] * 4


def test_run_batch_explicit_arguments_win():
    wl = _raft()
    sim = BatchedSim(wl.spec, wl.config, device="cpu")
    tuned = run_batch(range(24), wl, sim=sim, max_traces=0,
                      tuning={"refill_lanes": 8})
    assert tuned.summary.get("refill_lanes") == 8
    explicit = run_batch(range(24), wl, sim=sim, max_traces=0, refill=4,
                         tuning={"refill_lanes": 8})
    assert explicit.summary.get("refill_lanes") == 4
    # an explicit refill=0 pins the chunked path whatever the cache holds
    chunked = run_batch(range(24), wl, sim=sim, max_traces=0, refill=0,
                        tuning={"refill_lanes": 8})
    assert "refill_lanes" not in chunked.summary
    # a cached `devices` beyond this host falls back to the default mesh
    res = run_batch(range(16), wl, sim=sim, max_traces=0,
                    tuning={"devices": 9})
    assert res.seeds.size == 16
    assert tune._mesh_for(9, cached=True) == "auto"
    assert tune._mesh_for(0) == "auto" and tune._mesh_for(1) is None
    # the tuner's own search raises on a count this host cannot give (a
    # multi-device mesh was refused as item 14 until it came)
    with pytest.raises(ValueError, match="visible"):
        tune._mesh_for(2 + torch.cuda.device_count())


def test_tuned_shrink_gives_the_untuned_bundle(monkeypatch, tmp_path):
    """shrink_seed adopts the tuned refill lane width where the caller
    kept the default, at the 16-lane bucket; the bundle is the same."""
    wl = chip_smoke.explore_workload(1_000_000)
    sim = BatchedSim(wl.spec, wl.config, triage=True, device="cpu")
    plain = triage.shrink_seed(wl, 46, lane_width=4, sim=sim,
                               out_dir=str(tmp_path / "plain"))
    widths = []
    inner = triage._Eval.__init__

    def spy(self, sim_, seed, max_steps, lane_width, **kw):
        widths.append(lane_width)
        inner(self, sim_, seed, max_steps, lane_width, **kw)

    monkeypatch.setattr(triage._Eval, "__init__", spy)
    tuned = triage.shrink_seed(wl, 46, sim=sim, tuning={"refill_lanes": 8},
                               out_dir=str(tmp_path / "tuned"))
    assert widths == [8]
    assert bundle_digest(tuned.bundle) == bundle_digest(plain.bundle)
    assert tuned.kept_atoms == plain.kept_atoms


@pytest.fixture(scope="module")
def search():
    """(port, JAX) planted workloads at FEDERATION_H_US, and the JAX
    face's untuned one-generation search over them (meta-seed 3, 8
    lanes): its fingerprint."""
    jcfg = jtn.compile_plan(PLAN, JSimConfig(horizon_us=FEDERATION_H_US,
                                             loss_rate=0.0))
    jwl = dataclasses.replace(_planted_workload(), config=jcfg)
    jfp = jex.Explorer(jwl, meta_seed=3, lanes=8,
                       shrink_violations=False).run(1).fingerprint()
    return chip_smoke.explore_workload(FEDERATION_H_US), jwl, jfp


def test_explorer_tuning_applies_and_keeps_the_fingerprint(search):
    """The Explorer consumes chunk, refill lane width, dispatch_steps and
    pipeline where the caller kept the defaults (explicit arguments win),
    and the tuned search fingerprints as the JAX face's untuned one."""
    wl, _, jfp = search
    tn = {"dispatch_steps": 123, "pipeline": False, "chunk": 4,
          "refill_lanes": 4}
    ex = explore.Explorer(wl, meta_seed=3, lanes=8, shrink_violations=False,
                          tuning=tn, device="cpu")
    assert (ex.dispatch_steps, ex.pipeline, ex.chunk, ex.refill_lanes) == \
        (123, False, 4, 4)
    pinned = explore.Explorer(wl, lanes=8, chunk=8, refill_lanes=8,
                              dispatch_steps=456, pipeline=True, tuning=tn,
                              sim=ex.sim)
    assert (pinned.dispatch_steps, pinned.pipeline, pinned.chunk,
            pinned.refill_lanes) == (456, True, 8, 8)
    assert ex.run(1).fingerprint() == jfp


def test_campaign_tuning_persists_resumes_and_crosses_faces(search,
                                                             tmp_path):
    """The checkpoint persists the RESOLVED tuning; resume replays it and
    refuses a different one; a tuned campaign fingerprints as the JAX
    face's untuned search; checkpoints made under a tuning resume in the
    other face."""
    wl, jwl, jfp = search
    tn = {"chunk": 4, "refill_lanes": 4, "pipeline": False}
    d = str(tmp_path / "port")
    c = campaign.Campaign(wl, d, meta_seed=3, lanes=8, shrink=False,
                          tuning=tn, device="cpu")
    assert c.tuning == tn and c.ex.chunk == 4 and c.ex.refill_lanes == 4
    assert campaign.explorer_params(c.ex)["pipeline"] is False
    rep = c.run(1)
    c.checkpoint()
    man = json.load(open(os.path.join(d, campaign.MANIFEST)))
    assert man["tuning"] == tn
    assert rep.fingerprint() == jfp
    # resume replays the persisted tuning; a different one is refused
    c2 = campaign.Campaign.resume(d, workload=wl, device="cpu")
    assert c2.tuning == tn and c2.ex.chunk == 4 and c2.generation == 1
    assert campaign.Campaign.resume(d, workload=wl, tuning=dict(tn),
                                    device="cpu").tuning == tn
    with pytest.raises(ValueError, match="tuning"):
        campaign.Campaign.resume(d, workload=wl, tuning={"chunk": 8},
                                 device="cpu")
    # an explicit pipeline still wins over the tuned dict
    c3 = campaign.Campaign(wl, str(tmp_path / "c3"), lanes=8, sim=c.ex.sim,
                           tuning={"pipeline": False}, pipeline=True)
    assert c3.ex.pipeline is True
    # across faces: the port's checkpoint in the JAX face, the JAX face's
    # (made at generation 0 under the same tuning) in the port
    jback = jc.Campaign.resume(d, workload=jwl)
    assert jback.tuning == tn and jback.ex.chunk == 4
    with pytest.raises(ValueError, match="tuning"):
        jc.Campaign.resume(d, workload=jwl, tuning={"chunk": 8})
    jd = str(tmp_path / "jax")
    jc.Campaign(jwl, jd, meta_seed=3, lanes=8, shrink=False,
                tuning=tn).checkpoint()
    back = campaign.Campaign.resume(jd, workload=wl, device="cpu")
    assert back.tuning == tn and back.ex.refill_lanes == 4
    assert back.run(1).fingerprint() == jfp


# -------------------------------------------------------------- Tier B


@pytest.mark.parametrize("name", reg.names(tunable=True))
def test_tier_b_grids_equal_the_jax_face(name):
    wl, jwl = _faces(name)
    got = [(k.name, k.values, k.tier)
           for k in tune.tier_b_config_knobs(wl, device="cpu")]
    want = [(k.name, k.values, k.tier) for k in jtune.tier_b_config_knobs(jwl)]
    assert got == want
    # the defaults `_tune_tier_b` starts from, depths left to the engine
    default = {k: None if k.startswith("msg_depth") else
               getattr(wl.config, k) for k, _, _ in got}
    assert tune.tier_b_effective_defaults(wl, default, device="cpu") == \
        jtune.tier_b_effective_defaults(jwl, default)


@pytest.mark.parametrize("name", ["raft", "kv", "twopc-gen"])
def test_spec_knobs_equal_the_jax_face(name):
    rows = tune._spec_knobs_for(name, 2.0)
    jrows = jtune._spec_knobs_for(name, 2.0)
    assert [(r.name, r.values, r.default) for r in rows] == \
        [(r.name, r.values, r.default) for r in jrows] and rows
    wl = reg.workload_factory(name)(virtual_secs=2.0)
    jwl = jreg.workload_factory(name)(virtual_secs=2.0)
    for r, jr in zip(rows, jrows):
        spec, jspec = r.rebuild(wl, r.values[0]).spec, \
            jr.rebuild(jwl, jr.values[0]).spec
        assert spec.name == jspec.name and spec is not wl.spec


def test_tier_b_screened_grid_equals_the_jax_face(monkeypatch):
    """`_tune_tier_b` screens the same candidates on both faces; with no
    winner both keep the defaults. A winner would go to the gate, whose
    certifier leg refuses: an uncertified winner is never cached."""
    wl, jwl = _raft(), _jraft()
    seen = {}

    def descent(face):
        def fake(knobs, measure, default, tl):
            seen[face] = ([(k.name, k.values) for k in knobs], dict(default))
            return dict(default)
        return fake

    monkeypatch.setattr(tune, "coordinate_descent", descent("port"))
    monkeypatch.setattr(jtune, "coordinate_descent", descent("jax"))
    tier_a = {"chunk": 8, "dispatch_steps": 10_000, "pipeline": True,
              "refill_lanes": 0, "devices": 0}
    got = tune._tune_tier_b(wl, tier_a, 8, tune.TrialLog(),
                            spec_knobs=tune._spec_knobs_for("raft", 0.5),
                            device="cpu")
    want = jtune._tune_tier_b(jwl, tier_a, 8, jtune.TrialLog(),
                              spec_knobs=jtune._spec_knobs_for("raft", 0.5))
    assert got == want == ({}, {}, False)
    assert seen["port"] == seen["jax"]
    # a measured winner reaches the gate, and the gate's certifier refuses
    monkeypatch.setattr(tune, "coordinate_descent", lambda k, m, d, tl: {
        **d, "msg_spare_slots": d["msg_spare_slots"] + 1})
    monkeypatch.setattr(tune, "ab_guard", lambda *a, **kw: {
        "default": 1.0, "tuned": 0.5})
    with pytest.raises(NotImplementedError, match="item 15"):
        tune._tune_tier_b(wl, tier_a, 8, tune.TrialLog(), device="cpu")


def _gate_pair(wl, jwl, cfg, jcfg, seeds):
    return (tune.tier_b_gate(wl, cfg, seeds=seeds, certify=False,
                             device="cpu"),
            jtune.tier_b_gate(jwl, jcfg, seeds=seeds, certify=False))


def test_tier_b_gate_legs_1_2_equal_the_jax_face():
    """The planted drop-inducing pool budget (tests/test_tune.py:426-440),
    an engine-refused config and the shipped config: the same verdicts,
    reasons and summaries on both faces."""
    wl, jwl = _raft(), _jraft()
    kw = dict(msg_capacity=8, msg_depth_msg=None)
    got, want = _gate_pair(wl, jwl, dataclasses.replace(wl.config, **kw),
                           dataclasses.replace(jwl.config, **kw), 48)
    assert got == want
    assert not got["ok"] and any("overflow" in r for r in got["reasons"])
    got, want = _gate_pair(wl, jwl, wl.config, jwl.config, 48)
    assert got == want and got["ok"]
    kw = dict(msg_spare_slots=-1)
    got, want = _gate_pair(wl, jwl, dataclasses.replace(wl.config, **kw),
                           dataclasses.replace(jwl.config, **kw), 8)
    assert got == want
    assert not got["ok"] and got["reasons"][0].startswith(
        "engine rejects the config")


def test_tier_b_refuses_before_any_trial(monkeypatch):
    """The certifier (item 15) refuses `certify_config`, the gate's
    certify leg and a Tier-B or Tier-AB tune, the last two before a sim
    is built or a trial runs."""
    def boom(*a, **kw):
        raise AssertionError("a trial ran before the refusal")

    monkeypatch.setattr(tune, "SweepTimer", boom)
    monkeypatch.setattr(tbatch, "run_batch", boom)
    wl = _raft()
    for call in (
        lambda: tune.certify_config(wl.spec, wl.config),
        lambda: tune.tier_b_gate(wl, wl.config, device="cpu"),
        lambda: tune.tune_workload(wl, "raft", tier="AB", device="cpu"),
        lambda: tune.tune_workload(wl, "raft", tier="B", device="cpu"),
    ):
        with pytest.raises(NotImplementedError, match="item 15"):
            call()


def test_apply_tier_b_requires_certification():
    cfg = SimConfig()
    entry = tune.TunedEntry(
        device_kind="cpu", workload="raft5", config_hash="x",
        lane_bucket=64, config={"msg_spare_slots": 2}, certified=False,
    )
    with pytest.raises(ValueError, match="certified"):
        tune.apply_tier_b(cfg, entry)
    entry.certified = True
    out = tune.apply_tier_b(cfg, entry)
    assert out.msg_spare_slots == 2 and out.hash() != cfg.hash()
    assert tune.apply_tier_b(cfg, tune.TunedEntry(
        device_kind="cpu", workload="raft5", config_hash="x",
        lane_bucket=64)) is cfg


# ------------------------------------------------------------ the tuners


def test_tier_a_grid_equals_the_jax_face():
    """The JAX face's grid, less its `devices` knob (the JAX tests run an
    8-device CPU mesh; the port offers it only with several cards) and
    less any chunk width that leaves a short last chunk."""
    wl, jwl = _raft(), _jraft()
    for n, quick in ((32, False), (32, True), (4096, False), (7, False)):
        got = {k.name: k.values
               for k in tune.tier_a_knobs(wl, n, quick=quick, device="cpu")}
        want = {k.name: k.values
                for k in jtune.tier_a_knobs(jwl, n, quick=quick)}
        want.pop("devices", None)
        if "chunk" in want:
            want["chunk"] = tuple(c for c in want["chunk"] if n % c == 0)
        assert got == want, n
    assert dict((k.name, k.values) for k in tune.tier_a_knobs(
        wl, 7, device="cpu"))["chunk"] == (1, 7)


def test_tune_workload_one_sim_per_chunk_and_the_key_consumers_resolve(
    monkeypatch, tmp_path,
):
    """Trials share one sim per chunk width (on a card a sim keeps one
    graph, so a shared sim would recapture inside a timed trial), and the
    entry is keyed by the spec name and the measured sweep size, where
    every tuning="auto" consumer finds it."""
    wl = _raft(0.2)
    used = []
    inner = tbatch.run_batch

    def spy(seeds, workload, **kw):
        used.append((kw["chunk"], id(kw["sim"])))
        return inner(seeds, workload, **kw)

    monkeypatch.setattr(tbatch, "run_batch", spy)
    entry = tune.tune_workload(
        wl, "raft", lanes=4096, n_seeds=8,
        knobs=(tune.Knob("chunk", (2, 4, 8)),
               tune.Knob("refill_lanes", (0, 2))),
        cache_dir=str(tmp_path), guard_rounds=1, device="cpu",
    )
    sim_of = {}
    for chunk, sim in used:  # each width always runs on its own sim
        assert sim_of.setdefault(chunk, sim) == sim
    assert len(sim_of) == len(set(sim_of.values())) == 3
    assert entry.workload == wl.spec.name == "raft5"
    assert entry.device_kind == "cpu" and entry.lane_bucket == 8
    assert tune.load_tuned("raft5", wl.config, 8, dir=str(tmp_path),
                           device="cpu") == entry
    assert tune.resolve_tuning("auto", "raft5", wl.config, 8,
                               dir=str(tmp_path), device="cpu") == \
        entry.dispatch


def test_spread_mix_equals_the_jax_face():
    sim, h = tune.spread_mix_sim(0.1, device="cpu")
    jsim, jh = jtune.spread_mix_sim(0.1)
    assert h == jh and sim.config.to_toml() == jsim.config.to_toml()
    rows, jrows = tune.spread_ctl_rows(h, 24), jtune.spread_ctl_rows(jh, 24)
    for a, b in zip(rows, jrows):
        assert np.array_equal(a.numpy(), np.asarray(b))
    entry = tune.tune_spread_mix(
        lanes=4, waves=2, virtual_secs=0.1, guard_rounds=1, save=False,
        knobs=(tune.Knob("refill_lanes", (2, 4)),), device="cpu",
    )
    assert entry.workload == "spread-mix" and entry.lane_bucket == 4
    assert entry.config_hash == jtune.config_hash_sans_tier_b(jsim.config)


def test_cli_prints_the_entry_and_refuses_tier_b(capsys, tmp_path):
    rc = tune.main(["--workload", "raft", "--device", "cpu", "--lanes", "8",
                    "--virtual-secs", "0.2", "--quick", "--quiet",
                    "--cache-dir", str(tmp_path)])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 0 and doc["device_kind"] == "cpu"
    assert doc["workload"] == "raft5" and doc["lane_bucket"] == 8
    assert doc["format"] == jtune.TUNED_FORMAT and doc["trials"] > 0
    assert os.listdir(tmp_path) == [
        tune.TunedEntry.from_doc(doc).key() + ".json"]
    rc = tune.main(["--workload", "raft", "--device", "cpu", "--tier", "AB",
                    "--no-save"])
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rc == 1 and "item 15" in doc["error"]
