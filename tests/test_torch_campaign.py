"""The port's campaign layer, island federation and measurement discipline
against the JAX package: `madsim_tpu_torch/campaign.py`,
`madsim_tpu_torch/measure.py`, `ReproBundle.stamp` and
`explore.Federation` with the explore CLI's `--islands` and `--out`.

The same inputs go through both faces on the CPU, at the JAX tests' sizes
(tests/test_campaign.py, tests/test_devloop.py, tests/test_multichip.py:
the planted workload, 16 lanes, chunk 8, meta-seed 11):
  * the pure pieces — `clause_profile`, `bug_signature`, `coarse_key`,
    `BugRecord`, the checkpoint files (byte for byte),
    `check_resume_conflicts`, `build_workload`'s errors, `regress` on an
    empty dir, the copied constants, `ReproBundle.stamp`, and
    `measure.py`'s seed blocks, median and warm-up order — equal the
    original's;
  * one generation of the pinned search as a campaign with one shrink,
    on each face, checkpointed: the same BugRecords (signatures, clause
    profiles, witness seeds), byte-equal stamped bundles, manifests with
    the same keys and parameters; the port's bundle replays green through
    `regress`; a campaign's cross-witness anatomy is the JAX face's
    `bug_anatomy` of the same witnesses;
  * kill/resume: the port's checkpoint at generation 1, resumed for 2
    more, gives the uninterrupted 3-generation run's fingerprint, curves,
    corpus digest and violations, survives a second round trip, and
    refuses a different config; the same through the device loop with a
    resume mid-ring; the `campaign run` CLI, 1 + 1 generations in two
    processes, equals 2 in a third;
  * checkpoints cross faces: the JAX face's generation-1 checkpoint
    resumes in the port, and the port's in the JAX face, both to
    `PINNED_EXPLORE`, with equal BugRecords;
  * merge + minimize over a port and a JAX campaign keeps the union
    exactly, and its kept set and bits are the JAX face's on the same
    dirs;
  * the federation at `digest.FEDERATION_RUN` reaches `PINNED_FEDERATION`
    (the JAX face's), with the JAX face's exchange log, on the host loop
    and the device loop, and across snapshot/restore (the port's and the
    JAX face's snapshot);
  * the explore CLI's `--out` writes a campaign that resumes to the
    pinned fingerprint, and `--islands 2` prints the pinned federation.

Tolerances: exact everywhere (integers, JSON byte for byte, bitmaps).
"""

import dataclasses
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke
from madsim_tpu import campaign as jc
from madsim_tpu import explore as jex
from madsim_tpu import measure as jmeasure
from madsim_tpu import triage as jtriage
from madsim_tpu.tpu import SimConfig as JSimConfig
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu_torch import campaign, explore, measure, triage
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch.tpu import engine as te
from madsim_tpu_torch.tpu.digest import (
    EXPLORE_RUN, FEDERATION_GENERATIONS, FEDERATION_H_US, FEDERATION_RUN,
    PINNED_EXPLORE, PINNED_FEDERATION,
)
from test_explore import PLAN, _planted_workload
from test_torch_devloop import SEEN_CAP, _host_baseline, _port_sim
from test_torch_engine import shared_across_workers, shared_dir
from test_torch_explore import _keys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the pinned search as a campaign (tests/test_campaign.py's kill/resume
# parameters), with one shrink of its first coarse group
CAMPAIGN = dict(meta_seed=EXPLORE_RUN["meta_seed"], lanes=EXPLORE_RUN["lanes"],
                chunk=EXPLORE_RUN["chunk"])
SHRINK = dict(shrink=True, max_shrinks=1, lane_width=16,
              spec_ref=chip_smoke.TRIAGE_SPEC_REF)


def _pwl():
    return chip_smoke.explore_workload()


def _copy(src, dst):
    shutil.copytree(src, dst)
    return str(dst)


def _assert_reports_equal(got, want):
    assert got.fingerprint() == want.fingerprint()
    assert got.coverage_curve == want.coverage_curve
    assert got.corpus_curve == want.corpus_curve
    assert got.violation_curve == want.violation_curve
    assert got.corpus_digest == want.corpus_digest
    assert got.violations == want.violations
    assert got.seeds_run == want.seeds_run


def _records(bugs):
    """BugRecords as JSON reads them back, without their machine-local
    bundle paths."""
    return [{k: v for k, v in json.loads(json.dumps(b.to_dict())).items()
             if k != "bundle_path"} for b in bugs]


# ------------------------------------------------------- the pure pieces


def test_copied_constants_equal_the_jax_face():
    for name in ("CAMPAIGN_FORMAT", "MANIFEST", "CORPUS", "SEEN",
                 "VIOLATIONS", "BUGS", "REPORT", "BUNDLE_DIR",
                 "REGRESSION_DIR", "_SIDECAR_KEYS"):
        assert getattr(campaign, name) == getattr(jc, name), name
    assert campaign._sidecar_names("3-0a1b2c3d") == jc._sidecar_names(
        "3-0a1b2c3d")
    assert campaign.JAX_SPEC_FOR_REF == f"{jc.__name__}:spec_for"
    assert campaign.SPEC_FOR_REF == f"{campaign.__name__}:spec_for"
    assert campaign.named_workload_ref("raft", 0.5, True) == \
        jc.named_workload_ref("raft", 0.5, True)
    assert campaign.spec_for("raft", 0.5).name == jc.spec_for("raft", 0.5).name


def test_signatures_and_profiles_equal_the_jax_face():
    rng = np.random.default_rng(12)
    names = list(tn.TRIAGE_CLAUSES)
    for _ in range(200):
        atoms = [(str(rng.choice(names)),
                  None if rng.random() < 0.2 else int(rng.integers(0, 31)))
                 for _ in range(int(rng.integers(0, 7)))]
        assert campaign.clause_profile(atoms) == jc.clause_profile(atoms)
        for spec in ("raft5", "kv"):
            assert campaign.bug_signature(spec, "invariant", atoms) == \
                jc.bug_signature(spec, "invariant", atoms)
    for k in _keys(rng, 200):
        # a genome from JSON (lists) and from memory key the same group
        for g in (k, json.loads(json.dumps(k))):
            assert campaign.coarse_key("raft5", "invariant", g) == \
                jc.coarse_key("raft5", "invariant", g)
    # rate scales as float32 values, and as numpy scalars
    g = (3, 1, (0, 2, 0, 0, 0, 0), tuple(np.float32([0.25, 0.5, 1.0])), 0)
    assert campaign.coarse_key("raft5", "invariant", g) == jc.coarse_key(
        "raft5", "invariant", (3, 1, (0, 2, 0, 0, 0, 0), (0.25, 0.5, 1.0), 0))
    assert campaign.clause_profile(
        [("crash", 2), ("crash", 5), ("loss", None), ("loss", 3)]
    ) == [["crash", 2], ["loss", -1]]


def test_bug_record_round_trip_equals_the_jax_face():
    doc = dict(
        signature="s1", spec_name="raft5", violation_kind="invariant",
        clause_profile=[["partition", 1]],
        witnesses=[{"seed": 3, "candidate": [3, 0, [0] * 6, [1.0] * 3, 0],
                    "dispatch": 0, "origin": "fresh", "cov_digest": "ab"}],
        bundle_path="/tmp/b.json", campaign="c1", first_generation=0,
        coarse_keys=["coarse-xyz"],
    )
    rec, jrec = campaign.BugRecord(**doc), jc.BugRecord(**doc)
    assert rec.to_dict() == jrec.to_dict()
    again = campaign.BugRecord.from_dict(json.loads(json.dumps(
        jrec.to_dict())))
    assert again == rec and again.witness_seeds == [3]
    with pytest.raises(ValueError, match="unknown"):
        campaign.BugRecord.from_dict({**rec.to_dict(), "bogus": 1})


def _pure_snapshot(face):
    bitmap = np.arange(256, dtype=np.uint32) * np.uint32(2654435761)
    return {
        "meta_seed": 7, "lanes": 16, "meta_cursor": 42, "next_fresh": 33,
        "generation": 2, "shrinks_done": 1, "seeds_run": 32,
        "first_violation_dispatch": 1, "wall_s": 1.5,
        "union": bitmap.tobytes().hex(),
        "coverage_curve": [10, 20], "corpus_curve": [1, 2],
        "violation_curve": [0, 1],
        "corpus": [face.CorpusEntry(
            cand=face.Candidate(seed=5, origin="swarm"), new_bits=10,
            bitmap=bitmap, hiwater=3, transitions=9, violated=False,
            dispatch=1,
        ).to_dict()],
        "seen": [[5, 0, [0] * 6, [1.0] * 3, 0]],
        "violated_seeds": [9],
        "violations": [{"candidate": [9, 0, [0] * 6, [1.0] * 3, 0],
                        "seed": 9, "dispatch": 1, "origin": "fresh",
                        "describe": "seed=9", "bundle_path": None,
                        "cov_digest": None}],
    }


def test_checkpoint_files_equal_the_jax_face_byte_for_byte(tmp_path):
    """save_checkpoint writes the JAX face's files (names, bytes,
    digests); each face loads the other's; the manifest is the commit
    point (stale sidecars go only after it lands), and a torn sidecar or
    a foreign format fails loudly."""
    extra = {
        "campaign_id": "c", "workload": {"kind": "custom"},
        "config_hash": "h", "spec_name": "raft5", "params": {"lanes": 16},
        "seen_violations": 1, "kind": "campaign",
    }
    bug = dict(signature="s", spec_name="raft5", violation_kind="invariant",
               clause_profile=[], witnesses=[], bundle_path=None,
               campaign="c", first_generation=1, coarse_keys=["k"])
    d, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    campaign.save_checkpoint(d, _pure_snapshot(explore), extra,
                             bugs=[campaign.BugRecord(**bug)])
    jc.save_checkpoint(jd, _pure_snapshot(jex), extra,
                       bugs=[jc.BugRecord(**bug)])
    assert sorted(os.listdir(d)) == sorted(os.listdir(jd))
    for f in os.listdir(d):
        assert open(os.path.join(d, f)).read() == open(
            os.path.join(jd, f)).read(), f
    back, jback = campaign.load_checkpoint(jd), jc.load_checkpoint(d)
    assert back["snapshot"] == jback["snapshot"] == json.loads(
        json.dumps(_pure_snapshot(explore)))
    assert back["bugs"] == [campaign.BugRecord(**bug)]
    assert not [p for p in os.listdir(d) if ".tmp" in p]
    man = back["manifest"]
    assert man["files"]["corpus"].startswith("corpus.2-")
    snap3 = {**_pure_snapshot(explore), "generation": 3}
    campaign.save_checkpoint(d, snap3, extra, bugs=[])
    names = sorted(os.listdir(d))
    assert not [n for n in names if n.startswith("corpus.2-")]
    man3 = campaign.load_checkpoint(d)["manifest"]
    assert man3["files"]["corpus"].startswith("corpus.3-")
    with open(os.path.join(d, man3["files"]["seen"]), "a") as f:
        f.write('{"genome": [1, 0, [0,0,0,0,0,0], [1.0,1.0,1.0], 0]}\n')
    with pytest.raises(AssertionError, match="digest"):
        campaign.load_checkpoint(d)
    os.remove(os.path.join(d, man3["files"]["seen"]))
    with pytest.raises(AssertionError, match="missing"):
        campaign.load_checkpoint(d)
    man3["format"] = "bogus/9"
    json.dump(man3, open(os.path.join(d, campaign.MANIFEST), "w"))
    with pytest.raises(ValueError, match="format"):
        campaign.load_checkpoint(d)
    assert campaign._read_jsonl(os.path.join(d, "absent.jsonl")) == []


def _error(call, exc=ValueError):
    with pytest.raises(exc) as e:
        call()
    return str(e.value)


def test_resume_conflicts_and_workload_errors_equal_the_jax_face(tmp_path):
    man = {
        "params": {"meta_seed": 0, "lanes": 256, "chunk": 256},
        "workload": {"kind": "named", "name": "raft",
                     "virtual_secs": 2.0, "storm": True},
        "tuning": None,
    }
    for face in (campaign, jc):
        face.check_resume_conflicts(man, {})
        face.check_resume_conflicts(man, {
            "workload": "raft", "virtual_secs": 2.0, "meta_seed": 0,
            "lanes": 256, "storm": True, "tuning": None})
    for given in ({"meta_seed": 5}, {"lanes": 64}, {"chunk": 8},
                  {"workload": "kv"}, {"virtual_secs": 1.0},
                  {"storm": False}, {"tuning": {"chunk": 64}},
                  {"meta_seed": 5, "lanes": 64, "storm": False}):
        msg = _error(lambda: campaign.check_resume_conflicts(man, given))
        assert msg == _error(lambda: jc.check_resume_conflicts(man, given))
        assert next(iter(given)) in msg
    for face in (campaign, jc):
        assert "nosuch" in _error(lambda: face.build_workload(
            {"kind": "named", "name": "nosuch", "virtual_secs": 1.0}))
        assert _error(lambda: face.build_workload({"kind": "custom"})) == \
            _error(lambda: jc.build_workload({"kind": "custom"}))
        out = []
        rep = face.regress(str(tmp_path / "nothing"), out=out.append)
        assert rep["bundles"] == 0 and not rep["failures"]
        assert "0/0" in out[-1]


def test_bundle_stamp_equals_the_jax_face():
    doc = dict(
        seed=3, spec_ref="chip_smoke:planted_restamp_spec", spec_kwargs={},
        spec_name="raft5", n_nodes=5, config_toml="", config_hash="h",
        violation_kind="invariant", violation_step=188,
        violation_t_us=1_744_685, dropped_clauses=["crash"],
        occ_off={"partition": 5}, rate_scale={}, horizon_us=1_746_685,
        max_steps=20_000, plan={"name": "p", "clauses": []},
        trace_tail=["x"],
    )
    b, jb = triage.ReproBundle(**doc), jtriage.ReproBundle(**doc)
    assert b.stamp("sig", "camp", 0) is b
    jb.stamp("sig", "camp", 0)
    assert b.to_json() == jb.to_json()
    assert (b.signature, b.campaign, b.generation) == ("sig", "camp", 0)
    assert triage.ReproBundle.from_json(b.to_json()) == b
    b.stamp("sig2")
    assert (b.campaign, b.generation) == (None, None)


# ------------------------------------------------------------ measure.py


def test_fresh_seeds_and_median_equal_the_jax_face():
    for rep, n, base in ((0, 4, 0), (3, 16, 0), (2, 7, 1000),
                         (5, 1, 2**31)):
        got, want = measure.fresh_seeds(rep, n, base), jmeasure.fresh_seeds(
            rep, n, base)
        assert got.dtype == want.dtype == np.uint32
        assert np.array_equal(got, want)
    for face in (measure, jmeasure):
        with pytest.raises(ValueError, match="positive"):
            face.fresh_seeds(0, 0)
        with pytest.raises(ValueError, match="empty"):
            face.median([])
    for xs in ([3.0, 1.0, 2.0], [4.0, 1.0, 3.0, 2.0], [5.0]):
        assert measure.median(xs) == jmeasure.median(xs)


def test_timers_warm_the_exact_timed_program_in_the_jax_order():
    """time_scan_ms runs the exact (shape, scan) program before the first
    timed rep, and every rep starts from a fresh seed block; SweepTimer
    warms each compile key once; interleaved_medians interleaves. Each
    call order equals the JAX face's on the same counting stubs."""
    logs = []
    for face in (measure, jmeasure):
        calls = []

        def init(seeds):
            calls.append(("init", int(seeds[0])))
            return "st"

        def run_steps(st, n):
            calls.append(("run", int(n)))
            return st

        face.time_scan_ms(init, run_steps, lanes=4, scan=60, warm_steps=10,
                          rounds=2, block=lambda x: None)
        face.time_sweep(lambda s: calls.append(("sweep", int(s[0]))),
                        lanes=8, rounds=2, block=lambda x: None)
        timer = face.SweepTimer(
            lambda a, rep: calls.append(("trial", a["k"], rep)),
            compile_key=lambda a: a["k"], block=lambda x: None)
        for k, rep in ((1, 1), (1, 2), (2, 3)):
            timer({"k": k}, rep)
        face.interleaved_medians(
            {"a": lambda r: calls.append(("a", r)),
             "b": lambda r: calls.append(("b", r))},
            rounds=2, block=lambda x: None)
        logs.append(calls)
    calls = logs[0]
    assert calls == logs[1]
    assert calls[:4] == [("init", 0), ("run", 10), ("run", 60), ("init", 4)]
    assert [n for kind, n in calls[:9] if kind == "run"] == [10, 60] * 3
    assert [c for c in calls if c[0] == "trial"] == [
        ("trial", 1, 0), ("trial", 1, 1), ("trial", 1, 2), ("trial", 2, 0),
        ("trial", 2, 3)]
    assert calls[-4:] == [("a", 1), ("b", 2), ("a", 3), ("b", 4)]


def test_default_block_synchronizes_nothing_on_the_cpu(monkeypatch):
    import torch

    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda dev=None: synced.append(dev))
    state = te.BatchedSim(_pwl().spec, _pwl().config, device="cpu").init(
        np.arange(2, dtype=np.uint32))
    for x in (None, state, {"a": [torch.zeros(3), (torch.ones(1),)]}, 7):
        measure._default_block(x)
    assert synced == []
    assert measure.time_scan_ms(
        lambda s: torch.as_tensor(s.astype(np.int64)),
        lambda st, n: st + n, lanes=4,
        scan=3, warm_steps=0, rounds=1) >= 0.0


# ------------------------------------------- one generation on each face


def _seeded_campaigns(root):
    """One generation of the pinned search as a campaign with one shrink,
    on each face, checkpointed into `root` (a directory every worker
    shares): {face: (dir, BugRecord dicts, report dict)}."""
    out = {}
    for face, wl, kw in ((campaign, _pwl(), dict(device="cpu")),
                         (jc, _planted_workload(), {})):
        d = os.path.join(root, f"campaign-seeded-{face.__name__}")
        shutil.rmtree(d, ignore_errors=True)
        c = face.Campaign(wl, d, **CAMPAIGN, **SHRINK, **kw)
        rep = c.run(1)
        c.checkpoint()
        out[face.__name__] = (d, [b.to_dict() for b in c.bugs],
                              rep.to_dict())
    return out


@pytest.fixture(scope="session")
def seeded(tmp_path_factory):
    root = str(shared_dir(tmp_path_factory))
    return shared_across_workers(tmp_path_factory, "campaign-seeded",
                                 lambda: _seeded_campaigns(root))


@pytest.fixture(scope="session")
def baseline(tmp_path_factory):
    """The port's uninterrupted host loop over 3 generations (shared with
    tests/test_torch_devloop.py): (report after 2, after 3, corpus,
    dispatches)."""
    return shared_across_workers(tmp_path_factory, "devloop-host-explorer",
                                 _host_baseline)


def test_dedup_records_and_bundles_equal_the_jax_face(seeded):
    """The planted bug's generation-0 violations collapse to one BugRecord
    per coarse group on both faces, with equal signatures, profiles and
    witness seeds; the one shrunk bundle is stamped with the signature,
    the campaign and generation 0, byte-equal to the JAX face's, and
    replays green through the port's `regress` (API and CLI)."""
    (d, bugs, rep), (jd, jbugs, jrep) = (seeded[campaign.__name__],
                                         seeded[jc.__name__])
    assert rep == {**jrep, "wall_s": rep["wall_s"],
                   "device_dispatches": rep["device_dispatches"]}
    strip = [{k: v for k, v in b.items() if k != "bundle_path"}
             for b in bugs]
    assert strip == [{k: v for k, v in b.items() if k != "bundle_path"}
                     for b in jbugs]
    shrunk = [b for b in bugs if b["bundle_path"]]
    assert len(shrunk) == 1 and shrunk[0]["shrink_error"] is None
    assert shrunk[0]["clause_profile"]
    witnesses = sorted(w["seed"] for b in bugs for w in b["witnesses"])
    assert witnesses == sorted(v["seed"] for v in rep["violations"])
    bundle = triage.ReproBundle.load(shrunk[0]["bundle_path"])
    assert (bundle.signature, bundle.campaign, bundle.generation) == (
        shrunk[0]["signature"], shrunk[0]["campaign"], 0)
    jpath = [b["bundle_path"] for b in jbugs if b["bundle_path"]][0]
    assert open(shrunk[0]["bundle_path"]).read() == open(jpath).read()
    out = []
    res = campaign.regress(d, out=out.append, device="cpu")
    assert res["bundles"] == 1 and not res["failures"]
    assert any(shrunk[0]["signature"] in line for line in out)
    assert campaign.main(["regress", "--dir", d, "--device", "cpu"]) == 0
    # the manifests carry the same keys and parameters on both faces
    man, jman = (json.load(open(os.path.join(x, campaign.MANIFEST)))
                 for x in (d, jd))
    assert set(man) == set(jman) and man["params"] == jman["params"]
    assert set(man["state"]) == set(jman["state"])
    assert {k: v for k, v in man.items()
            if k not in ("files", "file_sha256", "state",
                         "campaign_params")} == {
        k: v for k, v in jman.items()
        if k not in ("files", "file_sha256", "state", "campaign_params")}
    assert set(man["campaign_params"]) == set(jman["campaign_params"])


def test_campaign_anatomy_aligns_witnesses_as_the_jax_face(monkeypatch,
                                                           tmp_path):
    """Campaign(anatomy=True) refreshes a record's cross-witness skeleton
    when its second witness arrives: the skeleton, its sha and the rows of
    the JAX face's `bug_anatomy` of a record with the same witnesses (seeds
    3 and 8 under the default ctl, max_witnesses 2); a later refresh over
    the record's label cache replays nothing."""
    from madsim_tpu_torch import causal

    wl, jwl = _fed_workloads()
    c = campaign.Campaign(wl, str(tmp_path), lanes=2, shrink=False,
                          anatomy=True, max_anatomy_witnesses=2,
                          device="cpu")
    c.ex.violations = [
        {"candidate": explore.Candidate(seed=s).key(), "seed": s,
         "dispatch": 0, "origin": "fresh", "cov_digest": None}
        for s in (8, 3)
    ]
    c._absorb_violations()
    [rec] = c.bugs
    assert rec.witness_seeds == [8, 3]
    jrec = jc.BugRecord(
        signature=rec.signature, spec_name=jwl.spec.name,
        violation_kind="invariant", clause_profile=[], witnesses=[
            {"seed": s,
             "candidate": list(jex.canon_genome(jex.Candidate(seed=s).key())),
             "dispatch": 0, "origin": "fresh", "cov_digest": None}
            for s in (8, 3)],
        bundle_path=None, campaign="c-test", first_generation=0,
        coarse_keys=[])
    assert [w["candidate"] for w in rec.witnesses] == [
        w["candidate"] for w in jrec.witnesses]
    janat = jc.bug_anatomy(jwl, jrec, max_witnesses=2)
    assert len(janat["skeleton"]) > 0 and len(janat["witnesses"]) == 2
    assert rec.anatomy == janat
    monkeypatch.setattr(causal, "explain", None)  # a replay would fail
    assert campaign.bug_anatomy(
        wl, rec, max_witnesses=2, device="cpu",
        label_cache=c._anatomy_cache[rec.signature]) == rec.anatomy


# ------------------------------------------------------------ kill/resume


def test_kill_resume_in_process_equals_the_uninterrupted_run(
        seeded, baseline, tmp_path):
    """Checkpoint at generation 1, resume into a fresh Campaign, run 2
    more: fingerprint, curves, corpus digest and violations equal the
    uninterrupted 3-generation run; a second round trip at generation 3
    keeps them; a different config is refused."""
    rep3 = baseline[1]
    wl = _pwl()
    d = _copy(seeded[campaign.__name__][0], tmp_path / "part")
    resumed = campaign.Campaign.resume(d, workload=wl, device="cpu")
    assert resumed.generation == 1 and resumed._shrinks_done == 1
    rep = resumed.run(2)
    _assert_reports_equal(rep, rep3)
    assert rep.seeds_run == 48
    # every violation is a witness of exactly one record
    wits = [w["seed"] for b in resumed.bugs for w in b.witnesses]
    assert sorted(wits) == sorted(v["seed"] for v in rep.violations)
    resumed.checkpoint()
    again = campaign.Campaign.resume(d, workload=wl, device="cpu")
    assert again.report().fingerprint() == rep3.fingerprint()
    assert _records(again.bugs) == _records(resumed.bugs)
    other = dataclasses.replace(wl, config=dataclasses.replace(
        wl.config, horizon_us=wl.config.horizon_us + 1))
    with pytest.raises(ValueError, match="config hash"):
        campaign.Campaign.resume(d, workload=other, device="cpu")


def test_kill_resume_mid_ring_through_the_device_loop(baseline, tmp_path):
    """tests/test_devloop.py:158-193's case: a device-loop campaign
    checkpointed at generation 1 resumes with its device_loop,
    device_window and seen_cap from the manifest and, windows 1 then 2,
    equals the uninterrupted run."""
    wl = _pwl()
    sim = _port_sim(wl)
    kw = dict(**CAMPAIGN, shrink=False, sim=sim, explorer_kwargs=dict(
        device_loop=True, device_window=2, seen_cap=SEEN_CAP))
    part = campaign.Campaign(wl, str(tmp_path / "part"), **kw)
    part.run(1)
    part.checkpoint()
    del part
    resumed = campaign.Campaign.resume(str(tmp_path / "part"), workload=wl,
                                       sim=sim, device="cpu")
    assert resumed.generation == 1
    assert resumed.ex.device_loop and resumed.ex.device_window == 2
    assert resumed.ex.seen_cap == SEEN_CAP
    _assert_reports_equal(resumed.run(2), baseline[1])


def test_campaign_cli_kill_resume_across_processes(tmp_path):
    """`python -m madsim_tpu_torch.campaign run --device cpu`: 1 + 1
    generations in two processes equal 2 in a third."""
    env = dict(os.environ, OMP_NUM_THREADS="1")

    def cli(d, gens):
        return subprocess.Popen(
            [sys.executable, "-m", "madsim_tpu_torch.campaign", "run",
             "--dir", str(d), "--workload", "raft", "--virtual-secs", "0.5",
             "--meta-seed", "3", "--lanes", "8", "--generations", str(gens),
             "--no-shrink", "--json", "--device", "cpu"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=ROOT)

    def result(proc):
        out, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-4000:]
        return json.loads(out.strip().splitlines()[-1])

    straight = cli(tmp_path / "straight", 2)
    a1 = result(cli(tmp_path / "resumed", 1))
    a2 = result(cli(tmp_path / "resumed", 1))
    b = result(straight)
    assert (a1["generation"], a2["generation"], b["generation"]) == (1, 2, 2)
    assert a2["fingerprint"] == b["fingerprint"]
    assert a2["report"]["coverage_curve"] == b["report"]["coverage_curve"]
    with pytest.raises(ValueError, match="lanes"):
        campaign.main(["run", "--dir", str(tmp_path / "resumed"),
                       "--lanes", "16", "--device", "cpu"])


# --------------------------------------------------- checkpoints cross faces


def test_checkpoints_cross_faces_to_the_pinned_fingerprint(seeded, tmp_path):
    """The JAX face's generation-1 campaign resumes in the port, and the
    port's in the JAX face; one more generation each reaches
    PINNED_EXPLORE with equal BugRecords."""
    port = campaign.Campaign.resume(
        _copy(seeded[jc.__name__][0], tmp_path / "from-jax"),
        workload=_pwl(), device="cpu")
    jax = jc.Campaign.resume(
        _copy(seeded[campaign.__name__][0], tmp_path / "from-port"),
        workload=_planted_workload())
    assert port.generation == jax.generation == 1
    assert port.spec_ref == jax.spec_ref == chip_smoke.TRIAGE_SPEC_REF
    assert port.run(1).fingerprint() == PINNED_EXPLORE
    assert jax.run(1).fingerprint() == PINNED_EXPLORE
    assert _records(port.bugs) == _records(jax.bugs)
    assert port._seen_violations == jax._seen_violations


# ------------------------------------------------------- merge + minimize


def test_merge_and_minimize_keeps_the_union_and_the_jax_kept_set(
        seeded, tmp_path):
    """A port campaign (meta-seed 11) and a JAX one (meta-seed 5, fresh
    seeds from 1000) merge; minimize keeps the union exactly (raised on
    inside, checked here too), every replayed bitmap equals its recorded
    one, and the kept set, bits and merged file equal the JAX face's on
    the same dirs. The merged corpus refuses a resume."""
    other = str(tmp_path / "other")
    jcamp = jc.Campaign(_planted_workload(), other, meta_seed=5, lanes=16,
                        chunk=8, shrink=False,
                        explorer_kwargs={"first_seed": 1000})
    jcamp.run(1)
    jcamp.checkpoint()
    dirs = [seeded[campaign.__name__][0], other]
    entries, _ = campaign.merge_corpora(dirs)
    res = campaign.merge_and_minimize(
        dirs, str(tmp_path / "merged"), workload=_pwl(), lane_width=32,
        device="cpu")
    jres = jc.merge_and_minimize(
        dirs, str(tmp_path / "jmerged"), workload=_planted_workload(),
        lane_width=32)
    union = np.zeros_like(entries[0].bitmap)
    for e in entries:
        union |= e.bitmap
    kept_union = np.zeros_like(union)
    for e in res["kept"]:
        kept_union |= e.bitmap
    assert np.array_equal(kept_union, union) and np.array_equal(
        res["union"], union)
    assert res["kept_bits"] == res["merged_bits"] == int(
        explore.popcount_rows(union[None, :])[0]) > 0
    assert 0 < len(res["kept"]) <= len(entries) == res["replayed"]
    assert res["dispatches"] == jres["dispatches"] == 1
    assert [e.to_dict() for e in res["kept"]] == [
        e.to_dict() for e in jres["kept"]]
    for key in ("merged_bits", "kept_bits", "replayed"):
        assert res[key] == jres[key], key
    for f in os.listdir(tmp_path / "merged"):
        assert open(tmp_path / "merged" / f).read() == open(
            tmp_path / "jmerged" / f).read(), f
    with pytest.raises(ValueError, match="resume"):
        campaign.Campaign.resume(str(tmp_path / "merged"), workload=_pwl(),
                                 device="cpu")
    # a replay that disagrees with a recorded bitmap is refused
    bad = dataclasses.replace(entries[0], bitmap=entries[0].bitmap ^ 1)
    with pytest.raises(AssertionError, match="different coverage bitmap"):
        campaign.minimize(_pwl(), [bad], lane_width=2, device="cpu")


# ------------------------------------------------------------ federation


def _fed_workloads():
    """(port, JAX) workloads of the pinned federation: the planted
    workload's plan at FEDERATION_H_US."""
    jcfg = jtn.compile_plan(PLAN, JSimConfig(horizon_us=FEDERATION_H_US,
                                             loss_rate=0.0))
    jwl = dataclasses.replace(_planted_workload(), config=jcfg)
    return chip_smoke.explore_workload(FEDERATION_H_US), jwl


def _jax_federation():
    """The JAX face's pinned federation, snapshotted after 2 generations:
    (snapshot, report after 3)."""
    fed = jex.Federation(_fed_workloads()[1], mesh=None, **FEDERATION_RUN)
    fed.run(FEDERATION_GENERATIONS - 1)
    snap = json.loads(json.dumps(fed.snapshot()))
    rep = fed.run(1)
    return snap, {k: v for k, v in rep.items() if k != "islands"}


@pytest.fixture(scope="session")
def jax_federation(tmp_path_factory):
    return shared_across_workers(tmp_path_factory, "campaign-jax-federation",
                                 _jax_federation)


def _fed(**kw):
    return explore.Federation(_fed_workloads()[0], device="cpu",
                              **{**FEDERATION_RUN, **kw})


def test_federation_reaches_the_pin_and_restores_snapshots(jax_federation):
    """The JAX face's federation sets PINNED_FEDERATION; the port's
    reaches it with the same exchange log, a non-empty merged corpus, and
    across snapshot/restore of its own snapshot (2 + 1 against 3, through
    JSON) and of the JAX face's."""
    jsnap, jrep = jax_federation
    assert jrep["fingerprint"] == PINNED_FEDERATION
    fed = _fed()
    fed.run(FEDERATION_GENERATIONS - 1)
    snap = json.loads(json.dumps(fed.snapshot()))
    assert snap == {**jsnap, "wall_s": snap["wall_s"], "islands": [
        {**i, "wall_s": p["wall_s"]} for i, p in zip(jsnap["islands"],
                                                     snap["islands"])]}
    rep = fed.run(1)
    assert rep["fingerprint"] == PINNED_FEDERATION
    assert {k: v for k, v in rep.items() if k not in ("islands", "wall_s")} \
        == {k: v for k, v in jrep.items() if k != "wall_s"}
    assert rep["exchanges"] and rep["exchanges"][0]["merged"] > 0
    for s in (snap, jsnap):
        again = _fed()
        again.restore(s)
        assert again.run(1)["fingerprint"] == PINNED_FEDERATION
    with pytest.raises(ValueError, match="n_islands"):
        _fed(n_islands=3).restore(snap)
    # island i draws fresh seeds i, i + n, ...
    assert [c.seed for c in _fed().islands[1]._population(0)] == list(
        range(1, 16, 2))


def test_federation_device_loop_equals_the_host_loop(jax_federation):
    """tests/test_devloop.py:196-226's case: device-resident islands with
    windows clipped to the exchange (device_window 3 > exchange_every 2):
    the fingerprint, exchange log, coverage bits and violations of the
    host loop."""
    _, jrep = jax_federation
    wl = _fed_workloads()[0]
    plan = te.make_devloop_plan(wl.config, pop=FEDERATION_RUN["lanes"],
                                top_k=16, seen_cap=SEEN_CAP,
                                fresh_stride=FEDERATION_RUN["n_islands"])
    sim = te.BatchedSim(wl.spec, wl.config, triage=True, coverage=True,
                        devloop=plan, device="cpu")
    dev = explore.Federation(wl, device_loop=True, device_window=3, sim=sim,
                             seen_cap=SEEN_CAP, **FEDERATION_RUN).run(
        FEDERATION_GENERATIONS)
    for key in ("fingerprint", "exchanges", "coverage_bits", "violations"):
        assert dev[key] == jrep[key], key
    with pytest.raises(ValueError, match="fresh_stride"):
        explore.Federation(wl, device_loop=True, sim=sim, seen_cap=SEEN_CAP,
                           **{**FEDERATION_RUN, "n_islands": 3})


# ------------------------------------------------------------------- CLIs


def test_explore_out_writes_a_resumable_campaign(monkeypatch, capsys,
                                                 tmp_path):
    """tests/test_campaign.py:501-537's case: `explore --out DIR` writes
    the campaign format; the one-shot run resumes as a campaign and
    continues to the pinned fingerprint."""
    wl = _pwl()
    monkeypatch.setattr(explore, "_named_workload", lambda *a: wl)
    out_dir = str(tmp_path / "oneshot")
    explore.main([
        "--workload", "raft", "--meta-seed", "11", "--lanes", "16",
        "--chunk", "8", "--dispatches", "1", "--no-shrink", "--out",
        out_dir, "--json", "--device", "cpu",
    ])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    cli_report = explore.ExploreReport.from_json(line)
    saved = campaign.load_report(out_dir)
    assert saved.fingerprint() == cli_report.fingerprint()
    man = json.load(open(os.path.join(out_dir, campaign.MANIFEST)))
    assert man["workload"] == campaign.named_workload_ref("raft", 2.0, False)
    assert man["seen_violations"] == 0
    c = campaign.Campaign.resume(out_dir, workload=wl, device="cpu")
    assert c.spec_ref == campaign.SPEC_FOR_REF and not c.bugs
    c.shrink = False
    assert c.run(1).fingerprint() == PINNED_EXPLORE
    # the export's recorded violations dedup on the first slice
    assert sorted(w["seed"] for b in c.bugs for w in b.witnesses) == sorted(
        v["seed"] for v in c.report().violations)


def test_explore_islands_prints_the_pinned_federation(monkeypatch, capsys):
    monkeypatch.setattr(explore, "_named_workload",
                        lambda *a: _fed_workloads()[0])
    explore.main([
        "--islands", "2", "--meta-seed", "7", "--lanes", "8",
        "--exchange-every", "2", "--dispatches", "3", "--no-shrink",
        "--json", "--device", "cpu",
    ])
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["fingerprint"] == PINNED_FEDERATION
    assert rep["n_islands"] == 2 and not rep["sharded"]
