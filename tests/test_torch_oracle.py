"""The port's differential oracle (`madsim_tpu_torch/oracle.py`), its
divergence replay (`repro --backend host|both`), serve's oracle tenant and
`run_batch`'s host repros against the JAX package's.

  * `check_seed` on raft5 matches, with the JAX face's `OracleReport.digest`
    (the pinned bench-horizon lane is `digest.PINNED_ORACLE`);
  * under the divergence plant both faces diverge at the same first event
    (a `reorder_extra` draw), `shrink_divergence` keeps exactly
    `[("reorder", None)]` and writes the JAX face's bundle;
  * a divergence bundle either face writes replays through the other face's
    `repro.main([path, "--backend", "both"])` with rc 1 and the same first
    event; without the plant both say "did NOT diverge" and exit 1;
  * the tenant: kill/restart, a torn `oracle.json`, deterministic sampling
    equal across faces, two planted witnesses deduped into one BugRecord;
  * `serve(oracle=True)` writes the JAX face's `oracle.json` and status
    block; `run_batch`'s `host_repros` on a violating chain config are the
    JAX face's `host_repro` results.

Tolerances: exact (digests, bundles, JSON).
"""

import dataclasses
import json
import os
import types

import pytest
import torch

from madsim_tpu import campaign as jc
from madsim_tpu import nemesis as jn
from madsim_tpu import oracle as jo
from madsim_tpu import repro as jrepro
from madsim_tpu import triage as jtri
from madsim_tpu.tpu import chain_workload as jax_chain_workload
from madsim_tpu_torch import campaign
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch import oracle, repro, triage
from madsim_tpu_torch.tpu import digest

torch.set_num_threads(1)

FACES = {"port": (oracle, tn, repro, triage), "jax": (jo, jn, jrepro, jtri)}


def mirror(plan, nem):
    """`plan` built from the `nem` module's clause classes."""
    return nem.FaultPlan(name=plan.name, clauses=tuple(
        getattr(nem, type(c).__name__)(**dataclasses.asdict(c))
        for c in plan.clauses))


def plan8(nem):
    """tests/test_oracle.py's PLAN8 (digest.ORACLE_PLAN's clauses)."""
    return mirror(digest.ORACLE_PLAN, nem)


def plan_plant(nem):
    """tests/test_oracle.py's plant plan: a small atom universe."""
    return nem.FaultPlan(name="oracle-plant", clauses=(
        nem.Crash(interval_lo_us=400_000, interval_hi_us=1_500_000,
                  down_lo_us=200_000, down_hi_us=800_000),
        nem.MsgLoss(rate=0.05),
        nem.Reorder(rate=0.2, window_us=40_000),
    ))


HOR_PLANT, N = 2_000_000, 5


@pytest.fixture
def plant(monkeypatch):
    monkeypatch.setenv(tn.PLANT_ENV, tn.PLANT_REORDER_OFF_BY_ONE)
    assert tn.PLANT_ENV == jn.PLANT_ENV
    return monkeypatch


# ------------------------------------------------------- check_seed


@pytest.mark.parametrize("horizon_us,seed", [(3_000_000, 7),
                                             (digest.ORACLE_H_US, 7)])
def test_check_seed_matches_with_the_jax_digest(horizon_us, seed):
    reps = {}
    plan = digest.ORACLE_PLAN
    if horizon_us == digest.ORACLE_H_US:
        # the bench config's recovered plan, as the serve tenant derives it
        plan = triage.plan_from_config(digest.oracle_config())
        assert plan.schedule(seed, horizon_us, N) == \
            digest.ORACLE_PLAN.schedule(seed, horizon_us, N)
    for face, (o, nem, _r, _t) in FACES.items():
        reps[face] = o.check_seed("raft5", mirror(plan, nem), seed, horizon_us,
                                  n_nodes=N, loss_rate=0.1, repeats=2)
    rep, jrep = reps["port"], reps["jax"]
    assert not rep.diverged, rep.render()
    assert rep.render() == jrep.render() and rep.render().endswith("MATCH")
    assert rep.to_dict() == jrep.to_dict()
    assert rep.draws > 100 and rep.skew_nodes > 0 and rep.lineage_edges > 0
    if horizon_us == digest.ORACLE_H_US:
        assert (seed, rep.digest) == (digest.ORACLE_SEED,
                                      digest.PINNED_ORACLE)


def test_check_seed_unknown_spec_raises_on_both_faces():
    msgs = []
    for o, nem, _r, _t in FACES.values():
        with pytest.raises(ValueError, match="no host twin") as e:
            o.check_seed("twopc5", plan_plant(nem), 0, HOR_PLANT)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert sorted(oracle.HOST_TWINS) == sorted(jo.HOST_TWINS) == \
        ["chain", "raft"]


# ------------------------------------------------------- the plant


def test_planted_divergence_first_event_equal_on_both_faces(plant):
    reps = {face: o.check_seed("raft5", plan_plant(nem), 3, HOR_PLANT,
                               n_nodes=N, repeats=1)
            for face, (o, nem, _r, _t) in FACES.items()}
    rep = reps["port"]
    assert rep.diverged and rep.first.kind == "coin"
    assert rep.first.site == "reorder_extra"
    assert rep.first.eid >= 0 and rep.first.slice_text
    assert rep.first.to_dict() == reps["jax"].first.to_dict()
    assert rep.render() == reps["jax"].render()
    # the same lane is green without the plant
    plant.delenv(tn.PLANT_ENV)
    clean = oracle.check_seed("raft5", plan_plant(tn), 3, HOR_PLANT,
                              n_nodes=N, repeats=1)
    assert not clean.diverged and clean.draws > 0


def _shrink(face, out_dir):
    o, nem, _r, _t = FACES[face]
    return o.shrink_divergence("raft5", plan_plant(nem), 3, HOR_PLANT,
                               n_nodes=N, out_dir=str(out_dir))


def test_planted_shrink_keeps_reorder_and_writes_the_jax_bundle(plant,
                                                                tmp_path):
    sr = _shrink("port", tmp_path / "port")
    jsr = _shrink("jax", tmp_path / "jax")
    assert sr.kept_atoms == jsr.kept_atoms == [("reorder", None)]
    assert sr.dispatches == jsr.dispatches
    assert sr.bundle.to_json() == jsr.bundle.to_json()
    assert open(sr.bundle_path).read() == open(jsr.bundle_path).read()
    assert sr.bundle.violation_kind == "divergence"
    assert sr.bundle.causal and sr.bundle.causal.get("sha")
    plant.delenv(tn.PLANT_ENV)
    with pytest.raises(triage.NotReproducible):
        _shrink("port", tmp_path / "none")


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_divergence_bundle_replays_across_faces(writer, reader, plant,
                                                tmp_path, capsys):
    path = _shrink(writer, tmp_path).bundle_path
    capsys.readouterr()
    rc = FACES[reader][2].main([path, "--backend", "both"])
    out = capsys.readouterr().out
    assert rc == 1
    assert "first divergent event" in out and "reorder_extra" in out
    assert "bit-identically across 2 schedule-matched host replays" in out
    # the reader's own face gives the same first event
    first = [ln for ln in out.splitlines()
             if ln.startswith("first divergent event")]
    rc = FACES[writer][2].main([path, "--backend", "both"])
    assert rc == 1
    assert first == [ln for ln in capsys.readouterr().out.splitlines()
                     if ln.startswith("first divergent event")]
    # every backend routes a divergence bundle to the oracle replay
    bundle = triage.ReproBundle.load(path)
    for backend in ("device", "tpu", "host", "both"):
        rep = repro.replay(bundle, backend=backend, out=lambda s: None)
        assert rep["diverged"] and rep["first"]["site"] == "reorder_extra"
    # the skew is "fixed": both faces fail loudly, never pass vacuously
    plant.delenv(tn.PLANT_ENV)
    for face in (reader, writer):
        assert FACES[face][2].main([path, "--backend", "both"]) == 1
        assert "did NOT diverge" in capsys.readouterr().err


def test_divergence_bugs_dedup_to_one_record(plant, tmp_path):
    records = {}
    for face, (o, nem, _r, tri) in FACES.items():
        camp = types.SimpleNamespace(
            bugs=[], _by_sig={}, bundles_dir=str(tmp_path / face),
            campaign_id="oracle-test", generation=2,
            spec_ref=None, spec_kwargs={},
        )
        reps = [o.check_seed("raft5", plan_plant(nem), s, HOR_PLANT,
                             n_nodes=N, repeats=1) for s in range(3, 10)]
        reps = [r for r in reps if r.diverged][:2]
        assert len(reps) == 2, "plant did not fire on two lanes"
        rec1 = o.divergence_bug(camp, reps[0], plan_plant(nem), HOR_PLANT, N)
        rec2 = o.divergence_bug(camp, reps[1], plan_plant(nem), HOR_PLANT, N)
        assert rec1 is rec2 and len(camp.bugs) == 1
        assert rec1.violation_kind == "divergence"
        assert rec1.shrink_error is None and len(rec1.witnesses) == 2
        b = tri.ReproBundle.load(rec1.bundle_path)
        assert b.signature == rec1.signature
        records[face] = (rec1.signature, rec1.witnesses,
                         rec1.clause_profile, open(rec1.bundle_path).read())
    assert records["port"] == records["jax"]


# ------------------------------------------------------- the tenant


def test_tenant_state_survives_kill_restart_and_torn_files(tmp_path):
    docs = {}
    for face, (o, *_rest) in FACES.items():
        path = str(tmp_path / f"{face}.json")
        t1 = o.OracleTenant(state_path=path)
        t1.cursor = {"c1": 5, "c2": 2}
        t1.seeds_checked, t1.divergences, t1.skipped_saturated = 7, 1, 3
        t1.save()
        t2 = o.OracleTenant(state_path=path)
        assert (t2.cursor, t2.seeds_checked, t2.divergences,
                t2.skipped_saturated) == ({"c1": 5, "c2": 2}, 7, 1, 3)
        docs[face] = open(path).read()
        with open(path, "w") as f:
            f.write('{"format": "madsim-tpu-ora')  # killed mid-write
        t3 = o.OracleTenant(state_path=path)
        assert t3.cursor == {} and t3.seeds_checked == 0
        out = t3.observe("c1", types.SimpleNamespace(spec_name="twopc5"))
        assert out == {"campaign": "c1", "checked": 0, "diverged": 0,
                       "skipped": 1}
        assert t3.status() == o.OracleTenant().status() | {
            "skipped_no_twin": 1}
    assert docs["port"] == docs["jax"]
    assert json.loads(docs["port"])["format"] == "madsim-tpu-oracle/1"


def _stub_corpus_campaign(gen, entries):
    ex = types.SimpleNamespace(corpus=[
        types.SimpleNamespace(cand=types.SimpleNamespace(seed=s), dispatch=d)
        for s, d in entries])
    return types.SimpleNamespace(generation=gen, ex=ex)


def test_tenant_sampling_is_deterministic_and_equal_across_faces():
    entries = [(s, g) for g in range(3) for s in range(g * 10, g * 10 + 6)]
    a, b = oracle.OracleTenant(sample_rate=0.5), jo.OracleTenant(
        sample_rate=0.5)
    camp = _stub_corpus_campaign(3, entries)
    sa, sb = a._sampled("c", camp), b._sampled("c", camp)
    assert sa == sb and 0 < len(sa) < len(entries)
    assert a._sampled("c", camp) == []
    camp2 = _stub_corpus_campaign(4, entries + [(99, 3), (98, 3)])
    assert a._sampled("c", camp2) == b._sampled("c", camp2)
    assert a.state() == b.state()


# ------------------------------------------------------- serve + run_batch


REQUESTS = {
    "a": {"workload": "raft", "virtual_secs": 0.5, "lanes": 16, "chunk": 8,
          "meta_seed": 11, "generations": 2, "shrink": False},
    "b": {"workload": "raft", "virtual_secs": 0.5, "lanes": 16, "chunk": 8,
          "meta_seed": 3, "generations": 1, "shrink": False, "storm": True},
}


def test_serve_oracle_tenant_equals_the_jax_face(tmp_path):
    got = {}
    for face, mod, kw in (("port", campaign, {"device": "cpu"}),
                          ("jax", jc, {})):
        d = str(tmp_path / face)
        for name, req in REQUESTS.items():
            os.makedirs(os.path.join(d, "queue"), exist_ok=True)
            with open(os.path.join(d, "queue", f"{name}.json"), "w") as f:
                json.dump(req, f)
        lines = []
        res = mod.serve(d, out=lambda s: lines.append(json.loads(s)),
                        sleep=lambda s: None, idle_rounds=1,
                        oracle_sample_rate=0.5, **kw)
        assert sorted(res["completed"]) == ["a", "b"], face
        with open(os.path.join(d, "status.json")) as f:
            status = json.load(f)
        got[face] = (open(os.path.join(d, "oracle.json")).read(),
                     status["oracle"],
                     [(x["campaign"], x["generation"], x["fingerprint"])
                      for x in lines if "fingerprint" in x])
    assert got["port"] == got["jax"]
    status = got["port"][1]
    assert status["seeds_checked"] > 0 and status["errors"] == 0
    assert status["divergences"] == 0
    assert json.loads(got["port"][0])["cursor"] == {"a": 2, "b": 1}


def test_run_batch_host_repros_are_the_jax_host_repro(tmp_path):
    """A violating chain config (blind apply under duplication and wide
    reordering): run_batch re-runs the violating seeds on the host twin;
    each result is what the JAX face's `host_repro` returns for it."""
    from madsim_tpu_torch.tpu import chain_workload, make_chain_spec, run_batch

    from test_torch_workloads import _dup_reorder

    wl = chain_workload(virtual_secs=2.0)
    wl = dataclasses.replace(
        wl, spec=make_chain_spec(5, buggy_blind_apply=True),
        config=_dup_reorder(tn, wl.config), max_steps=350)
    r = run_batch(range(16), wl, device="cpu", max_host_repros=2)
    assert r.violations >= 2
    assert sorted(r.host_repros) == r.violating_seeds[:2]
    jwl = jax_chain_workload(virtual_secs=2.0)
    for seed, out in r.host_repros.items():
        assert out == jwl.host_repro(seed)
        assert out["violations"] == 0 and out["acked_ops"] > 0
    none = run_batch(range(16), wl, device="cpu", repro_on_host=False)
    assert none.host_repros == {} and none.violating_seeds == \
        r.violating_seeds
